"""Image-plane helpers (counterpart of `oxylus_tpu/utils/imgops.py`, the subset
the 3D frame uses).

`max_downsample` is the JAX module's max-pooled downsample. `resize_linear`
is `jax.image.resize(img, shape, method="linear")` for the
upsamplings the frame does (the reduced-resolution shadow, contact-shadow,
AO, SSR and aerial terms back to full size). For an upsampling the JAX
resize's triangle kernel has radius one input texel, the output centre
(i + 0.5)·in/out − 0.5 is the sample point, and the weights of taps that fall
outside the image are dropped and the rest renormalised. Past the first and
last texel centre that leaves a single tap of weight one: the edge texel,
which is what `F.interpolate(mode="bilinear", align_corners=False)` gives by
clamping the sample point. Inside they are the same two-tap lerp, so the two
agree to float32 rounding (`tests/test_torch_gtao_ssr.py` holds them).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def point_downsample(img: Tensor, k: int) -> Tensor:
    """Point-sampled k× downsample of (H, W, ...): `img[::k, ::k]`."""
    if k == 1:
        return img
    return img[::k, ::k]


def max_downsample(img: Tensor, k: int) -> Tensor:
    """Max-pooled k× downsample of (H, W, ...) over whole k×k windows (the
    trailing rows and columns that fill no window dropped): for reverse-Z depth
    (the nearest surface wins) and boolean coverage masks."""
    if k == 1:
        return img
    h, w = img.shape[0] // k, img.shape[1] // k
    x = img[: h * k, : w * k]
    was_bool = x.dtype == torch.bool
    if was_bool:
        x = x.to(torch.float32)
    out = x.reshape((h, k, w, k) + tuple(x.shape[2:])).amax(dim=(1, 3))
    return out > 0.5 if was_bool else out


def resize_linear(img: Tensor, shape: tuple[int, ...]) -> Tensor:
    """Bilinear resize of (h, w) or (h, w, C) to `shape` ((H, W) or (H, W, C),
    the channel count unchanged)."""
    h_out, w_out = shape[0], shape[1]
    if img.dim() == 2:
        x = img[None, None]
    else:
        x = img.permute(2, 0, 1)[None]
    y = F.interpolate(x.to(torch.float32), size=(h_out, w_out), mode="bilinear", align_corners=False)
    return y[0, 0] if img.dim() == 2 else y[0].permute(1, 2, 0)
