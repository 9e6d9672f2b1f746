"""Post-processing as fullscreen tensor ops (counterpart of `oxylus_tpu/render/postfx.py`).

Auto-exposure (256-bin log-luminance histogram with exponential adaptation),
bloom (soft-knee prefilter → half-res box down chain → bilinear up chain),
tonemapping (none / ACES fitted / AgX / GT7, then gamma) with chromatic
aberration, vignette and film grain (all off by default, and off in the
renderer, as in the JAX package), and FXAA (luma-gradient directional blend from
one-pixel shifts).

The grain differs by design: the JAX package draws `jax.random.uniform` under
`fold_in(PRNGKey(0x617), frame % 16)`; this module draws from a CPU
`torch.Generator` seeded from (0x617, frame % 16), so the card's grain equals the
CPU's, and keeps the 16 fields per (shape, device) so no draw or copy runs in a
frame after the first 16.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

Tensor = torch.Tensor

HISTOGRAM_BINS = 256


def luminance(rgb: Tensor) -> Tensor:
    return rgb[..., 0] * 0.2127 + rgb[..., 1] * 0.7152 + rgb[..., 2] * 0.0722


def luminance_histogram(hdr: Tensor, min_log2: float, inv_log2_range: float) -> Tensor:
    """256-bin log-luminance histogram; bin 0 collects below-threshold pixels."""
    lum = luminance(hdr)
    log_lum = torch.log2(torch.clamp(lum, min=1e-9))
    t = torch.clamp((log_lum - min_log2) * inv_log2_range, 0.0, 1.0)
    bins = torch.where(lum < 1e-4, 0, (t * 254.0 + 1.0).to(torch.int32))
    return torch.bincount(bins.reshape(-1), minlength=HISTOGRAM_BINS).to(torch.int32)


def adapt_exposure(histogram: Tensor, prev_luminance: Tensor, dt, min_exposure: float = -11.5,
                   max_exposure: float = 18.0, adaptation_speed: float = 1.1, ev100_bias: float = 1.0):
    """Weighted-average bin → desired luminance → exponential adaptation →
    exposure multiplier. Returns (exposure, new_luminance)."""
    counts = histogram.to(torch.float32)
    total = torch.clamp(counts[1:].sum(), min=1.0)
    weighted = torch.sum(counts * torch.arange(HISTOGRAM_BINS, dtype=torch.float32, device=counts.device))
    avg_bin = weighted / total - 1.0
    desired = torch.exp2(avg_bin / 254.0 * (max_exposure - min_exposure) + min_exposure)
    dt = torch.as_tensor(dt, dtype=torch.float32, device=counts.device)
    time_coeff = 1.0 - torch.exp(-dt * adaptation_speed)
    new_lum = prev_luminance + (desired - prev_luminance) * time_coeff
    ev100 = torch.log2(torch.clamp(new_lum, min=1e-9) * 100.0 * ev100_bias / 12.5)
    return 1.0 / (torch.exp2(ev100) * 1.2), new_lum


# ---------------------------------------------------------------------------
# Bloom
# ---------------------------------------------------------------------------

def _downsample2x(img: Tensor) -> Tensor:
    h, w = img.shape[0] // 2 * 2, img.shape[1] // 2 * 2
    x = img[:h, :w].reshape(h // 2, 2, w // 2, 2, img.shape[2])
    return x.sum(dim=(1, 3)) * 0.25


def _upsample_linear(img: Tensor, target_hw: tuple[int, int]) -> Tensor:
    """Half-pixel-centre bilinear resize of an (H, W, C) image, edges clamped:
    `jax.image.resize(..., "linear")` when upsampling."""
    x = img.permute(2, 0, 1)[None]
    return F.interpolate(x, size=target_hw, mode="bilinear", align_corners=False)[0].permute(1, 2, 0)


def apply_bloom(hdr: Tensor, threshold: float = 1.0, soft_threshold: float = 0.125, intensity: float = 0.1,
                clamp_value: float = 4.0, mips: int = 5) -> Tensor:
    """Prefilter → half-res down chain → up chain blend."""
    lum = luminance(hdr)[..., None]
    knee = threshold * soft_threshold
    soft = torch.clamp(lum - threshold + knee, 0.0, 2.0 * knee)
    soft = soft * soft / max(4.0 * knee, 1e-5)
    contribution = torch.maximum(soft, lum - threshold) / torch.clamp(lum, min=1e-5)
    pre = torch.clamp(hdr * contribution, max=clamp_value)

    chain = [_downsample2x(pre)]
    for _ in range(mips - 1):
        if min(chain[-1].shape[:2]) < 4:
            break
        chain.append(_downsample2x(chain[-1]))
    acc = chain[-1]
    for i in range(len(chain) - 2, -1, -1):
        acc = chain[i] + _upsample_linear(acc, chain[i].shape[:2])
    acc = _upsample_linear(acc, hdr.shape[:2])
    return hdr + acc * (intensity / max(len(chain) + 1, 1))


# ---------------------------------------------------------------------------
# Tonemapping
# ---------------------------------------------------------------------------

_ACES_IN = ((0.59719, 0.35458, 0.04823), (0.07600, 0.90834, 0.01566), (0.02840, 0.13383, 0.83777))
_ACES_OUT = ((1.60475, -0.53108, -0.07367), (-0.10208, 1.10813, -0.00605), (-0.00327, -0.07276, 1.07602))
_AGX_IN = ((0.842479, 0.0784336, 0.0792237), (0.0423282, 0.878469, 0.0791661), (0.0423756, 0.0784336, 0.879142))
_AGX_OUT = ((1.19688, -0.0980209, -0.0990297), (-0.0528969, 1.15190, -0.0989612), (-0.0529716, -0.0980435, 1.15107))


def _mat3(m, c: Tensor) -> Tensor:
    """Per-pixel 3×3 colour transform (matrix entries rounded to float32, as
    the JAX constants are)."""
    m = torch.tensor(m, dtype=torch.float32, device=c.device)
    return torch.stack([c[..., 0] * m[i, 0] + c[..., 1] * m[i, 1] + c[..., 2] * m[i, 2] for i in range(3)], dim=-1)


def tonemap_aces(c: Tensor) -> Tensor:
    v = _mat3(_ACES_IN, c)
    a = v * (v + 0.0245786) - 0.000090537
    b = v * (0.983729 * v + 0.4329510) + 0.238081
    v = a / torch.clamp(b, min=1e-9)
    return torch.clamp(_mat3(_ACES_OUT, v), 0.0, 1.0)


def _agx_sigmoid(x: Tensor) -> Tensor:
    x2 = x * x
    x4 = x2 * x2
    return 15.5 * x4 * x2 - 40.14 * x4 * x + 31.96 * x4 - 6.868 * x2 * x + 0.4298 * x2 + 0.1191 * x - 0.00232


def tonemap_agx(c: Tensor, look_saturation: float = 1.3) -> Tensor:
    """AgX with punchy-look saturation (EV range [-12.47, 4.03])."""
    v = _mat3(_AGX_IN, c)
    min_ev, max_ev = -12.47393, 4.026069
    v = torch.clamp(torch.log2(torch.clamp(v, min=1e-10)), min_ev, max_ev)
    v = (v - min_ev) / (max_ev - min_ev)
    v = _agx_sigmoid(v)
    lum = luminance(v)[..., None]
    v = lum + look_saturation * (v - lum)
    return torch.clamp(_mat3(_AGX_OUT, v), 0.0, 1.0)


def tonemap_gt7(c: Tensor) -> Tensor:
    """Gran Turismo-style filmic curve (GT7 preset)."""
    p, a, m, l, cc = 1.0, 1.0, 0.22, 0.4, 1.33
    l0 = (p - m) * l / a
    s0 = m + l0
    s1 = m + a * l0
    c2 = a * p / (p - s1)
    toe = m * torch.clamp(c / max(m, 1e-5), min=1e-5) ** cc
    shoulder = p - (p - s1) * torch.exp(-c2 * (c - s0) / p)
    linear = m + a * (c - m)
    out = torch.where(c < m, toe, torch.where(c < s0, linear, shoulder))
    return torch.clamp(out, 0.0, 1.0)


_TONEMAPPERS = (lambda x: torch.clamp(x, 0.0, 1.0), tonemap_aces, tonemap_agx, tonemap_gt7)


GRAIN_SEED = 0x617
_GRAIN_CACHE: dict = {}


def _grain_field(gh: int, gw: int, k: int) -> Tensor:
    """The (gh, gw, 1) grain draw of `frame % 16 == k`, uniform in [-0.5, 0.5),
    from a CPU generator (the same stream for every device)."""
    gen = torch.Generator(device="cpu")
    gen.manual_seed((GRAIN_SEED << 32) | k)
    return torch.rand((gh, gw, 1), generator=gen, dtype=torch.float32) - 0.5


def resize_cyclic(x: Tensor, shape) -> Tensor:
    """`jnp.resize`: the flattened `x` repeated cyclically into `shape` (not a 2-D tile)."""
    n = 1
    for d in shape:
        n *= d
    flat = x.reshape(-1)
    reps = -(-n // flat.numel())
    return flat.repeat(reps)[:n].reshape(shape)


def grain_noise(h: int, w: int, frame, film_grain_scale: float = 0.7, device=None) -> Tensor:
    """The (h, w, 1) grain field of `frame`: a (h·scale, w·scale, 1) draw resized
    cyclically, cached per (shape, frame % 16, device)."""
    gh = max(int(h * film_grain_scale), 1)
    gw = max(int(w * film_grain_scale), 1)
    k = int(frame) % 16
    key = (h, w, gh, gw, k, torch.device(device) if device is not None else torch.device("cpu"))
    field = _GRAIN_CACHE.get(key)
    if field is None:
        field = resize_cyclic(_grain_field(gh, gw, k), (h, w, 1)).to(key[-1])
        _GRAIN_CACHE[key] = field
    return field


def _centred_coords(h: int, w: int, device) -> tuple[Tensor, Tensor]:
    """(h, 1) and (1, w) pixel coordinates / size − 0.5, float32. The sizes divide as
    scalars on `device`: CUDA divides by a CPU scalar as a product with its
    reciprocal, an ulp off the CPU's (and XLA's) division, which would move the
    aberration's integer shift."""
    size = lambda n: torch.full((), float(n), device=device)
    yy = (torch.arange(h, dtype=torch.float32, device=device) / size(h) - 0.5)[:, None]
    xx = (torch.arange(w, dtype=torch.float32, device=device) / size(w) - 0.5)[None, :]
    return yy, xx


def apply_tonemap(hdr: Tensor, tonemapper: int = 0, exposure=1.0, gamma: float = 2.2,
                  chromatic_aberration: float = 0.0, film_grain: float = 0.0, film_grain_scale: float = 0.7,
                  vignette: float = 0.0, frame=0) -> Tensor:
    """Final colour pass: exposure → CA → tonemap → vignette → grain → gamma.
    tonemapper: 0 None(+gamma) 1 ACES 2 AgX 3 GT7."""
    h, w = hdr.shape[:2]
    dev = hdr.device
    c = hdr * exposure

    if chromatic_aberration:
        # radial RGB shift (tonemap.slang CA)
        yy, xx = _centred_coords(h, w, dev)
        sx = (chromatic_aberration * 8.0 * torch.broadcast_to(xx, (h, w))).to(torch.int32)
        sy = (chromatic_aberration * 8.0 * torch.broadcast_to(yy, (h, w))).to(torch.int32)
        cols = torch.arange(w, device=dev)[None, :]
        rows = torch.arange(h, device=dev)[:, None]
        r = c[torch.clamp(rows + sy, 0, h - 1), torch.clamp(cols + sx, 0, w - 1), 0]
        b = c[torch.clamp(rows - sy, 0, h - 1), torch.clamp(cols - sx, 0, w - 1), 2]
        c = torch.stack([r, c[..., 1], b], dim=-1)

    mapped = _TONEMAPPERS[min(max(int(tonemapper), 0), 3)](c)

    if vignette:
        yy, xx = _centred_coords(h, w, dev)
        d = torch.sqrt(xx * xx + yy * yy) * 2.0
        vig = torch.clamp(1.0 - vignette * d * d, 0.0, 1.0)
        mapped = mapped * vig[..., None]

    if film_grain:
        noise = grain_noise(h, w, frame, film_grain_scale, dev)
        mapped = torch.clamp(mapped + noise * film_grain * 0.15, 0.0, 1.0)

    return torch.clamp(mapped, 0.0, 1.0) ** (1.0 / gamma)


# ---------------------------------------------------------------------------
# FXAA
# ---------------------------------------------------------------------------

def _pad_edge(x: Tensor) -> Tensor:
    """Pad the first two axes by one, repeating the edge."""
    x = torch.cat([x[:1], x, x[-1:]], dim=0)
    return torch.cat([x[:, :1], x, x[:, -1:]], dim=1)


def apply_fxaa(ldr: Tensor, span_max: float = 2.0) -> Tensor:
    """Luma-gradient directional blur on edges, from the 9 one-pixel shifts of
    the image (exact bilinear for offsets within ±1 px; span ≤ 2 px)."""
    lum = luminance(ldr)
    pad = _pad_edge(lum)
    nw = pad[:-2, :-2]
    ne = pad[:-2, 2:]
    sw = pad[2:, :-2]
    se = pad[2:, 2:]
    m = lum
    lmin = torch.minimum(m, torch.minimum(torch.minimum(nw, ne), torch.minimum(sw, se)))
    lmax = torch.maximum(m, torch.maximum(torch.maximum(nw, ne), torch.maximum(sw, se)))

    dir_x = -((nw + ne) - (sw + se))
    dir_y = (nw + sw) - (ne + se)
    dir_reduce = torch.clamp((nw + ne + sw + se) * 0.25 * 0.125, min=1.0 / 128.0)
    rcp = 1.0 / (torch.minimum(torch.abs(dir_x), torch.abs(dir_y)) + dir_reduce)
    dx = torch.clamp(dir_x * rcp, -span_max, span_max)
    dy = torch.clamp(dir_y * rcp, -span_max, span_max)

    h, w = lum.shape
    padc = _pad_edge(ldr)
    sh = lambda sy, sx: padc[1 + sy : 1 + sy + h, 1 + sx : 1 + sx + w]
    pair_y = sh(1, 0) + sh(-1, 0)
    pair_x = sh(0, 1) + sh(0, -1)
    same_sign = (dx * dy >= 0)[..., None]
    pair_d = torch.where(same_sign, sh(1, 1) + sh(-1, -1), sh(1, -1) + sh(-1, 1))

    def sym_sample(scale: float) -> Tensor:
        ay = torch.clamp(torch.abs(dy) * scale, 0.0, 1.0)[..., None]
        ax = torch.clamp(torch.abs(dx) * scale, 0.0, 1.0)[..., None]
        return (
            ldr * ((1 - ay) * (1 - ax))
            + pair_y * (0.5 * ay * (1 - ax))
            + pair_x * (0.5 * (1 - ay) * ax)
            + pair_d * (0.5 * ay * ax)
        )

    a = sym_sample(0.1666)
    b = a * 0.5 + sym_sample(0.5) * 0.5
    blum = luminance(b)
    use_a = (blum < lmin) | (blum > lmax)
    out = torch.where(use_a[..., None], a, b)
    edge = (lmax - lmin) > torch.clamp(lmax * 0.125, min=0.0312)
    return torch.where(edge[..., None], out, ldr)

