"""Hierarchical-Z pyramid + occlusion testing, reverse-Z (counterpart of
`oxylus_tpu/ops/hiz.py`).

The pyramid reduces with min (the farthest visible surface). On every device
the port builds the shapes of the JAX package's device path
(`build_hiz_pallas`): the depth padded with 0 (far) to multiples of 128×512,
two levels halving it exactly, then tail levels of ((h+1)//2, (w+1)//2) until
the smaller side is 1 or there are 13 levels. Each output is the min of its
2×2 block, and a partner missing at an odd size reads 0, as the TPU kernel's
selection matmul gives it: the last row or column of an odd level is 0 (far).
The JAX package's CPU branch builds a power-of-two pyramid instead, with other
level shapes and so other edge clamps in `occlusion_test`.

`build_hiz` is the wrapper: CPU tensors take the plain version `hiz_reference`,
CUDA tensors the kernel `csrc/hiz.cu` (counted in `LAUNCHES`), or it raises.
Min is exact, so kernel and plain agree exactly.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

Tensor = torch.Tensor

MAX_MIPS = 13
SPD_TILE_H = 128
SPD_TILE_W = 512
SPD_LEVELS = 2  # levels written per 128×512 tile; the tail levels follow

LAUNCHES = 0


def mip_shapes(h: int, w: int, max_mips: int = MAX_MIPS) -> list[tuple[int, int]]:
    """Shapes of every level, the padded base first."""
    hp = -(-h // SPD_TILE_H) * SPD_TILE_H
    wp = -(-w // SPD_TILE_W) * SPD_TILE_W
    shapes = [(hp >> k, wp >> k) for k in range(SPD_LEVELS + 1)]
    th, tw = shapes[-1]
    while min(th, tw) > 1 and len(shapes) < max_mips:
        th, tw = (th + 1) // 2, (tw + 1) // 2
        shapes.append((th, tw))
    return shapes


def _pad_base(depth: Tensor) -> Tensor:
    h, w = depth.shape
    hp, wp = mip_shapes(h, w)[0]
    return F.pad(depth, (0, wp - w, 0, hp - h), value=0.0).contiguous()


def _min_downsample(cur: Tensor) -> Tensor:
    """2× min-downsample; an odd size's missing partner reads 0."""
    h, w = cur.shape
    cur = F.pad(cur, (0, w % 2, 0, h % 2), value=0.0)
    return cur.reshape((h + 1) // 2, 2, (w + 1) // 2, 2).amin(dim=(1, 3))


def hiz_reference(depth: Tensor, max_mips: int = MAX_MIPS) -> list[Tensor]:
    """The plain PyTorch version of the CUDA kernel: the list of levels."""
    mips = [_pad_base(depth)]
    for _ in mip_shapes(*depth.shape, max_mips)[1:]:
        mips.append(_min_downsample(mips[-1]))
    return mips


def _hiz_cuda(depth: Tensor, max_mips: int) -> list[Tensor]:
    """Launch `hiz_build` on PyTorch's current stream: one launch for the two
    tiled levels, one for the tail. Raises on a build or launch error."""
    from .._build import load_kernel_library

    lib = load_kernel_library()
    if depth.dtype != torch.float32 or depth.dim() != 2:
        raise ValueError("depth must be a 2-D float32 tensor")
    shapes = mip_shapes(*depth.shape, max_mips)
    base = _pad_base(depth)
    sizes = [hh * ww for hh, ww in shapes[1:]]
    flat = torch.empty(sum(sizes), dtype=torch.float32, device=depth.device)
    err = lib.hiz_build(base.data_ptr(), shapes[0][0], shapes[0][1], len(shapes), flat.data_ptr(),
                        torch.cuda.current_stream(depth.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"hiz_build launch failed: {lib.kernel_error_string(err).decode()}")
    return [base] + [m.view(s) for m, s in zip(torch.split(flat, sizes), shapes[1:])]


def build_hiz(depth: Tensor, max_mips: int = MAX_MIPS) -> list[Tensor]:
    """Mip chain of min-reduced depth; mips[0] is the padded full-res depth.
    The CUDA kernel for tensors on a card (counted in `LAUNCHES`), the plain
    version for tensors on the CPU, nothing else."""
    global LAUNCHES
    if depth.is_cuda:
        out = _hiz_cuda(depth, max_mips)
        LAUNCHES += 1
        return out
    if depth.device.type == "cpu":
        return hiz_reference(depth, max_mips)
    raise ValueError(f"no HiZ implementation for device {depth.device}")


def occlusion_test(mips: list[Tensor], xmin, xmax, ymin, ymax, nearest_depth, width: int, height: int) -> Tensor:
    """Batched conservative visibility, True = possibly visible: the level is
    chosen so the footprint spans ≤ 2×2 texels; visible iff the object's
    nearest depth ≥ the min of those 4 texels."""
    xmin_c = torch.clamp(xmin, 0.0, width - 1.0)
    xmax_c = torch.clamp(xmax, 0.0, width - 1.0)
    ymin_c = torch.clamp(ymin, 0.0, height - 1.0)
    ymax_c = torch.clamp(ymax, 0.0, height - 1.0)
    size = torch.maximum(xmax_c - xmin_c, ymax_c - ymin_c)
    level = torch.clamp(torch.ceil(torch.log2(torch.clamp(size, min=1.0))).to(torch.int32), 0, len(mips) - 1)

    flat = torch.cat([m.reshape(-1) for m in mips])
    off = 0
    base_off = torch.zeros_like(level)
    mip_w = torch.zeros_like(level)
    mip_h = torch.zeros_like(level)
    for lvl, m in enumerate(mips):
        sel = level == lvl
        base_off = torch.where(sel, off, base_off)
        mip_w = torch.where(sel, m.shape[1], mip_w)
        mip_h = torch.where(sel, m.shape[0], mip_h)
        off += m.numel()

    scale = torch.exp2(-level.to(torch.float32))
    x0 = torch.minimum(torch.clamp(torch.floor(xmin_c * scale).to(torch.int32), min=0), mip_w - 1)
    y0 = torch.minimum(torch.clamp(torch.floor(ymin_c * scale).to(torch.int32), min=0), mip_h - 1)
    x1 = torch.minimum(x0 + 1, mip_w - 1)
    y1 = torch.minimum(y0 + 1, mip_h - 1)
    t = lambda yy, xx: flat[(base_off + yy * mip_w + xx).long()]
    farthest = torch.minimum(torch.minimum(t(y0, x0), t(y0, x1)), torch.minimum(t(y1, x0), t(y1, x1)))
    return nearest_depth >= farthest
