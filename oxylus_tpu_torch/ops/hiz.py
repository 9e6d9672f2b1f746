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
Min is exact, so kernel and plain agree exactly. The kernel is one launch: a
CTA per BLOCK² block of the padded base reads the depth, writes the base and
its block's first BLOCK_LEVELS levels, and the last CTA to finish (a counter
the wrapper keeps per card and stream) walks the tail; `hiz_block_levels` is
a plain model of that split for the tests.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

Tensor = torch.Tensor

MAX_MIPS = 13
SPD_TILE_H = 128
SPD_TILE_W = 512
SPD_LEVELS = 2  # the TPU kernel's tiled levels, which halve the padded base exactly; the tail follows
BLOCK = 64  # the kernel's block of the padded base, one CTA each
BLOCK_LEVELS = 6  # levels a CTA reduces itself (64 → 1); the last CTA to finish walks the rest

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


def hiz_block_levels(depth: Tensor, max_mips: int = MAX_MIPS) -> list[Tensor]:
    """Plain model of the kernel's split: each BLOCK² block of the padded base
    reduced on its own through its first BLOCK_LEVELS levels, the blocks'
    levels put side by side, then the tail levels from the last of them with
    the zero-partner rule. Equal to `hiz_reference` level for level."""
    shapes = mip_shapes(*depth.shape, max_mips)
    (hp, wp), lv_block = shapes[0], min(BLOCK_LEVELS, len(shapes) - 1)
    mips = [_pad_base(depth)]
    blocks = mips[0].reshape(hp // BLOCK, BLOCK, wp // BLOCK, BLOCK).permute(0, 2, 1, 3)  # (by, bx, y, x)
    for lv in range(1, lv_block + 1):
        s = blocks.shape[-1] // 2
        blocks = blocks.reshape(*blocks.shape[:2], s, 2, s, 2).amin(dim=(3, 5))
        mips.append(blocks.permute(0, 2, 1, 3).reshape(hp >> lv, wp >> lv))
    for _ in shapes[lv_block + 1 :]:
        mips.append(_min_downsample(mips[-1]))
    return mips


# The kernel's finished-block counter, one per (card, stream), each left zeroed
# by the launch that used it. The last CTA of a launch is the one whose
# atomicAdd returns blocks - 1, so two launches that counted into one counter
# at the same time would pick the wrong CTA (or none) to walk the tail and
# leave the counter nonzero for every later call. Launches on one stream run
# one after another; keying by the stream keeps launches on two streams apart
# and adds nothing to a launch (a per-call cudaMemsetAsync would add a node).
# A CUDA graph that captured a launch keeps the pointer of its capture
# stream's counter, whatever stream it is later replayed on. A replay is
# correct while no other launch that uses that counter runs at the same time:
# neither an eager `build_hiz` on the capture stream nor another replay of a
# graph captured on it. `time_redesigns.py` captures HiZ and replays its graph
# on one stream with nothing else in flight, so its replays are correct.
_COUNTERS: dict[tuple[torch.device, int], Tensor] = {}


def _counter(dev: torch.device, stream: int) -> Tensor:
    """The zeroed counter of (`dev`, raw stream handle `stream`), made at its first use."""
    key = (dev, stream)
    if key not in _COUNTERS:
        _COUNTERS[key] = torch.zeros(1, dtype=torch.int32, device=dev)
    return _COUNTERS[key]


def _hiz_cuda(depth: Tensor, max_mips: int) -> list[Tensor]:
    """Launch `hiz_build` on PyTorch's current stream: one launch writes the
    padded base and every level. Raises on a build or launch error."""
    from .._build import load_kernel_library

    lib = load_kernel_library()
    if depth.dtype != torch.float32 or depth.dim() != 2:
        raise ValueError("depth must be a 2-D float32 tensor")
    depth = depth.contiguous()
    dev = depth.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    counter = _counter(dev, stream)
    shapes = mip_shapes(*depth.shape, max_mips)
    (hp, wp), sizes = shapes[0], [hh * ww for hh, ww in shapes[1:]]
    base = torch.empty((hp, wp), dtype=torch.float32, device=dev)
    flat = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
    err = lib.hiz_build(depth.data_ptr(), depth.shape[0], depth.shape[1], hp, wp, len(shapes), base.data_ptr(),
                        flat.data_ptr(), counter.data_ptr(), stream)
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
