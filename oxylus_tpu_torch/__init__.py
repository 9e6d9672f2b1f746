"""oxylus_tpu_torch — the PyTorch/CUDA port of `oxylus_tpu`.

The JAX package beside it stays the reference; this package mirrors its module
paths and public names so each counterpart is easy to find. It imports `torch`
and never `jax`, not even transitively: host modules the slice needs are carried
as copies (`scene/components.py`, `core/uuid.py`), because every import of
`oxylus_tpu` pulls in JAX.

Ported so far: the fused simulate-and-render 3D frame (`runtime.py`,
`scene/frame.py`, `render/`, `ops/`) with the compact rigid-body, tile raster,
HiZ and depth raster kernels and the particle composite; the 2D frame
(`render/renderer2d.py`, `ops/raster2d.py`) with the sprite blend kernel
(`ops/blend2d.py`); and the runner's separate-stage physics: the dense
rigid-body kernel (`physics/megakernel.py`), the plain substep
(`physics/step.py`) and contact events (`physics/events.py`); and the app path:
JSON scenes and snapshots, scripts, the asset manager and packs, audio in the
frame loop and the `App` runtime (`core/`, `scene/serialize.py`,
`scene/snapshot.py`, `scripting/`, `assets/manager.py`, `assets/pack.py`,
`audio/`); and the default module roster (`core/modules.py`) with KTX2/DDS
textures (`assets/bcdec.py`), networking (`network/`), the debug renderer,
picking, debug views and the last post effects. CUDA sources live in `*/csrc/`.
"""

__version__ = "0.1.0"
