"""oxylus_tpu_torch — the PyTorch/CUDA port of `oxylus_tpu`.

The JAX package beside it stays the reference; this package mirrors its module
paths and public names so each counterpart is easy to find. It imports `torch`
and never `jax`, not even transitively: host modules the slice needs are carried
as copies (`scene/components.py`, `core/uuid.py`), because every import of
`oxylus_tpu` pulls in JAX.

Ported so far: the headless frame step (`scene/frame.py`, `runtime.py`) with the
compact rigid-body kernel (`physics/megakernel_compact.py`, CUDA source in
`physics/csrc/`).
"""

__version__ = "0.1.0"
