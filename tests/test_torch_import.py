"""The port imports no JAX, not even transitively: the machine with the card has none."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SLICE_MODULES = [
    "oxylus_tpu_torch",
    "oxylus_tpu_torch.device",
    "oxylus_tpu_torch.bridge",
    "oxylus_tpu_torch._build",
    "oxylus_tpu_torch.flagship",
    "oxylus_tpu_torch.runtime",
    "oxylus_tpu_torch.utils.math3d",
    "oxylus_tpu_torch.core.uuid",
    "oxylus_tpu_torch.scene.components",
    "oxylus_tpu_torch.scene.state",
    "oxylus_tpu_torch.scene.scene",
    "oxylus_tpu_torch.scene.particles",
    "oxylus_tpu_torch.scene.frame",
    "oxylus_tpu_torch.physics.state",
    "oxylus_tpu_torch.physics.build",
    "oxylus_tpu_torch.physics.megakernel_banded",
    "oxylus_tpu_torch.physics.megakernel_compact",
    "oxylus_tpu_torch.profile_flagship",
]

PROBE = f"""
import importlib, sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
for name in {SLICE_MODULES!r}:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m == "oxylus_tpu" or m.startswith(("oxylus_tpu.", "jax.", "jaxlib")))
assert not bad, bad
print("ok")
"""


def test_port_imports_without_jax():
    proc = subprocess.run(
        [sys.executable, "-c", PROBE], cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": ROOT},
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_cuda_request_without_card_raises():
    """Device resolution never falls back to the CPU."""
    import pytest
    import torch

    from oxylus_tpu_torch.device import resolve_device

    assert resolve_device(None) == torch.device("cpu")
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card branch cannot be exercised")
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
