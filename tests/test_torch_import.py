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
    "oxylus_tpu_torch.physics.megakernel",
    "oxylus_tpu_torch.physics.step",
    "oxylus_tpu_torch.physics.events",
    "oxylus_tpu_torch.profile_flagship",
    "oxylus_tpu_torch.profile_frame3d",
    "oxylus_tpu_torch.frame5",
    "oxylus_tpu_torch.core.config",
    "oxylus_tpu_torch.assets.bake",
    "oxylus_tpu_torch.assets.native",
    "oxylus_tpu_torch.assets.material",
    "oxylus_tpu_torch.render.renderer2d",
    "oxylus_tpu_torch.render.camera",
    "oxylus_tpu_torch.render.scene3d",
    "oxylus_tpu_torch.render.pbr",
    "oxylus_tpu_torch.render.postfx",
    "oxylus_tpu_torch.render.renderer3d",
    "oxylus_tpu_torch.ops.compact",
    "oxylus_tpu_torch.ops.cull",
    "oxylus_tpu_torch.ops.setup3d",
    "oxylus_tpu_torch.ops.raster3d",
    "oxylus_tpu_torch.ops.hiz",
    "oxylus_tpu_torch.ops.raster_depth",
    "oxylus_tpu_torch.utils.imgops",
    "oxylus_tpu_torch.render.sky",
    "oxylus_tpu_torch.render.shadows",
    "oxylus_tpu_torch.render.gtao",
    "oxylus_tpu_torch.render.ssr",
    "oxylus_tpu_torch.ops.blend2d",
    "oxylus_tpu_torch.ops.raster2d",
    "oxylus_tpu_torch.frame2d",
    "oxylus_tpu_torch.frame3d",
    "oxylus_tpu_torch.bench",
    "oxylus_tpu_torch.probes",
    "oxylus_tpu_torch.probes.dynslice",
    "oxylus_tpu_torch.probes.dot_rhs_t",
    "oxylus_tpu_torch.probes.mosaic_ops",
    "oxylus_tpu_torch.probes.roll",
    "oxylus_tpu_torch.assets.texture",
    "oxylus_tpu_torch.assets.gltf",
    "oxylus_tpu_torch.assets.procgen",
    "oxylus_tpu_torch.ops.sampling",
    "oxylus_tpu_torch.sponza",
    "oxylus_tpu_torch.ops.decode3d",
    "oxylus_tpu_torch.ops.raster_groups",
    "oxylus_tpu_torch.time_redesigns",
    "oxylus_tpu_torch.utils.slotmap",
    "oxylus_tpu_torch.core.events",
    "oxylus_tpu_torch.core.jobs",
    "oxylus_tpu_torch.core.vfs",
    "oxylus_tpu_torch.core.app",
    "oxylus_tpu_torch.core.input",
    "oxylus_tpu_torch.core.project",
    "oxylus_tpu_torch.core.window",
    "oxylus_tpu_torch.utils.profiler",
    "oxylus_tpu_torch.scene.serialize",
    "oxylus_tpu_torch.scene.snapshot",
    "oxylus_tpu_torch.scripting.system",
    "oxylus_tpu_torch.assets.manager",
    "oxylus_tpu_torch.assets.pack",
    "oxylus_tpu_torch.audio.engine",
    "oxylus_tpu_torch.assets.bcdec",
    "oxylus_tpu_torch.network",
    "oxylus_tpu_torch.network.wire",
    "oxylus_tpu_torch.network.packet",
    "oxylus_tpu_torch.network.manager",
    "oxylus_tpu_torch.render.debugdraw",
    "oxylus_tpu_torch.render.debugviews",
    "oxylus_tpu_torch.render.picking",
    "oxylus_tpu_torch.core.modules",
    "oxylus_tpu_torch.ui.text",
    "oxylus_tpu_torch.ui.imgui",
    "oxylus_tpu_torch.ui.rml",
    "oxylus_tpu_torch.ui.widgets",
    "oxylus_tpu_torch.editor",
    "oxylus_tpu_torch.editor.context",
    "oxylus_tpu_torch.editor.gizmo",
    "oxylus_tpu_torch.editor.panels",
    "oxylus_tpu_torch.editor.workspace",
]

PROBE = f"""
import importlib, sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
for name in {SLICE_MODULES!r}:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m == "oxylus_tpu" or m.startswith(("oxylus_tpu.", "jax.", "jaxlib", "scripts")))
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


def test_cuda_request_without_card_raises(monkeypatch):
    """Device resolution defaults to the card and never falls back to the CPU."""
    import pytest
    import torch

    from oxylus_tpu_torch.device import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in (None, "cuda", "cuda:0"):
        with pytest.raises(RuntimeError):
            resolve_device(device)


def test_entry_points_default_to_the_card(monkeypatch):
    """Scene, build_flagship, entry, the frame builders and SceneRunner resolve
    `device=None` to the card: without one they raise instead of using the CPU."""
    import pytest
    import torch

    from oxylus_tpu_torch.flagship import build_flagship, entry
    from oxylus_tpu_torch.frame2d import build_frame2d_scene
    from oxylus_tpu_torch.frame3d import build_frame3d_scene
    from oxylus_tpu_torch.frame5 import build_frame5_scene
    from oxylus_tpu_torch.runtime import SceneRunner
    from oxylus_tpu_torch.scene.scene import Scene

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        Scene("s")
    with pytest.raises(RuntimeError):
        build_flagship(8)
    with pytest.raises(RuntimeError):
        entry()
    with pytest.raises(RuntimeError):
        build_frame5_scene(64, 64, n_objects=2, n_boxes=2)
    with pytest.raises(RuntimeError):
        build_frame2d_scene(64, 64, n_sprites=4)
    with pytest.raises(RuntimeError):
        build_frame3d_scene(64, 64, n_objects=2)
    with pytest.raises(RuntimeError):
        SceneRunner(Scene("s", device="cpu"))
    from oxylus_tpu_torch.assets.material import Material, pack_materials
    from oxylus_tpu_torch.sponza import build_sponza_scene

    with pytest.raises(RuntimeError):
        build_sponza_scene(64, 64, n_meshes=5, n_materials=4)
    with pytest.raises(RuntimeError):
        pack_materials([Material()], {}, 4)
