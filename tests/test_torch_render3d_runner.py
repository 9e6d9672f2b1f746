"""The port's 3D runner against the JAX runner on the config-5 scene of
`tests/test_torch_render3d.py` (its size, camera, shadow maps and JAX device
paths): the port's `SceneRunner(**build_frame5_scene(...)[1])` for three
frames against the JAX runner built as `bench._build_frame5_runner` does, its
fused frame (`runtime.py:552-569`) composed from `frame_step` with its compact
kernel in interpret mode, `camera_from_state` and `render` (op by op). Bounds:
bodies within the slice-1 bounds, images PSNR ≥ 40 dB."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oxylus_tpu.physics.state import PhysicsParams as JParams
from oxylus_tpu.render import camera as jcamera
from oxylus_tpu.scene import frame as jframe
from oxylus_tpu_torch import bridge, frame5
from oxylus_tpu_torch.runtime import SceneRunner
from tests.test_torch_render3d import (  # noqa: F401 (the module-scoped shadow-map fixture)
    CAMERA_POS, H, MAX_BODIES, N_BOXES, N_OBJECTS, PSNR_MIN, W, _jax_runner, _small_shadow_maps, jax_device_paths,
    jax_renderer, psnr,
)
from tests.test_torch_shadows import host_branches

torch.set_num_threads(1)

DT = 1.0 / 40.0
RUNNER_FRAMES = 3
ATOL = {"pos": 5e-5, "linvel": 1e-3, "angvel": 5e-3, "quat": 1e-4}  # test_torch_frame.py's bounds


@pytest.fixture(scope="module")
def jax_side():
    """The JAX runner's fused frame, composed, for RUNNER_FRAMES frames."""
    runner, _ = _jax_runner()
    render = jax_renderer(runner)
    step = jax.jit(jframe.frame_step.__wrapped__, static_argnames=("spec", "has_bodies", "physics_mega"))
    cam_idx = runner._resolve_camera_idx()
    aspect = jnp.float32(W / H)
    mats, atlas = runner.bindings.materials, runner.bindings.atlas
    with jax_device_paths(), host_branches():
        state, ps, carry, images = runner.state, runner.ps, {}, []
        for _ in range(RUNNER_FRAMES):
            state, ps = step(state, ps, JParams(), jnp.float32(DT), runner.scene.spec, has_bodies=True,
                             physics_mega=True)
            cam = jcamera.camera_from_state(state, cam_idx, aspect)
            res, carry = render(state, runner.gscene, cam, mats, atlas, carry)
            images.append(np.asarray(res["final"]))
    return {"runner": dict(images=images, ps=jax.device_get(ps), carry=jax.device_get(carry))}


@pytest.fixture(scope="module")
def port_runner():
    scene, kw = frame5.build_frame5_scene(W, H, N_OBJECTS, N_BOXES, max_bodies=MAX_BODIES, device="cpu")
    scene.set_field(scene.entity("camera").index, "TransformComponent", "position", CAMERA_POS)
    runner = SceneRunner(scene, **kw)
    images = [runner.step(DT).numpy() for _ in range(RUNNER_FRAMES)]
    return runner, images


def test_runner_bodies_match_jax(jax_side, port_runner):
    runner, _ = port_runner
    want = jax_side["runner"]["ps"]
    got = bridge.physics_state_to_numpy(runner.ps)
    for k, tol in ATOL.items():
        np.testing.assert_allclose(got[k], np.asarray(getattr(want, k)), rtol=0, atol=tol, err_msg=k)
    assert np.abs(got["linvel"]).max() > 0.5  # the boxes are falling


def test_runner_images_match_jax(jax_side, port_runner):
    runner, images = port_runner
    for got, want in zip(images, jax_side["runner"]["images"]):
        assert got.shape == (H, W, 3) and np.isfinite(got).all() and got.min() >= 0 and got.max() <= 1
        assert psnr(got, want) >= PSNR_MIN
    assert set(runner.carry) == set(jax_side["runner"]["carry"])
    assert {"shadow_cache", "sky_view_lut", "aerial_lut", "ao_full", "shadow_full", "hiz"} <= set(runner.carry)
    assert int(runner.carry["expand_overflow"]) == 0
