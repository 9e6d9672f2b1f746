"""The port's textured and alpha-masked group raster route against the JAX
package's.

The scenes of `tests/test_torch_texturing.py` (three scenes of
`tests/test_texturing.py`) and its two-frame late-pass case, rendered by both
packages' `RendererInstance.render` on `RenderSpec(raster_path="group")`
(dense groups of 64 from `compact_triangles`, 64-px tiles): the JAX group
kernel in interpret mode (`gbuffer_interpret=True`), its HiZ through the
interpret-mode device path and its `lax.cond` as Python branches, the JAX
graph op by op. The group route reads the float32 material rows through its
slot material table at the dense slot stride, and its masked pass is one more
group raster pass, after the earlier passes' groups.

Bounds: depth and vid exactly equal; the G-buffer's albedo, normal,
metallic, roughness, occlusion and emissive within 2e-2 on the pixels whose
vid is equal in a 5×5 neighbourhood (`tests/test_torch_texturing.py`'s
bound); the final image PSNR ≥ 40 dB (the goldens' bound); the JAX test's
red-and-green assertions hold for both packages."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oxylus_tpu.assets import material as jmat
from oxylus_tpu.core.config import RendererConfig as JConfig
from oxylus_tpu.render.renderer3d import RenderSpec as JSpec
from oxylus_tpu.render.renderer3d import RendererInstance as JRenderer
from oxylus_tpu_torch import bridge
from oxylus_tpu_torch.assets import material as tmat
from oxylus_tpu_torch.core.config import RendererConfig
from oxylus_tpu_torch.ops import raster_groups as tg
from oxylus_tpu_torch.render.renderer3d import RenderSpec, RendererInstance
from tests.test_torch_render3d import _camera, jax_device_paths
from tests.test_torch_shadows import host_branches
from tests.test_torch_texturing import H, W, _assert_frame_matches, _mask_scene, _plane_scene, _red_green

torch.set_num_threads(1)

GROUP = 64  # slots per dense group: the group route's slot stride


def _render_both_group(sc, states, capacity=8):
    """Both renderers on the group route over `states` (one frame each, the
    carry fed back). Returns (JAX frames, port frames, the port's group
    raster calls per frame)."""
    spec = dict(width=W, height=H, max_visible_meshlets=64, raster_path="group", raster_group=GROUP)
    cfg_kw = dict(vbgtao_enable=False, bloom_enable=False)
    jr = JRenderer(JSpec(**spec, gbuffer_interpret=True))
    jm = jmat.pack_materials([jmat.Material(**m) for m in sc["mats"]], sc["rects"], capacity)
    kw = dict(textured=True, texture_features=sc["features"], alpha_masked=sc["masked"])
    want, prev = [], {}
    with jax_device_paths(), host_branches():
        for st in states:
            ctx = jr.render(st, sc["gscene"], sc["camera"], jm, jnp.asarray(sc["atlas"]),
                            dataclasses.replace(JConfig(), **cfg_kw), prev=prev, **kw)
            prev = ctx["carry"]
            want.append(jax.device_get({k: ctx[k] for k in ("depth", "visbuffer", "final", "gbuffer",
                                                            "slot_material")}))
    tr_ = RendererInstance(RenderSpec(**spec))
    tm = tmat.pack_materials([tmat.Material(**m) for m in sc["mats"]], sc["rects"], capacity, device="cpu")
    gscene = bridge.gpu_scene_from_numpy(jax.device_get(sc["gscene"]))
    cam = _camera(jax.device_get(sc["camera"]))
    got, passes, prev = [], [], {}
    orig = tg.run_groups
    calls = []
    tg.run_groups = lambda *a, **k: (calls.append(1), orig(*a, **k))[1]
    try:
        for st in states:
            n0 = len(calls)
            ctx = tr_.render(bridge.scene_state_from_numpy(jax.device_get(st)), gscene, cam, tm,
                             torch.from_numpy(sc["atlas"]), dataclasses.replace(RendererConfig(), **cfg_kw),
                             prev=prev, **kw)
            prev = ctx["carry"]
            got.append({"depth": ctx["depth"].numpy(), "visbuffer": ctx["visbuffer"].numpy(),
                        "final": ctx["final"].numpy(), "gbuffer": {k: v.numpy() for k, v in ctx["gbuffer"].items()},
                        "slot_material": ctx["slot_material"].numpy(), "slot_group": ctx["slot_group"]})
            passes.append(len(calls) - n0)
    finally:
        tg.run_groups = orig
    return want, got, passes


def _assert_group_frame_matches(got, want):
    np.testing.assert_array_equal(got["depth"], want["depth"])
    np.testing.assert_array_equal(got["visbuffer"], want["visbuffer"])
    np.testing.assert_array_equal(got["slot_material"], want["slot_material"])
    assert got["slot_group"] == GROUP
    _assert_frame_matches(got, want)


@pytest.fixture(scope="module")
def masked_frames():
    sc = _mask_scene(occluder=False)
    return _render_both_group(sc, [sc["state"]])


def test_group_alpha_mask_discard_matches_jax(masked_frames):
    want, got, passes = masked_frames
    assert passes == [2]  # the opaque pass, then the masked pass
    _assert_group_frame_matches(got[0], want[0])
    for frame in (want[0], got[0]):
        _red_green(frame)


def test_group_masked_vids_follow_the_late_pass():
    """`tests/test_torch_texturing.py::test_masked_vids_follow_the_late_pass`
    on the group route: in the second frame the late pass rasters the block
    revealed from the first pyramid, and the masked pass's vids follow the
    early and late passes' groups and resolve to the quad's material through
    the slot material table at the group stride."""
    sc = _mask_scene(occluder=True)
    st0 = sc["state"]
    world = np.array(st0.world)
    occ_idx = int(np.asarray(sc["gscene"].inst_entity)[2])
    world[occ_idx, 0, 3] = 100.0  # far outside the frustum
    st1 = dataclasses.replace(st0, world=jnp.asarray(world))
    want, got, passes = _render_both_group(sc, [st0, st1])
    assert passes == [2, 3]  # frame 1: early, late, masked
    for g, w in zip(got, want):
        _assert_group_frame_matches(g, w)
    red = _red_green(got[1])
    _red_green(want[1])
    vid = got[1]["visbuffer"]
    flat = (vid[red] >> 8) * GROUP + (vid[red] & 255)
    assert (got[1]["slot_material"][flat] == 1).all()  # the kept quad pixels resolve to the quad's material
    # ... through the masked pass's groups, which follow every earlier pass's
    n_groups = got[1]["slot_material"].size // GROUP
    masked_groups = np.unique(vid[red] >> 8)
    assert masked_groups.min() >= n_groups // 3 * 2  # each pass tables the same number of groups


def test_group_production_sampler_scene_matches_jax():
    sc = _plane_scene()
    want, got, passes = _render_both_group(sc, [sc["state"]])
    assert passes == [1]  # no masked material: no masked pass
    _assert_group_frame_matches(got[0], want[0])
    g = got[0]["gbuffer"]
    hit = g["hit"]
    # every map sampled: albedo (200, 80, 40)/255, metallic 192/255, occlusion 128/255, emissive green ×2
    np.testing.assert_allclose(np.median(g["albedo"][hit], 0), [200 / 255, 80 / 255, 40 / 255], atol=0.02)
    assert abs(np.median(g["metallic"][hit]) - 192 / 255) < 0.02 and abs(np.median(g["occlusion"][hit]) - 128 / 255) < 0.02
    assert np.median(g["emissive"][hit][:, 1]) > 1.9 and np.median(g["emissive"][hit][:, 0]) < 0.02
    assert np.median(np.abs(g["normal"][hit][:, 0])) > 0.3  # the tilted normal map moved the normals off +Y
