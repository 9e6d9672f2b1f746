"""The port's GTAO (`render/gtao.py`), SSR (`render/ssr.py`) and image helpers
(`utils/imgops.py`, `utils/math3d.py` image transforms) against the JAX
package's.

The inputs are small synthetic frames made from a seed: for GTAO a bumpy
ground patch seen from above in view space (pixel spacing 2 cm, so the 24-px
taps reach the 0.5 m radius); for SSR a ground plane and a wall seen by a
perspective camera, with the depth buffer projected from the positions.

`gtao` and `ssr_trace` are `jax.jit`-ed in the JAX package: XLA contracts
their products into fused multiply-adds, which moves an angle across a
sector boundary or a march sample across a depth threshold on a few pixels.
Run op by op (`jax.disable_jit()`) the JAX functions round as the port does,
and these tests hold the port to them: GTAO within 2e-7 (its sector masks
equal: one sector of one slice moves the AO by ≥ 1/96; the last `** 1.2`
rounds by an ulp in another `pow`), the denoise and the depth prefilter within 1e-6, SSR's hit texels
and confidence exactly equal and its composite within 1e-5. Against the
jitted GTAO the bound is stated too: AO within 1/32 (one sector of one
slice's mask, raised to the final power) on ≥ 99 % of pixels.

`resize_linear` against `jax.image.resize(..., method="linear")` for the
frame's ×2, ×4 and ×8 upsamplings of 2-D and 3-channel images: within 1e-6,
borders included (JAX renormalises the kernel weights that fall outside the
image, `F.interpolate` clamps the sample point; for an upsampling both give
the edge texel). `point_downsample` and the image transforms exactly equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oxylus_tpu.render import gtao as jg
from oxylus_tpu.render import ssr as jssr
from oxylus_tpu.render.camera import camera_matrices
from oxylus_tpu.utils import imgops as jimg
from oxylus_tpu.utils import math3d as jm3
from oxylus_tpu_torch.render import gtao as tg
from oxylus_tpu_torch.render import ssr as tssr
from oxylus_tpu_torch.utils import imgops as timg
from oxylus_tpu_torch.utils import math3d as tm3

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _view_patch(seed=0, h=48, w=64):
    """View-space positions and normals of a bumpy patch 4 m below the eye."""
    rng = np.random.default_rng(seed)
    xs = (np.arange(w) - w / 2 + 0.5) * 0.02
    ys = (np.arange(h) - h / 2 + 0.5) * 0.02
    x, y = np.meshgrid(xs, ys)
    z = -4.0 * np.ones_like(x)
    for _ in range(6):  # bumps toward the eye
        cx, cy, r, a = rng.uniform(-0.6, 0.6), rng.uniform(-0.45, 0.45), rng.uniform(0.05, 0.2), rng.uniform(0.1, 0.4)
        z += a * np.exp(-((x - cx) ** 2 + (y - cy) ** 2) / (2 * r * r))
    pos = np.stack([x, y, z], -1).astype(np.float32)
    gy, gx = np.gradient(z, 0.02)
    n = np.stack([-gx, -gy, np.ones_like(z)], -1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    hit = rng.uniform(size=(h, w)) < 0.95
    return pos, n.astype(np.float32), hit


@pytest.mark.parametrize("quality", [0, 3])
def test_gtao_matches_jax_op_by_op(quality):
    pos, nrm, hit = _view_patch(quality)
    kw = dict(radius=0.5, thickness=0.25, final_power=1.2, quality_level=quality)
    with jax.disable_jit():
        want = np.asarray(jg.gtao(jnp.asarray(pos), jnp.asarray(nrm), jnp.asarray(hit), **kw))
    got = tg.gtao(_t(pos), _t(nrm), _t(hit), **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-7)
    assert 0.2 < want[hit].min() < 0.99 and want.max() == 1.0  # occluded and open pixels
    jitted = np.asarray(jg.gtao(jnp.asarray(pos), jnp.asarray(nrm), jnp.asarray(hit), **kw))
    assert (np.abs(got - jitted) <= 1.0 / 32).mean() >= 0.99


def test_gtao_bit_helpers():
    k = torch.arange(-2, 35)
    masks = tg._bits_below(k)
    want = [(1 << min(max(int(i), 0), 32)) - 1 for i in k]
    assert masks.tolist() == want
    rng = np.random.default_rng(0)
    words = rng.integers(0, 2**32, 500, dtype=np.uint64)
    got = tg._popcount32(torch.from_numpy(words.astype(np.int64))).numpy()
    assert got.tolist() == [bin(int(x)).count("1") for x in words]


def test_denoise_and_prefilter_match_jax():
    rng = np.random.default_rng(1)
    ao = rng.uniform(0, 1, (30, 44)).astype(np.float32)
    depth = (0.2 + 0.05 * rng.normal(size=(30, 44))).astype(np.float32)
    np.testing.assert_allclose(tg.denoise_ao(_t(ao), _t(depth)).numpy(),
                               np.asarray(jg.denoise_ao(jnp.asarray(ao), jnp.asarray(depth))), rtol=1e-6, atol=1e-6)
    for got, want in zip(tg.prefilter_depth(_t(depth)), jg.prefilter_depth(jnp.asarray(depth))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _ssr_frame(h=36, w=64):
    """A ground plane (y = 0) and a wall (z = -6) seen from (0, 1.5, 4)."""
    cam = camera_matrices(
        position=jnp.array([0.0, 1.5, 4.0]), yaw=jnp.float32(-np.pi / 2), pitch=jnp.float32(-0.25),
        tilt=jnp.float32(0.0), fov_deg=jnp.float32(60.0), near=jnp.float32(0.1), far=jnp.float32(100.0),
        zoom=jnp.float32(1.0), projection_kind=jnp.int32(0), aspect=jnp.float32(w / h),
    )
    inv_vp = np.linalg.inv(np.asarray(cam.view_projection, np.float64))
    xs = ((np.arange(w) + 0.5) / w) * 2 - 1
    ys = ((np.arange(h) + 0.5) / h) * 2 - 1
    ndc_x, ndc_y = np.meshgrid(xs, ys)
    near = np.stack([ndc_x, ndc_y, np.ones_like(ndc_x), np.ones_like(ndc_x)], -1) @ inv_vp.T
    far = np.stack([ndc_x, ndc_y, np.full_like(ndc_x, 1e-3), np.ones_like(ndc_x)], -1) @ inv_vp.T
    o, f = near[..., :3] / near[..., 3:], far[..., :3] / far[..., 3:]
    d = f - o
    t_ground = np.where(d[..., 1] < 0, -o[..., 1] / np.minimum(d[..., 1], -1e-9), np.inf)
    t_wall = np.where(d[..., 2] < 0, (-6.0 - o[..., 2]) / np.minimum(d[..., 2], -1e-9), np.inf)
    t = np.minimum(t_ground, t_wall)
    hit = np.isfinite(t) & (t < 1.0)
    wp = np.where(hit[..., None], o + d * np.where(hit, t, 0.0)[..., None], 0.0)
    nrm = np.where((t_ground <= t_wall)[..., None], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0])
    clip = np.concatenate([wp, np.ones_like(wp[..., :1])], -1) @ np.asarray(cam.view_projection, np.float64).T
    depth = np.where(hit, clip[..., 2] / clip[..., 3], 0.0)
    rng = np.random.default_rng(2)
    g = {
        "world_pos": wp.astype(np.float32), "normal": nrm.astype(np.float32), "hit": hit,
        "albedo": rng.uniform(0, 1, (h, w, 3)).astype(np.float32),
        "metallic": rng.uniform(0, 1, (h, w)).astype(np.float32),
        "roughness": rng.uniform(0, 0.6, (h, w)).astype(np.float32),
    }
    hdr = rng.uniform(0, 3, (h, w, 3)).astype(np.float32)
    return g, depth.astype(np.float32), hdr, np.asarray(cam.position), np.asarray(cam.view_projection)


def test_ssr_trace_matches_jax_op_by_op():
    g, depth, hdr, cam_pos, vp = _ssr_frame()
    args = [depth, g["world_pos"], g["normal"], g["hit"], hdr, cam_pos, vp]
    with jax.disable_jit():
        color_j, conf_j = jssr.ssr_trace(*(jnp.asarray(a) for a in args), steps=8)
    color, conf = tssr.ssr_trace(*(_t(a) for a in args), steps=8)
    np.testing.assert_array_equal(conf.numpy(), np.asarray(conf_j))
    np.testing.assert_array_equal(color.numpy(), np.asarray(color_j))
    assert (np.asarray(conf_j) > 0).mean() > 0.05  # the ground reflects the wall


def test_apply_ssr_matches_jax():
    g, depth, hdr, cam_pos, vp = _ssr_frame(h=144, w=256)
    with jax.disable_jit():
        want = np.asarray(jssr.apply_ssr(jnp.asarray(hdr), {k: jnp.asarray(v) for k, v in g.items()},
                                         jnp.asarray(depth), jnp.asarray(cam_pos), jnp.asarray(vp), steps=8))
    got = tssr.apply_ssr(_t(hdr), {k: _t(v) for k, v in g.items()}, _t(depth), _t(cam_pos), _t(vp), steps=8).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert np.abs(want - hdr).max() > 0.05  # reflections were composited


@pytest.mark.parametrize("k", [2, 4, 8])
def test_resize_linear_matches_jax_image_resize(k):
    rng = np.random.default_rng(k)
    for shape in ((144 // k, 256 // k), (135 // k + 1, 240 // k, 3)):
        img = rng.uniform(-1, 1, shape).astype(np.float32)
        out = (shape[0] * k, shape[1] * k) + shape[2:]
        want = np.asarray(jax.image.resize(jnp.asarray(img), out, method="linear"))
        got = timg.resize_linear(_t(img), out).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        # the border rows and columns: the edge texel itself
        np.testing.assert_allclose(got[: k // 2, 0], np.broadcast_to(img[0, 0], got[: k // 2, 0].shape), atol=1e-6)


def test_point_downsample_and_image_transforms_match_jax():
    rng = np.random.default_rng(3)
    img = rng.normal(size=(37, 50, 3)).astype(np.float32)
    for k in (1, 2, 4, 8):
        np.testing.assert_array_equal(timg.point_downsample(_t(img), k).numpy(),
                                      np.asarray(jimg.point_downsample(jnp.asarray(img), k)))
    m = rng.normal(size=(4, 4)).astype(np.float32)
    with jax.disable_jit():
        want4 = np.asarray(jm3.mat4_point_image(jnp.asarray(m), jnp.asarray(img)))
        want3 = np.asarray(jm3.mat3_dir_image(jnp.asarray(m[:3, :3]), jnp.asarray(img)))
    np.testing.assert_array_equal(tm3.mat4_point_image(_t(m), _t(img)).numpy(), want4)
    np.testing.assert_array_equal(tm3.mat3_dir_image(_t(m[:3, :3]), _t(img)).numpy(), want3)
