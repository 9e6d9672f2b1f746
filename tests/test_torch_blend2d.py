"""The sprite blend (kernel #8's plain version, `oxylus_tpu_torch/ops/blend2d.py`),
its texture tiles, the sort keys and the sprite sort against the JAX package.

- `resample_texture_tiles`: both JAX atlas branches (one-hot products for
  atlases ≤ 256, the gather above) against the port's gather, exactly, also
  with rects past the int32 range once scaled (both saturate).
- `build_sprite_texture_tiles` on seeded per-sprite materials (scrolling,
  negative uv offsets, some just below an integer; rects partly outside
  [0, 1] and past the int32 range once scaled) at atlases of 64 and 512 px,
  exactly.
- `blend_tiles` (the plain version on CPU tensors) against
  `blend_tiles_pallas(..., interpret=True)`, with and without scene depth, on
  textured, tinted, flipped and alpha-masked sprites stacked in layers over a
  150×90 image (ragged edge tiles), with empty tiles and tiles filled to K.
  Colour within 1e-5 absolute: the TPU kernel sums its bilinear taps in its
  matrix product's order, the port in a fixed order. Vid equal except where
  one of a pixel's entries has an alpha within 1e-5 of the 0.5 threshold.
- `f32_to_sortable_u32` and `sprite_sort_order`: equal.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oxylus_tpu.assets.material import empty_gpu_materials
from oxylus_tpu.ops.raster2d import sprite_sort_order as jsort
from oxylus_tpu.ops.raster2d_pallas import blend_tiles_pallas
from oxylus_tpu.ops.raster2d_pallas import build_sprite_texture_tiles as jbuild_tiles
from oxylus_tpu.ops.raster2d_pallas import resample_texture_tiles as jresample
from oxylus_tpu.ops.sampling import f32_to_sortable_u32 as jkey
from oxylus_tpu_torch import bridge
from oxylus_tpu_torch.ops import blend2d
from oxylus_tpu_torch.ops.raster2d import f32_to_sortable_u32, sprite_sort_order

torch.set_num_threads(1)

W, H = 150, 90  # 5 × 3 tiles, the last column and row ragged
K = 8
COLOR_ATOL = 1e-5
VID_AMBIGUOUS = 1e-5


@pytest.mark.parametrize("atlas_size", [64, 512])
def test_resample_texture_tiles_matches_jax(atlas_size):
    rng = np.random.default_rng(atlas_size)
    s = 40
    packed = rng.uniform(-1, 1, (s, 29)).astype(np.float32)
    packed[:, 21:23] = rng.uniform(0.1, 1.5, (s, 2))  # uv_size, windows past 1 wrap
    packed[:, 23:25] = rng.uniform(-0.7, 0.9, (s, 2))  # uv_offset, negative ones too
    lo = rng.uniform(0, 0.6, (s, 2))
    packed[:, 25:27] = lo
    packed[:, 27:29] = lo + rng.uniform(0.05, 0.4, (s, 2))  # albedo_rect
    atlas = rng.integers(0, 256, (atlas_size, atlas_size, 4), dtype=np.uint8)
    want = np.asarray(jresample(jnp.asarray(packed), jnp.asarray(atlas)))
    got = blend2d.resample_texture_tiles(torch.from_numpy(packed), torch.from_numpy(atlas)).numpy()
    assert got.shape == want.shape == (s, 16, 16, 4)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("atlas_size", [64, 512])
def test_resample_texture_tiles_saturates_past_int32_as_jax(atlas_size):
    """Rect coordinates past the int32 range once scaled by the atlas: XLA's
    cast saturates, and so must the port's (a bare CPU cast gives INT_MIN,
    which the clamp would send to texel 0 instead of the last one)."""
    rng = np.random.default_rng(atlas_size + 7)
    s = 12
    packed = np.zeros((s, 29), np.float32)
    packed[:, 21:23] = rng.uniform(0.1, 1.0, (s, 2))
    packed[:, 23:25] = rng.uniform(-0.5, 0.5, (s, 2))
    lo = rng.uniform(0, 0.5, (s, 2))
    packed[:, 25:27] = lo
    packed[:, 27:29] = lo + 0.25
    packed[0, 27], packed[1, 25], packed[2, 28], packed[3, 26] = 1e12, -1e12, 3e9, 5e10
    packed[4, 25:29] = 2e10  # the whole window past INT32_MAX
    atlas = rng.integers(0, 256, (atlas_size, atlas_size, 4), dtype=np.uint8)
    want = np.asarray(jresample(jnp.asarray(packed), jnp.asarray(atlas)))
    got = blend2d.resample_texture_tiles(torch.from_numpy(packed), torch.from_numpy(atlas)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[4], np.broadcast_to(atlas[-1, -1] / np.float32(255.0), (16, 16, 4)))
    assert torch.tensor([2e10 * atlas_size], dtype=torch.float32).to(torch.int32).item() != 2**31 - 1


@pytest.mark.parametrize("atlas_size", [64, 512])
def test_build_sprite_texture_tiles_matches_jax(atlas_size):
    rng = np.random.default_rng(atlas_size + 1)
    s = 48
    uv_size = rng.uniform(0.1, 1.5, (s, 2)).astype(np.float32)
    uv_offset = rng.uniform(-2.5, 1.5, (s, 2)).astype(np.float32)  # scrolling windows, negative offsets
    uv_offset[:6] = -np.float32(1e-9)  # just below 0: the wrap rounds to 1.0
    uv_offset[6:10] = np.float32(-3.0) - np.float32(1e-7)
    uv_size[:6] = 0.0
    lo = rng.uniform(-0.3, 0.9, (s, 2))  # rects partly outside [0, 1]
    rect = np.concatenate([lo, lo + rng.uniform(0.02, 0.6, (s, 2))], 1).astype(np.float32)
    rect[10, 2], rect[11, 0], rect[12, 3] = 1e12, -1e12, 3e9  # past int32 once scaled by the atlas
    mats = dataclasses.replace(empty_gpu_materials(s), uv_size=jnp.asarray(uv_size),
                               uv_offset=jnp.asarray(uv_offset), albedo_rect=jnp.asarray(rect))
    atlas = rng.integers(0, 256, (atlas_size, atlas_size, 4), dtype=np.uint8)
    want = np.asarray(jbuild_tiles(mats, jnp.asarray(atlas)))
    got = blend2d.build_sprite_texture_tiles(bridge.gpu_materials_from_numpy(mats), torch.from_numpy(atlas))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (s, 16, 16, 4)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (np.fmod(uv_offset[:, None] + np.linspace(0, 1, 16, dtype=np.float32)[:, None] * uv_size[:, None], 1)
            < 0).any()  # windows that wrap from below 0


def _sprites(seed: int):
    """Sorted sprite records (S, 16), texel tiles (S, 16, 16, 4), tile lists
    (T, K) and record depths: rotated quads of assorted sizes, a cluster in the
    top-left tile deeper than K, none over the right column's lower tiles."""
    rng = np.random.default_rng(seed)
    centres = [(rng.uniform(4, 28), rng.uniform(4, 28)) for _ in range(12)]  # the crowded tile
    centres += [(rng.uniform(0, 100), rng.uniform(0, 90)) for _ in range(14)]
    centres += [(140.0, 10.0), (149.0, 30.0)]  # over the ragged right column's first tile
    s = len(centres)
    rec = np.zeros((s, 16), np.float32)
    bbox = np.zeros((s, 4), np.float32)
    for i, (cx, cy) in enumerate(centres):
        sx, sy = rng.uniform(6, 40, 2)
        th = rng.uniform(-np.pi, np.pi)
        rot = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
        corners = np.array([[-sx, -sy], [sx, -sy], [-sx, sy], [sx, sy]]) * 0.5 @ rot.T + [cx, cy]
        p00, p10, p01 = corners[0], corners[1], corners[2]
        e0, e1 = p10 - p00, p01 - p00
        det = e0[0] * e1[1] - e0[1] * e1[0]
        rec[i, 0:7] = [p00[0], p00[1], e0[0], e0[1], e1[0], e1[1], 1.0 / det]
        rec[i, 7:11] = rng.uniform(0.3, 1.0, 4)  # tint
        rec[i, 11] = 0.45  # alpha cutoff, applied where the mask flag is set
        rec[i, 12] = float(i % 3 == 0)  # alpha-masked
        rec[i, 13] = float(i % 4 != 3)  # textured
        rec[i, 14] = 100 + i  # entity id
        rec[i, 15] = float(i % 2 == 1)  # flip_x
        bbox[i] = corners[:, 0].min(), corners[:, 0].max(), corners[:, 1].min(), corners[:, 1].max()
    tex = rng.uniform(0, 1, (s, 16, 16, 4)).astype(np.float32)
    tex[..., 3] = np.clip(rng.uniform(-0.3, 1.3, (s, 16, 16)), 0, 1)  # transparent and opaque texels
    tx, ty = (W + 31) // 32, (H + 31) // 32
    tl = np.full((tx * ty, K), -1, np.int32)
    for t in range(tx * ty):
        x0, y0 = (t % tx) * 32, (t // tx) * 32
        hits = [i for i in range(s) if bbox[i, 1] >= x0 and bbox[i, 0] < x0 + 32 and bbox[i, 3] >= y0
                and bbox[i, 2] < y0 + 32][:K]
        tl[t, : len(hits)] = hits
    depth = rng.uniform(0, 1, s).astype(np.float32)
    return rec, tex, tl, depth


def _entry_alphas(rec, tex, tl, depth, scene_depth):
    """Each list position's alpha at every pixel: the port's blend of that
    entry alone over the empty image (its alpha channel is the entry's a)."""
    out = []
    for k in range(K):
        c, _ = blend2d.blend_tiles(torch.from_numpy(rec), torch.from_numpy(tex), torch.from_numpy(tl[:, k : k + 1]),
                                   W, H, rec_depth=depth, scene_depth=scene_depth)
        out.append(c[..., 3].numpy())
    return np.stack(out)


@pytest.mark.parametrize("with_depth", [False, True], ids=["plain", "depth"])
def test_blend_matches_jax_interpret(with_depth):
    rec, tex, tl, depth = _sprites(7)
    cnt = (tl >= 0).sum(1)
    assert (cnt == K).any() and (cnt == 0).any() and ((cnt > 0) & (cnt < K)).any()  # full, empty and partial tiles
    assert rec[:, 12].any() and rec[:, 15].any() and not rec[:, 13].all()
    sd = np.random.default_rng(8).uniform(0, 1, (H, W)).astype(np.float32) if with_depth else None
    jkw = dict(rec_depth=jnp.asarray(depth), scene_depth=jnp.asarray(sd)) if with_depth else {}
    want_c, want_v = blend_tiles_pallas(jnp.asarray(rec), jnp.asarray(tex), jnp.asarray(tl), W, H, interpret=True,
                                        **jkw)
    want_c, want_v = np.asarray(want_c), np.asarray(want_v)
    t_depth = torch.from_numpy(depth) if with_depth else None
    t_sd = torch.from_numpy(sd) if with_depth else None
    got_c, got_v = blend2d.blend_tiles(torch.from_numpy(rec), torch.from_numpy(tex), torch.from_numpy(tl), W, H,
                                       rec_depth=t_depth, scene_depth=t_sd)
    got_c, got_v = got_c.numpy(), got_v.numpy()
    assert got_c.shape == want_c.shape == (H, W, 4) and got_v.shape == want_v.shape == (H, W)
    assert got_c.dtype == np.float32 and got_v.dtype == np.int32
    np.testing.assert_allclose(got_c, want_c, rtol=0, atol=COLOR_ATOL)
    ambiguous = (np.abs(_entry_alphas(rec, tex, tl, t_depth, t_sd) - 0.5) < VID_AMBIGUOUS).any(0)
    np.testing.assert_array_equal(got_v[~ambiguous], want_v[~ambiguous])
    # the premise: sprites cover a good part of the image (the depth test
    # drops about half), some of it opaque enough to take the id, and empty
    # tiles stay clear
    assert (want_c[..., 3] > 0).mean() > 0.15 and (want_v >= 0).mean() > 0.05
    empty = np.repeat(np.repeat((cnt == 0).reshape(3, 5), 32, 0), 32, 1)[:H, :W]
    assert (got_c[empty] == 0).all() and (got_v[empty] == -1).all()


def test_blend_wrapper_refuses_other_devices():
    rec, tex, tl, _ = _sprites(3)
    packed = blend2d.pack_blend_inputs(torch.from_numpy(rec), torch.from_numpy(tex), torch.from_numpy(tl))
    with pytest.raises(ValueError, match="no sprite blend implementation"):
        blend2d.run_blend(*(t.to("meta") for t in packed), W, H)
    with pytest.raises(ValueError, match="go together"):
        blend2d.blend_tiles(*(torch.from_numpy(a) for a in (rec, tex, tl)), W, H,
                            scene_depth=torch.zeros((H, W)))


def test_sortable_key_matches_jax():
    vals = np.array([-np.inf, -1e30, -2.5, -1.0, -1e-40, -0.0, 0.0, 1e-40, 0.5, 1.0, 3e38, np.inf, np.nan],
                    np.float32)
    vals = np.concatenate([vals, np.random.default_rng(0).normal(0, 10, 200).astype(np.float32)])
    want = np.asarray(jkey(jnp.asarray(vals))).astype(np.int64)
    got = f32_to_sortable_u32(torch.from_numpy(vals)).numpy()
    np.testing.assert_array_equal(got, want)
    finite = np.argsort(vals[:12], kind="stable")
    assert list(np.argsort(got[:12], kind="stable")) == list(finite)  # the keys keep the float order


def test_sprite_sort_order_matches_jax():
    """Ties on every key (the 2D case: one depth, y sorting off) keep the
    index order, as the JAX sort does."""
    rng = np.random.default_rng(1)
    n = 4096
    depth = rng.choice(np.array([0.0, -0.0, 0.25, 1.0], np.float32), n)
    y = rng.choice(np.array([0.0, 1.5, -2.0], np.float32), n)
    sort_y = rng.uniform(size=n) < 0.5
    layer = rng.integers(0, 4, n).astype(np.int32)
    layer[rng.uniform(size=n) < 0.1] = 1 << 20  # particles' layer
    valid = rng.uniform(size=n) < 0.7
    want = np.asarray(jsort(*(jnp.asarray(a) for a in (depth, y, sort_y, layer, valid))))
    got = sprite_sort_order(*(torch.from_numpy(a) for a in (depth, y, sort_y, layer, valid))).numpy()
    np.testing.assert_array_equal(got, want)
