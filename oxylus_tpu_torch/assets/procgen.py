"""Procedural Sponza-class content generator (counterpart of
`oxylus_tpu/assets/procgen.py`, the BASELINE config-4 workload).

Config 4 is a large static meshlet scene of the Sponza class: hundreds of
unique meshes, ≥ 1M pre-LOD triangles, textured PBR materials, deep LOD chains
and heavy overdraw, the regime the engine's cull / LOD / visbuffer pipeline
exists for. The repo ships no binary assets, so the scene is generated
deterministically: an atrium of colonnades with arches, perimeter walls,
vases, rubble and alpha-masked banners, written as a standard GLB with
embedded PNG textures, then imported through the real asset path
(`assets/gltf.py` → `assets/bake.py`).

All generators are NumPy and seeded (PNG through PIL); for the same arguments
the GLB is byte-identical to the JAX module's, its "generator" string
included (`tests/test_torch_assets_atrium.py`).
"""

from __future__ import annotations

import io
import json
import struct

import numpy as np

__all__ = ["generate_atrium_glb", "atrium_summary"]


# ---------------------------------------------------------------------------
# mesh primitives (positions (V,3) f32, uvs (V,2) f32, indices (T*3,) u32)
# ---------------------------------------------------------------------------

def _vertex_normals(pos: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """Smooth per-vertex normals: area-weighted face-normal accumulation."""
    tri = idx.reshape(-1, 3)
    p0, p1, p2 = pos[tri[:, 0]], pos[tri[:, 1]], pos[tri[:, 2]]
    fn = np.cross(p1 - p0, p2 - p0)
    n = np.zeros_like(pos)
    for k in range(3):
        np.add.at(n, tri[:, k], fn)
    ln = np.linalg.norm(n, axis=1, keepdims=True)
    return (n / np.maximum(ln, 1e-12)).astype(np.float32)


def _grid_indices(rows: int, cols: int, wrap: bool = False) -> np.ndarray:
    """Triangulate a (rows+1)×(cols+1) vertex grid (cols wrap when `wrap`)."""
    c1 = cols if wrap else cols
    vcols = cols if wrap else cols + 1
    quads = []
    for r in range(rows):
        for c in range(c1):
            a = r * vcols + c
            b = r * vcols + (c + 1) % vcols
            d = (r + 1) * vcols + c
            e = (r + 1) * vcols + (c + 1) % vcols
            quads.append([a, d, b, b, d, e])
    return np.asarray(quads, np.uint32).reshape(-1)


def lathe(profile: np.ndarray, segments: int = 48, cap: bool = True):
    """Surface of revolution around Y. `profile` = (P, 2) rows of (y, radius),
    bottom → top. Columns, balusters, vases, bowls."""
    prof = np.asarray(profile, np.float32)
    p = len(prof)
    ang = np.linspace(0.0, 2 * np.pi, segments, endpoint=False)
    ca, sa = np.cos(ang), np.sin(ang)
    ys = np.repeat(prof[:, 0], segments)
    rs = np.repeat(prof[:, 1], segments)
    xs = rs * np.tile(ca, p)
    zs = rs * np.tile(sa, p)
    pos = np.stack([xs, ys, zs], axis=1).astype(np.float32)
    u = np.tile(ang / (2 * np.pi), p)
    v = np.repeat(np.linspace(0, 1, p), segments)
    uv = np.stack([u, v], axis=1).astype(np.float32)
    idx = _grid_indices(p - 1, segments, wrap=True)
    if cap:
        # center-point fans at both ends (vases/columns read as solid)
        extra_pos, extra_idx = [], []
        for end, ring0 in ((0, 0), (1, (p - 1) * segments)):
            ci = len(pos) + len(extra_pos)
            extra_pos.append([0.0, prof[-1 if end else 0, 0], 0.0])
            ring = np.arange(ring0, ring0 + segments, dtype=np.uint32)
            nxt = np.roll(ring, -1)
            tri = (
                np.stack([nxt, ring, np.full(segments, ci, np.uint32)], axis=1)
                if end
                else np.stack([ring, nxt, np.full(segments, ci, np.uint32)], axis=1)
            )
            extra_idx.append(tri.reshape(-1))
        pos = np.concatenate([pos, np.asarray(extra_pos, np.float32)])
        uv = np.concatenate([uv, np.array([[0.5, 0.0], [0.5, 1.0]], np.float32)])
        idx = np.concatenate([idx] + extra_idx)
    return pos, uv, idx.astype(np.uint32)


def displaced_sphere(rows: int, cols: int, rng: np.random.Generator,
                     amp: float = 0.35, octaves: int = 3):
    """Rock: UV sphere with multi-octave value-noise radial displacement."""
    lat = np.linspace(0, np.pi, rows + 1)
    lon = np.linspace(0, 2 * np.pi, cols, endpoint=False)
    la, lo = np.meshgrid(lat, lon, indexing="ij")
    disp = np.zeros_like(la)
    for o in range(octaves):
        g = rng.standard_normal((4 * 2**o + 1, 4 * 2**o + 1))
        gy = la / np.pi * (g.shape[0] - 1)
        gx = lo / (2 * np.pi) * (g.shape[1] - 1)
        y0, x0 = np.floor(gy).astype(int), np.floor(gx).astype(int)
        fy, fx = gy - y0, gx - x0
        y1 = np.minimum(y0 + 1, g.shape[0] - 1)
        x1 = np.minimum(x0 + 1, g.shape[1] - 1)
        v = (
            g[y0, x0] * (1 - fy) * (1 - fx) + g[y1, x0] * fy * (1 - fx)
            + g[y0, x1] * (1 - fy) * fx + g[y1, x1] * fy * fx
        )
        disp += v * (0.5**o)
    r = 1.0 + amp * disp / max(abs(disp).max(), 1e-9)
    x = r * np.sin(la) * np.cos(lo)
    y = r * np.cos(la)
    z = r * np.sin(la) * np.sin(lo)
    pos = np.stack([x, y, z], axis=-1).reshape(-1, 3).astype(np.float32)
    uv = np.stack([lo / (2 * np.pi), la / np.pi], axis=-1).reshape(-1, 2).astype(np.float32)
    idx = _grid_indices(rows, cols, wrap=True)
    # lat runs 0→π (y decreasing): the grid orientation winds inward — flip
    idx = idx.reshape(-1, 3)[:, [0, 2, 1]].reshape(-1).copy()
    return pos, uv, idx


def torus_arc(major: float, minor: float, arc: float, seg_u: int, seg_v: int):
    """Arch segment: torus swept over `arc` radians, axis Z (stands in XY)."""
    u = np.linspace(0.0, arc, seg_u + 1)
    v = np.linspace(0.0, 2 * np.pi, seg_v, endpoint=False)
    uu, vv = np.meshgrid(u, v, indexing="ij")
    cx = (major + minor * np.cos(vv)) * np.cos(uu)
    cy = (major + minor * np.cos(vv)) * np.sin(uu)
    cz = minor * np.sin(vv)
    pos = np.stack([cx, cy, cz], axis=-1).reshape(-1, 3).astype(np.float32)
    uv = np.stack([uu / max(arc, 1e-9), vv / (2 * np.pi)], axis=-1).reshape(-1, 2).astype(np.float32)
    idx = _grid_indices(seg_u, seg_v, wrap=True)
    return pos, uv, idx


def tess_box(w: float, h: float, d: float, nsub: int, rng=None, jitter: float = 0.0):
    """Subdivided box (wall/floor blocks); optional surface jitter for rough stone."""
    half = np.array([w, h, d], np.float32) / 2
    faces = []
    uvs = []
    idxs = []
    base = 0
    lin = np.linspace(-1, 1, nsub + 1)
    for axis in range(3):
        for sign in (-1.0, 1.0):
            a, b = [k for k in range(3) if k != axis]
            # outward winding: grid triangles have normal ∝ (±ê_a) × ê_b, and
            # ê_a × ê_b = ±ê_axis depending on whether (a, b) is a cyclic pair
            # (x:(1,2)→+, y:(0,2)→−, z:(0,1)→+) — mirror ga so the product
            # points along sign·ê_axis
            parity = 1.0 if (a, b) in ((1, 2), (0, 1)) else -1.0
            ga, gb = np.meshgrid(lin, lin, indexing="ij")
            p = np.zeros((nsub + 1, nsub + 1, 3), np.float32)
            p[..., axis] = sign
            p[..., a] = ga * (1 if sign * parity > 0 else -1)
            p[..., b] = gb
            p = p * half[None, None, :]
            if rng is not None and jitter > 0:
                p += rng.uniform(-jitter, jitter, p.shape).astype(np.float32)
            faces.append(p.reshape(-1, 3))
            uvs.append(
                np.stack([(ga + 1) / 2, (gb + 1) / 2], axis=-1).reshape(-1, 2).astype(np.float32)
            )
            idxs.append(_grid_indices(nsub, nsub) + base)
            base += (nsub + 1) ** 2
    return (
        np.concatenate(faces),
        np.concatenate(uvs),
        np.concatenate(idxs).astype(np.uint32),
    )


# ---------------------------------------------------------------------------
# unique mesh library
# ---------------------------------------------------------------------------

def _column(rng):
    """Fluted classical column: shaft + entasis + capital/base rings."""
    n = 40
    y = np.linspace(0, 1, n)
    r = 0.28 * (1.0 - 0.12 * y)  # entasis taper
    r = r * (1.0 + 0.02 * np.sin(y * rng.integers(6, 14) * np.pi))
    prof = [(0.0, 0.42), (0.04, 0.42), (0.06, 0.34)]  # base plinth
    prof += [(0.08 + 3.1 * yy, rr) for yy, rr in zip(y, r)]
    prof += [(3.24, 0.34), (3.27, 0.44), (3.32, 0.46)]  # capital
    return lathe(np.asarray(prof), segments=rng.integers(56, 84))


def _vase(rng):
    n = 24
    y = np.linspace(0, 1, n)
    knots = rng.uniform(0.08, 0.5, 5)
    r = np.interp(y, np.linspace(0, 1, 5), knots)
    r = r * (1.0 + 0.05 * np.sin(y * rng.integers(4, 20)))
    h = rng.uniform(0.5, 1.4)
    prof = np.stack([y * h, np.maximum(r, 0.02)], axis=1)
    return lathe(prof, segments=rng.integers(48, 72))


def _rock(rng):
    return displaced_sphere(
        rng.integers(56, 80), rng.integers(64, 96), rng,
        amp=rng.uniform(0.15, 0.45), octaves=3,
    )


def _arch(rng):
    return torus_arc(
        major=rng.uniform(1.6, 2.4), minor=rng.uniform(0.12, 0.22),
        arc=np.pi, seg_u=rng.integers(64, 96), seg_v=rng.integers(32, 48),
    )


def _block(rng):
    return tess_box(
        rng.uniform(1.5, 4.0), rng.uniform(0.8, 3.0), rng.uniform(0.4, 1.0),
        nsub=int(rng.integers(32, 48)), rng=rng, jitter=0.01,
    )


def build_mesh_library(rng, n_meshes: int = 120):
    """`n_meshes` unique meshes across 5 architectural families."""
    makers = [_column, _vase, _rock, _arch, _block]
    meshes = []
    for i in range(n_meshes):
        pos, uv, idx = makers[i % len(makers)](rng)
        meshes.append((pos, _vertex_normals(pos, idx), uv, idx))
    return meshes


# ---------------------------------------------------------------------------
# textures / materials
# ---------------------------------------------------------------------------

def _height_field(rng, kind: int, size: int = 64) -> np.ndarray:
    """Shared procedural height pattern in [0, 1] — albedo shading, the
    normal map, and the cavity/roughness maps all derive from it so the
    material reads as one coherent surface."""
    yy, xx = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    if kind == 0:  # checker (marble floor)
        m = ((xx // 8 + yy // 8) % 2).astype(np.float32) * 0.35 + 0.6
    elif kind == 1:  # brick courses
        row = yy // 8
        offs = (row % 2) * 8
        mortar = ((yy % 8 == 0) | (((xx + offs) % 16) == 0)).astype(np.float32)
        m = 0.85 - 0.45 * mortar
    elif kind == 2:  # banded stone
        m = 0.7 + 0.25 * np.sin(yy / size * rng.integers(4, 12) * np.pi)
    else:  # value noise (rock / plaster)
        g = rng.standard_normal((9, 9))
        gy = yy / (size - 1) * 8
        gx = xx / (size - 1) * 8
        y0, x0 = np.floor(gy).astype(int), np.floor(gx).astype(int)
        fy, fx = gy - y0, gx - x0
        y1, x1 = np.minimum(y0 + 1, 8), np.minimum(x0 + 1, 8)
        v = (
            g[y0, x0] * (1 - fy) * (1 - fx) + g[y1, x0] * fy * (1 - fx)
            + g[y0, x1] * (1 - fy) * fx + g[y1, x1] * fy * fx
        )
        m = 0.7 + 0.2 * v / max(abs(v).max(), 1e-9)
    return np.clip(m, 0.0, 1.0).astype(np.float32)


def _texture(rng, kind: int, size: int = 64, mask: bool = False) -> np.ndarray:
    """Albedo RGBA. `mask=True` carves a lattice cutout into the alpha channel
    (banner/screen materials — the alpha-masked raster pass)."""
    m = _height_field(rng, kind, size)
    base = rng.uniform(0.25, 0.9, 3)
    rgb = np.clip(m[..., None] * base[None, None, :] * 255.0, 0, 255).astype(np.uint8)
    if mask:
        yy, xx = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
        holes = ((xx % 16 < 9) & (yy % 16 < 9)).astype(np.uint8)  # lattice
        alpha = np.where(holes > 0, 0, 255).astype(np.uint8)[..., None]
    else:
        alpha = np.full((size, size, 1), 255, np.uint8)
    return np.concatenate([rgb, alpha], axis=-1)


def _normal_map(rng, kind: int, size: int = 64, strength: float = 2.0) -> np.ndarray:
    """Tangent-space normal map from the height pattern's gradient (the
    standard bump→normal derivation; +Y-up RGBA8 encoding)."""
    h = _height_field(rng, kind, size)
    dhdx = np.roll(h, -1, axis=1) - np.roll(h, 1, axis=1)
    dhdy = np.roll(h, -1, axis=0) - np.roll(h, 1, axis=0)
    n = np.stack([-dhdx * strength, -dhdy * strength, np.ones_like(h)], axis=-1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    rgb = np.clip((n * 0.5 + 0.5) * 255.0, 0, 255).astype(np.uint8)
    return np.concatenate([rgb, np.full((size, size, 1), 255, np.uint8)], axis=-1)


def _mr_map(rng, kind: int, metal: float, rough: float, size: int = 64) -> np.ndarray:
    """glTF metallic-roughness map: R = occlusion (cavity from the height
    field — shared-rect occlusion, the glTF packing), G = roughness
    variation around the factor, B = metallic patches."""
    h = _height_field(rng, kind, size)
    occ = np.clip(0.6 + 0.4 * h, 0.0, 1.0)
    g = np.clip(rough * (0.75 + 0.5 * (1.0 - h)), 0.04, 1.0)
    b = np.clip(metal * (h > 0.45), 0.0, 1.0) if metal > 0 else np.zeros_like(h)
    rgba = np.stack([occ, g, b, np.ones_like(h)], axis=-1)
    return np.clip(rgba * 255.0, 0, 255).astype(np.uint8)


def _emissive_map(rng, size: int = 64) -> np.ndarray:
    """Window/rune glow pattern for emissive materials."""
    yy, xx = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    glow = (((xx % 20) < 8) & ((yy % 24) < 12)).astype(np.float32)
    tint = rng.uniform(0.6, 1.0, 3)
    rgb = np.clip(glow[..., None] * tint[None, None, :] * 255.0, 0, 255).astype(np.uint8)
    return np.concatenate([rgb, np.full((size, size, 1), 255, np.uint8)], axis=-1)


def _png_bytes(img: np.ndarray) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img, "RGBA").save(buf, format="PNG")
    return buf.getvalue()


# ---------------------------------------------------------------------------
# scene layout → GLB
# ---------------------------------------------------------------------------

def _layout_atrium(rng, n_meshes: int):
    """Node list: (mesh_index, translation, rotation_y, scale). An atrium court:
    colonnade rows with arches, perimeter walls, scattered vases + rubble."""
    fam = lambda k: [i for i in range(n_meshes) if i % 5 == k]
    cols, vases, rocks, arches, blocks = (fam(k) for k in range(5))
    nodes = []
    # two colonnade rows along x at z = ±6, plus arches spanning column pairs
    for i in range(14):
        x = (i - 6.5) * 3.4
        for z in (-6.0, 6.0):
            nodes.append((int(rng.choice(cols)), (x, 0.0, z), rng.uniform(0, 6.28), 1.0))
        nodes.append((int(rng.choice(arches)), (x, 3.35, -6.0), 0.0, 0.85))
        nodes.append((int(rng.choice(arches)), (x, 3.35, 6.0), 0.0, 0.85))
    # perimeter walls (two storeys)
    for i in range(16):
        x = (i - 7.5) * 3.2
        for z, ry in ((-10.5, 0.0), (10.5, 0.0)):
            for y in (1.2, 3.6):
                nodes.append((int(rng.choice(blocks)), (x, y, z), ry, 1.0))
    for i in range(7):
        z = (i - 3.0) * 3.2
        for x in (-24.5, 24.5):
            for y in (1.2, 3.6):
                nodes.append((int(rng.choice(blocks)), (x, y, z), np.pi / 2, 1.0))
    # scattered vases and rubble in the court
    for _ in range(80):
        nodes.append((
            int(rng.choice(vases)),
            (rng.uniform(-20, 20), 0.0, rng.uniform(-5, 5)),
            rng.uniform(0, 6.28), rng.uniform(0.6, 1.6),
        ))
    for _ in range(70):
        nodes.append((
            int(rng.choice(rocks)),
            (rng.uniform(-22, 22), rng.uniform(0.1, 0.5), rng.uniform(-9, 9)),
            rng.uniform(0, 6.28), rng.uniform(0.25, 0.9),
        ))
    return nodes


def generate_atrium_glb(path, n_meshes: int = 120, n_materials: int = 24, seed: int = 42):
    """Write the Sponza-class GLB. Returns a summary dict (meshes, triangles...)."""
    rng = np.random.default_rng(seed)
    meshes = build_mesh_library(rng, n_meshes)
    # floor slab as one more unique mesh
    meshes.append(tuple_with_normals(tess_box(52.0, 0.4, 24.0, nsub=48)))
    nodes = _layout_atrium(rng, n_meshes)
    nodes.append((len(meshes) - 1, (0.0, -0.2, 0.0), 0.0, 1.0))
    # hanging banners between colonnade pairs: thin tessellated sheets bound
    # to the ALPHA-MASKED lattice materials (real Sponza's banners/foliage —
    # the masked raster pass must appear in the official frame)
    banner_mesh = len(meshes)
    meshes.append(tuple_with_normals(tess_box(2.6, 1.6, 0.04, nsub=10)))
    for i in range(8):
        x = (i - 3.5) * 6.8
        nodes.append((banner_mesh, (x, 2.4, float(rng.uniform(-5.4, 5.4))),
                      float(rng.uniform(0, 6.28)), 1.0))

    mat_colors = rng.uniform(0.4, 1.0, (n_materials, 3))
    mat_rough = rng.uniform(0.25, 0.95, n_materials)
    mat_metal = np.where(rng.uniform(size=n_materials) < 0.15, 0.9, 0.0)
    # material roles: every material carries albedo+normal+MR maps; a few are
    # emissive (lit windows); two are alpha-masked lattices (banners)
    masked_ids = [n_materials - 1, n_materials - 2]
    emissive_ids = [3, 11, 19][: max(1, n_materials // 8)]
    albedo_tex = [
        _texture(rng, k % 4, mask=(k in masked_ids)) for k in range(n_materials)
    ]
    normal_tex = [_normal_map(rng, k % 4) for k in range(n_materials)]
    mr_tex = [
        _mr_map(rng, k % 4, float(mat_metal[k]), float(mat_rough[k]))
        for k in range(n_materials)
    ]
    emissive_tex = {k: _emissive_map(rng) for k in emissive_ids}
    mesh_mat = [int(rng.integers(0, n_materials - 2)) for _ in meshes]
    mesh_mat[banner_mesh] = masked_ids[0]

    # ---- build the GLB document ------------------------------------------
    bin_parts: list[bytes] = []
    buffer_views = []
    accessors = []

    def _pad4(b: bytes) -> bytes:
        return b + b"\x00" * ((4 - len(b) % 4) % 4)

    def add_view(data: bytes, target=None):
        off = sum(len(p) for p in bin_parts)
        bin_parts.append(_pad4(data))
        bv = {"buffer": 0, "byteOffset": off, "byteLength": len(data)}
        if target:
            bv["target"] = target
        buffer_views.append(bv)
        return len(buffer_views) - 1

    def add_accessor(arr: np.ndarray, ctype: int, atype: str, target: int):
        bv = add_view(arr.tobytes(), target)
        acc = {
            "bufferView": bv, "componentType": ctype,
            "count": len(arr), "type": atype,
        }
        if atype == "VEC3":
            acc["min"] = [float(v) for v in arr.min(axis=0)]
            acc["max"] = [float(v) for v in arr.max(axis=0)]
        accessors.append(acc)
        return len(accessors) - 1

    gltf_meshes = []
    tris = 0
    for mi, (pos, nrm, uv, idx) in enumerate(meshes):
        ap = add_accessor(pos.astype(np.float32), 5126, "VEC3", 34962)
        an = add_accessor(nrm.astype(np.float32), 5126, "VEC3", 34962)
        at = add_accessor(uv.astype(np.float32), 5126, "VEC2", 34962)
        ai_view = add_view(idx.astype(np.uint32).tobytes(), 34963)
        accessors.append({
            "bufferView": ai_view, "componentType": 5125,
            "count": int(len(idx)), "type": "SCALAR",
        })
        ai = len(accessors) - 1
        gltf_meshes.append({
            "primitives": [{
                "attributes": {"POSITION": ap, "NORMAL": an, "TEXCOORD_0": at},
                "indices": ai, "material": mesh_mat[mi],
            }]
        })
        tris += len(idx) // 3

    images = []
    gltf_textures = []

    def add_texture(img: np.ndarray) -> int:
        bv = add_view(_png_bytes(img))
        images.append({"bufferView": bv, "mimeType": "image/png"})
        gltf_textures.append({"source": len(images) - 1})
        return len(gltf_textures) - 1

    alb_idx = [add_texture(t) for t in albedo_tex]
    nrm_idx = [add_texture(t) for t in normal_tex]
    mr_idx = [add_texture(t) for t in mr_tex]
    emi_idx = {k: add_texture(t) for k, t in emissive_tex.items()}

    materials = []
    for k in range(n_materials):
        m = {
            "name": f"mat_{k}",
            "pbrMetallicRoughness": {
                "baseColorFactor": [*[float(c) for c in mat_colors[k]], 1.0],
                "metallicFactor": float(mat_metal[k]),
                "roughnessFactor": float(mat_rough[k]),
                "baseColorTexture": {"index": alb_idx[k]},
                "metallicRoughnessTexture": {"index": mr_idx[k]},
            },
            "normalTexture": {"index": nrm_idx[k]},
            # occlusion shares the MR image's R channel (the glTF packing)
            "occlusionTexture": {"index": mr_idx[k]},
        }
        if k in emi_idx:
            m["emissiveTexture"] = {"index": emi_idx[k]}
            m["emissiveFactor"] = [2.5, 2.2, 1.6]
        if k in masked_ids:
            m["alphaMode"] = "MASK"
            m["alphaCutoff"] = 0.5
        materials.append(m)

    gltf_nodes = []
    for mi, t, ry, s in nodes:
        gltf_nodes.append({
            "mesh": mi,
            "translation": [float(v) for v in t],
            "rotation": [0.0, float(np.sin(ry / 2)), 0.0, float(np.cos(ry / 2))],
            "scale": [float(s)] * 3,
        })

    doc = {
        "asset": {"version": "2.0", "generator": "oxylus_tpu.procgen"},
        "scene": 0,
        "scenes": [{"nodes": list(range(len(gltf_nodes)))}],
        "nodes": gltf_nodes,
        "meshes": gltf_meshes,
        "materials": materials,
        "textures": gltf_textures,
        "images": images,
        "accessors": accessors,
        "bufferViews": buffer_views,
        "buffers": [{"byteLength": sum(len(p) for p in bin_parts)}],
    }

    bin_blob = b"".join(bin_parts)
    json_blob = json.dumps(doc).encode()
    json_blob += b" " * ((4 - len(json_blob) % 4) % 4)  # GLB: JSON chunk pads with 0x20
    total = 12 + 8 + len(json_blob) + 8 + len(bin_blob)
    with open(path, "wb") as f:
        f.write(struct.pack("<III", 0x46546C67, 2, total))
        f.write(struct.pack("<II", len(json_blob), 0x4E4F534A))
        f.write(json_blob)
        f.write(struct.pack("<II", len(bin_blob), 0x004E4942))
        f.write(bin_blob)

    return {
        "meshes": len(meshes), "instances": len(nodes),
        "triangles": tris, "materials": n_materials,
        "instance_triangles": sum(len(meshes[mi][3]) // 3 for mi, *_ in nodes),
    }


def tuple_with_normals(puv):
    pos, uv, idx = puv
    return (pos, _vertex_normals(pos, idx), uv, idx)


def atrium_summary(path) -> dict:
    """Cheap summary of an existing generated GLB (mesh/tri counts)."""
    from .gltf import load_gltf

    model = load_gltf(path, load_images=False)
    tris = sum(len(p[0].indices) // 3 for p in model.meshes)
    return {"meshes": len(model.meshes), "triangles": tris}
