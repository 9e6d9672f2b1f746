"""Host-side physics world construction from scene components (counterpart of
`oxylus_tpu/physics/build.py`).

Mirrors `Scene::physics_init` (`Scene.cpp:1040-1072`, body construction
`:1717-1850`): at runtime_start every entity carrying collider components gets a
body slot. The construction runs in NumPy on the host; tensors are made once,
at the boundary, on the requested device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .state import (
    BODY_DYNAMIC,
    BODY_FIELDS,
    BODY_STATIC,
    SHAPE_BOX,
    SHAPE_CAPSULE,
    SHAPE_CYLINDER,
    PhysicsState,
    capsule_inertia,
    cylinder_inertia,
    empty_physics_state,
)

_COLLIDER_ORDER = (
    "BoxColliderComponent",
    "SphereColliderComponent",
    "CapsuleColliderComponent",
    "TaperedCapsuleColliderComponent",
    "CylinderColliderComponent",
)


def build_physics_state(scene, device: torch.device | str | None = None) -> PhysicsState:
    """The scene's bodies on `device` (the card unless the CPU is asked for),
    built on the host."""
    device = resolve_device(device)
    spec = scene.spec
    ps = empty_physics_state(spec.max_bodies, "cpu")
    host = {name: getattr(ps, name).numpy().copy() for name in BODY_FIELDS}

    slot = 0
    tc = scene._comp_data["TransformComponent"]
    rb_mask = scene._comp_mask["RigidBodyComponent"]
    rb = scene._comp_data["RigidBodyComponent"]
    cc_mask = scene._comp_mask["CharacterControllerComponent"]
    cc = scene._comp_data["CharacterControllerComponent"]

    n = scene._alive.shape[0]
    for i in range(n):
        if not scene._alive[i]:
            continue

        # character controllers get a dedicated upright dynamic capsule
        # (`Scene.cpp:1852-1886` creates a JPH::Character; here: locked-rotation body)
        if cc_mask[i]:
            if slot >= spec.max_bodies:
                break
            h = float(cc["character_height_standing"][i])
            r = float(cc["character_radius_standing"][i])
            mass = 70.0
            host["active"][slot] = True
            host["entity"][slot] = i
            host["body_type"][slot] = BODY_DYNAMIC
            host["shape_type"][slot] = SHAPE_CAPSULE
            host["pos"][slot] = tc["position"][i]
            host["quat"][slot] = [0.0, 0.0, 0.0, 1.0]
            host["prev_pos"][slot] = tc["position"][i]
            host["radius"][slot] = r
            host["radius2"][slot] = r
            host["half_length"][slot] = max(h / 2.0 - r, 0.01)
            host["inv_mass"][slot] = 1.0 / mass
            host["inv_inertia"][slot] = 0.0  # rotation locked
            host["dof_mask_ang"][slot] = 0.0
            host["friction"][slot] = 0.0  # movement handled by the controller
            host["is_character"][slot] = True
            slot += 1
            continue

        colliders = [c for c in _COLLIDER_ORDER if scene._comp_mask[c][i]]
        if not colliders:
            continue
        if slot + len(colliders) > spec.max_bodies:
            break

        has_rb = bool(rb_mask[i])
        btype = int(rb["type"][i]) if has_rb else BODY_STATIC
        mass = float(rb["mass"][i]) if has_rb else 0.0

        def shape_of(cname, col):
            """(shape_type, half_extent|None, radius, radius2, half_length,
            inertia_unit_mass) — mirrors the Jolt shapes the reference builds at
            `Scene.cpp:1717-1850` (Box/Sphere/Capsule/TaperedCapsule/Cylinder).
            Inertias are computed in NumPy: one tensor op per body would
            dominate scene-build time at 10k bodies."""
            if cname == "BoxColliderComponent":
                size = np.asarray(col["size"], np.float32)
                hx2, hy2, hz2 = (size ** 2).tolist()
                inert = np.array([hy2 + hz2, hx2 + hz2, hx2 + hy2], np.float32) / 3.0
                return SHAPE_BOX, size, 0.0, 0.0, 0.0, inert
            if cname == "SphereColliderComponent":
                r, r2, hl = float(col["radius"]), float(col["radius"]), 0.0
                st = SHAPE_CAPSULE
            elif cname == "TaperedCapsuleColliderComponent":
                # convex hull of bottom/top end spheres: segment bottom→top
                r = float(col["bottom_radius"])
                r2 = float(col["top_radius"])
                hl = float(col["height"]) / 2.0
                st = SHAPE_CAPSULE
            elif cname == "CylinderColliderComponent":
                r, r2, hl = float(col["radius"]), float(col["radius"]), float(col["height"]) / 2.0
                st = SHAPE_CYLINDER
            else:  # capsule
                r, r2, hl = float(col["radius"]), float(col["radius"]), float(col["height"]) / 2.0
                st = SHAPE_CAPSULE
            if st == SHAPE_CYLINDER:
                inert = cylinder_inertia(
                    np.float32(1.0), np.float32(r), np.float32(hl)
                )
            else:
                r_mean = 0.5 * (r + r2)
                inert = capsule_inertia(
                    np.float32(1.0), np.float32(r_mean), np.float32(hl)
                )
            return st, None, r, r2, hl, np.asarray(inert)

        # mass distribution over sub-colliders ∝ rough shape volume (the reference's
        # Jolt StaticCompoundShape computes exact composite mass properties;
        # volume-weighted parallel-axis is the fixed-shape equivalent here)
        cols = [{k: v[i] for k, v in scene._comp_data[c].items()} for c in colliders]
        shapes = [shape_of(c, col) for c, col in zip(colliders, cols)]
        vols = []
        for st, he, r, r2, hl, _ in shapes:
            if st == SHAPE_BOX:
                vols.append(max(8.0 * he[0] * he[1] * he[2], 1e-9))
            elif st == SHAPE_CYLINDER:
                vols.append(max(3.14 * r * r * 2 * hl, 1e-9))
            else:
                rm = 0.5 * (r + r2)
                vols.append(max(4.19 * rm**3 + 3.14 * rm * rm * 2 * hl, 1e-9))
        vtot = sum(vols)

        root = slot
        inertia = np.zeros(3, np.float64)
        for j, (cname, col, (st, he, r, r2, hl, unit_inertia)) in enumerate(
            zip(colliders, cols, shapes)
        ):
            host["active"][slot] = True
            # proxies share the root's entity pose but must not write the entity
            # transform (sync scatter is unique per entity) → entity = -1 for them
            host["entity"][slot] = i if j == 0 else -1
            host["parent"][slot] = -1 if j == 0 else root
            host["pos"][slot] = tc["position"][i]
            host["quat"][slot] = tc["rotation"][i]
            host["prev_pos"][slot] = tc["position"][i]
            host["prev_quat"][slot] = tc["rotation"][i]
            host["offset"][slot] = col.get("offset", np.zeros(3))
            host["shape_type"][slot] = st
            if st == SHAPE_BOX:
                host["half_extent"][slot] = he
            else:
                host["radius"][slot] = r
                host["radius2"][slot] = r2
                host["half_length"][slot] = hl
            host["body_type"][slot] = btype
            # per-collider material wins, like the reference's body construction
            # (`Scene.cpp:1717-1850` builds Jolt shapes with collider materials)
            host["friction"][slot] = float(col.get("friction", 0.5))
            host["restitution"][slot] = float(col.get("restitution", 0.0))

            if has_rb and btype == BODY_DYNAMIC and mass > 0.0:
                m_j = mass * vols[j] / vtot
                d = np.asarray(col.get("offset", np.zeros(3)), np.float64)
                # parallel-axis contribution to the composite diagonal inertia
                d2 = d * d
                inertia += m_j * unit_inertia + m_j * np.array(
                    [d2[1] + d2[2], d2[0] + d2[2], d2[0] + d2[1]]
                )
            slot += 1

        if has_rb:
            if btype == BODY_DYNAMIC and mass > 0.0:
                host["inv_mass"][root] = 1.0 / mass
                host["inv_inertia"][root] = 1.0 / np.maximum(inertia, 1e-12)
            host["gravity_factor"][root] = float(rb["gravity_factor"][i])
            host["linear_drag"][root] = float(rb["linear_drag"][i])
            host["angular_drag"][root] = float(rb["angular_drag"][i])
            host["is_sensor"][root] = bool(rb["is_sensor"][i])
            dofs = int(rb["allowed_dofs"][i])
            host["dof_mask_lin"][root] = [(dofs >> k) & 1 for k in range(3)]
            host["dof_mask_ang"][root] = [(dofs >> k) & 1 for k in range(3, 6)]

    # ---- static mesh colliders (Jolt MeshShape, `Scene.cpp:1717-1850`) -------
    # All MeshColliderComponent entities bake into ONE world-space triangle soup
    # + a uniform XZ grid of fixed-capacity triangle buckets. One extra static
    # body slot carries the (first) mesh collider's material.
    mesh_fields = {}
    mc_mask = scene._comp_mask.get("MeshColliderComponent")
    if mc_mask is not None and mc_mask.any() and getattr(scene, "_collision_meshes", None):
        from ..utils import math3d as _m3

        mesh_comp = scene._comp_data["MeshComponent"]
        mc = scene._comp_data["MeshColliderComponent"]
        tris = []
        mat = None
        for i in range(n):
            if not (scene._alive[i] and mc_mask[i]):
                continue
            mi = int(mesh_comp["mesh_index"][i]) if scene._comp_mask["MeshComponent"][i] else 0
            src = scene._collision_meshes.get(mi)
            if src is None:
                continue
            pos_l, idx = np.asarray(src[0], np.float32), np.asarray(src[1], np.int64)
            rot = _m3.quat_to_mat3(torch.from_numpy(np.asarray(tc["rotation"][i][None]))).numpy()[0]
            scale = np.asarray(tc["scale"][i], np.float32)
            off = np.asarray(mc["offset"][i], np.float32)
            world_v = (pos_l * scale) @ rot.T + tc["position"][i] + off
            tris.append(world_v[idx.reshape(-1, 3)])
            if mat is None:
                mat = (float(mc["friction"][i]), float(mc["restitution"][i]))
        if tris and slot < spec.max_bodies:
            tri = np.concatenate(tris, axis=0)  # (T, 3, 3)
            # material body slot (static; excluded from broadphase by shape code)
            host["active"][slot] = True
            host["entity"][slot] = -1
            host["body_type"][slot] = BODY_STATIC
            host["shape_type"][slot] = 3  # SHAPE_MESH
            host["friction"][slot] = mat[0]
            host["restitution"][slot] = mat[1]
            mesh_slot = slot
            slot += 1

            # uniform XZ grid: 32×32 cells over the soup's AABB, each bucket
            # lists triangles whose XZ AABB (±margin) overlaps the cell
            gx = gz = 32
            k_tri = 32
            margin = 1.0  # covers body radius + one substep of travel
            lo = tri.min(axis=(0, 1))
            hi = tri.max(axis=(0, 1))
            cell = float(max((hi[0] - lo[0]) / gx, (hi[2] - lo[2]) / gz, 1e-3))
            grid = np.full((gx * gz, k_tri), -1, np.int32)
            counts = np.zeros(gx * gz, np.int32)
            txmin = tri[:, :, 0].min(axis=1) - margin
            txmax = tri[:, :, 0].max(axis=1) + margin
            tzmin = tri[:, :, 2].min(axis=1) - margin
            tzmax = tri[:, :, 2].max(axis=1) + margin
            for t in range(tri.shape[0]):
                cx0 = max(int((txmin[t] - lo[0]) // cell), 0)
                cx1 = min(int((txmax[t] - lo[0]) // cell), gx - 1)
                cz0 = max(int((tzmin[t] - lo[2]) // cell), 0)
                cz1 = min(int((tzmax[t] - lo[2]) // cell), gz - 1)
                for cz_ in range(cz0, cz1 + 1):
                    for cx_ in range(cx0, cx1 + 1):
                        c = cz_ * gx + cx_
                        if counts[c] < k_tri:
                            grid[c, counts[c]] = t
                            counts[c] += 1
            mesh_fields = dict(
                mesh_tri=torch.from_numpy(np.ascontiguousarray(tri)).to(device),
                mesh_grid=torch.from_numpy(grid).to(device),
                mesh_grid_meta=torch.tensor(
                    [lo[0], lo[2], cell, float(gx), float(gz)], dtype=torch.float32, device=device
                ),
                mesh_body=torch.tensor(mesh_slot, dtype=torch.int32, device=device),
            )

    return PhysicsState(
        accumulator=torch.zeros((), dtype=torch.float32, device=device),
        has_proxies=bool((host["parent"] >= 0).any()),
        **{k: torch.from_numpy(v).to(device) for k, v in host.items()},
        **mesh_fields,
    )
