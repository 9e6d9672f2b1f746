"""Component schema mirroring the reference engine's ECS components.

A copy of `oxylus_tpu/scene/components.py`: that module is pure NumPy, but
importing it imports JAX through `oxylus_tpu/__init__.py`, and the port must run
where JAX is absent. `tests/test_torch_state.py` asserts that the two registries
stay identical (names, fields, dtypes, defaults).

Source of truth in the reference: `Oxylus/include/Scene/Components.hpp:11-435`
and the reflection registration `Oxylus/src/Scene/Components.cpp:56-310`
(field order there is the serialization order). Components are registered under the flecs
module "Core", so their serialized paths are `Core.<Name>` (`Components.cpp:14`).

Here each component is a declarative `ComponentDef`: a list of typed fields with defaults.
This single table drives
- SoA pytree array allocation (`oxylus_tpu.scene.state`),
- JSON scene serialization compatible with reference scenes (`oxylus_tpu.scene.serialize`),
- snapshot hashing for delta replication (`oxylus_tpu.scene.snapshot`),
- the Lua/pythonic component access API.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Any

import numpy as np


class FieldKind(enum.Enum):
    BOOL = "bool"
    I32 = "i32"
    U16 = "u16"
    U32 = "u32"
    U64 = "u64"
    F32 = "f32"
    VEC2 = "vec2"
    VEC3 = "vec3"
    VEC4 = "vec4"
    QUAT = "quat"
    UUID = "uuid"  # serialized as string; stored SoA as 2×u64
    ENUM = "enum"  # i32 storage, named constants in JSON
    STRING = "str"  # host-side only


_KIND_SHAPE = {
    FieldKind.BOOL: (),
    FieldKind.I32: (),
    FieldKind.U16: (),
    FieldKind.U32: (),
    FieldKind.U64: (),
    FieldKind.F32: (),
    FieldKind.VEC2: (2,),
    FieldKind.VEC3: (3,),
    FieldKind.VEC4: (4,),
    FieldKind.QUAT: (4,),
    FieldKind.UUID: (2,),
    FieldKind.ENUM: (),
}

_KIND_DTYPE = {
    FieldKind.BOOL: np.bool_,
    FieldKind.I32: np.int32,
    FieldKind.U16: np.uint32,  # widened: TPU has no u16 lanes worth using here
    FieldKind.U32: np.uint32,
    FieldKind.U64: np.uint64,
    FieldKind.F32: np.float32,
    FieldKind.VEC2: np.float32,
    FieldKind.VEC3: np.float32,
    FieldKind.VEC4: np.float32,
    FieldKind.QUAT: np.float32,
    FieldKind.UUID: np.uint64,
    FieldKind.ENUM: np.int32,
}


@dataclasses.dataclass(frozen=True)
class Field:
    name: str
    kind: FieldKind
    default: Any = None
    enum_values: tuple[str, ...] = ()  # for ENUM: index -> name

    @property
    def shape(self) -> tuple[int, ...]:
        return _KIND_SHAPE[self.kind]

    @property
    def dtype(self):
        return _KIND_DTYPE[self.kind]

    def default_array(self) -> np.ndarray:
        d = self.default
        if self.kind == FieldKind.QUAT and d is None:
            d = (0.0, 0.0, 0.0, 1.0)
        if d is None:
            d = 0
        if self.kind == FieldKind.UUID:
            if isinstance(d, str):
                from ..core.uuid import uuid_to_u64_pair

                d = uuid_to_u64_pair(d)
            elif not d:
                d = (0, 0)
        arr = np.zeros(self.shape, self.dtype)
        arr[...] = np.asarray(d)
        return arr


@dataclasses.dataclass(frozen=True)
class ComponentDef:
    name: str  # bare name, e.g. "TransformComponent"
    fields: tuple[Field, ...]
    module: str = "Core"  # flecs module scope
    tag: bool = False  # tag components have no data (Hidden, Networked)
    networked: bool = False  # reference marks Transform/Sprite with Networked trait

    @property
    def path(self) -> str:
        """Serialized flecs path, e.g. `Core.TransformComponent`."""
        return f"{self.module}.{self.name}"

    def field(self, name: str) -> Field:
        for f in self.fields:
            if f.name == name:
                return f
        raise KeyError(f"{self.name} has no field {name}")


def _f(name, kind, default=None, enum_values=()):
    return Field(name, kind, default, tuple(enum_values))


_DEG360 = math.radians(360.0)

# Enum constant tables (names as flecs meta writes them,
# `Components.cpp:51-54` binds these enums under short names).
CAMERA_PROJECTION = ("Perspective", "Orthographic")
LIGHT_TYPE = ("Directional", "Spot", "Point")
RIGIDBODY_TYPE = ("Static", "Kinematic", "Dynamic")
TONEMAP_TYPE = ("None", "ACES", "AgX", "GT7")


def _collider_tail():
    return (
        _f("density", FieldKind.F32, 1.0),
        _f("friction", FieldKind.F32, 0.5),
        _f("restitution", FieldKind.F32, 0.0),
    )


COMPONENTS: tuple[ComponentDef, ...] = (
    ComponentDef(
        "TransformComponent",
        (
            _f("position", FieldKind.VEC3, (0.0, 0.0, 0.0)),
            _f("rotation", FieldKind.QUAT, (0.0, 0.0, 0.0, 1.0)),
            _f("scale", FieldKind.VEC3, (1.0, 1.0, 1.0)),
        ),
        networked=True,
    ),
    ComponentDef("LayerComponent", (_f("layer", FieldKind.U16, 1),)),
    ComponentDef(
        "MeshComponent",
        (
            _f("model_uuid", FieldKind.UUID),
            _f("mesh_index", FieldKind.U32, 0),
            _f("material_uuid", FieldKind.UUID),
            _f("cast_shadows", FieldKind.BOOL, True),
        ),
    ),
    ComponentDef(
        "SpriteComponent",
        (
            _f("layer", FieldKind.U32, 0),
            _f("sort_y", FieldKind.BOOL, True),
            _f("flip_x", FieldKind.BOOL, False),
            _f("material", FieldKind.UUID),
        ),
        networked=True,
    ),
    ComponentDef(
        "SpriteAnimationComponent",
        (
            _f("num_frames", FieldKind.U32, 0),
            _f("loop", FieldKind.BOOL, True),
            _f("inverted", FieldKind.BOOL, False),
            _f("fps", FieldKind.U32, 0),
            _f("columns", FieldKind.U32, 1),
            _f("frame_size", FieldKind.VEC2, (0.0, 0.0)),
            # runtime state (not in the reference's serialized field list but needed SoA)
            _f("current_time", FieldKind.F32, 0.0),
        ),
    ),
    ComponentDef(
        "CameraComponent",
        (
            _f("projection", FieldKind.ENUM, 0, CAMERA_PROJECTION),
            _f("fov", FieldKind.F32, 60.0),
            _f("aspect", FieldKind.F32, 16.0 / 9.0),
            _f("far_clip", FieldKind.F32, 1000.0),
            _f("near_clip", FieldKind.F32, 0.01),
            _f("tilt", FieldKind.F32, 0.0),
            _f("zoom", FieldKind.F32, 1.0),
            # runtime state
            _f("yaw", FieldKind.F32, -1.5708),
            _f("pitch", FieldKind.F32, 0.0),
        ),
    ),
    ComponentDef(
        "ParticleSystemComponent",
        (
            _f("material", FieldKind.UUID),
            _f("duration", FieldKind.F32, 3.0),
            _f("looping", FieldKind.BOOL, True),
            _f("start_delay", FieldKind.F32, 0.0),
            _f("start_lifetime", FieldKind.F32, 3.0),
            _f("start_velocity", FieldKind.VEC3, (0.0, 2.0, 0.0)),
            _f("start_color", FieldKind.VEC4, (1.0, 1.0, 1.0, 1.0)),
            _f("start_size", FieldKind.VEC4, (1.0, 1.0, 1.0, 1.0)),
            _f("start_rotation", FieldKind.QUAT, (0.0, 0.0, 0.0, 1.0)),
            _f("gravity_modifier", FieldKind.F32, 0.0),
            _f("simulation_speed", FieldKind.F32, 1.0),
            _f("play_on_awake", FieldKind.BOOL, True),
            _f("max_particles", FieldKind.U32, 100),
            _f("rate_over_time", FieldKind.U32, 10),
            _f("rate_over_distance", FieldKind.U32, 0),
            _f("burst_count", FieldKind.U32, 0),
            # runtime state for rate-over-distance emission (the reference keeps
            # last_spawned_position in the component too, Components.hpp:197)
            _f("last_spawned_position", FieldKind.VEC3, (0.0, 0.0, 0.0)),
            _f("position_start", FieldKind.VEC3, (-0.2, 0.0, 0.0)),
            _f("position_end", FieldKind.VEC3, (0.2, 0.0, 0.0)),
            _f("velocity_over_lifetime_enabled", FieldKind.BOOL, False),
            _f("velocity_over_lifetime_start", FieldKind.VEC3, (0.0, 0.0, 0.0)),
            _f("velocity_over_lifetime_end", FieldKind.VEC3, (0.0, 0.0, 0.0)),
            _f("force_over_lifetime_enabled", FieldKind.BOOL, False),
            _f("force_over_lifetime_start", FieldKind.VEC3, (0.0, 0.0, 0.0)),
            _f("force_over_lifetime_end", FieldKind.VEC3, (0.0, 0.0, 0.0)),
            _f("color_over_lifetime_enabled", FieldKind.BOOL, False),
            _f("color_over_lifetime_start", FieldKind.VEC4, (0.8, 0.2, 0.2, 0.0)),
            _f("color_over_lifetime_end", FieldKind.VEC4, (0.2, 0.2, 0.75, 1.0)),
            _f("color_by_speed_enabled", FieldKind.BOOL, False),
            _f("color_by_speed_start", FieldKind.VEC4, (0.8, 0.2, 0.2, 0.0)),
            _f("color_by_speed_end", FieldKind.VEC4, (0.2, 0.2, 0.75, 1.0)),
            _f("color_by_speed_min_speed", FieldKind.F32, 0.0),
            _f("color_by_speed_max_speed", FieldKind.F32, 1.0),
            _f("size_over_lifetime_enabled", FieldKind.BOOL, False),
            _f("size_over_lifetime_start", FieldKind.VEC3, (0.2, 0.2, 0.2)),
            _f("size_over_lifetime_end", FieldKind.VEC3, (1.0, 1.0, 1.0)),
            _f("size_by_speed_enabled", FieldKind.BOOL, False),
            _f("size_by_speed_start", FieldKind.VEC3, (0.2, 0.2, 0.2)),
            _f("size_by_speed_end", FieldKind.VEC3, (1.0, 1.0, 1.0)),
            _f("size_by_speed_min_speed", FieldKind.F32, 0.0),
            _f("size_by_speed_max_speed", FieldKind.F32, 1.0),
            _f("rotation_over_lifetime_enabled", FieldKind.BOOL, False),
            _f("rotation_over_lifetime_start", FieldKind.QUAT, (0.0, 0.0, 0.0, 1.0)),
            _f("rotation_over_lifetime_end", FieldKind.QUAT, (0.0, 0.0, 0.0, 1.0)),
            _f("rotation_by_speed_enabled", FieldKind.BOOL, False),
            _f("rotation_by_speed_start", FieldKind.QUAT, (0.0, 0.0, 0.0, 1.0)),
            _f("rotation_by_speed_end", FieldKind.QUAT, (0.0, 0.0, 0.0, 1.0)),
            _f("rotation_by_speed_min_speed", FieldKind.F32, 0.0),
            _f("rotation_by_speed_max_speed", FieldKind.F32, 1.0),
            # runtime state (Components.hpp:193 system_time)
            _f("system_time", FieldKind.F32, 0.0),
        ),
    ),
    ComponentDef(
        "ParticleComponent",
        (
            _f("color", FieldKind.VEC4, (0.0, 0.0, 0.0, 0.0)),
            _f("life_remaining", FieldKind.F32, 0.0),
        ),
    ),
    ComponentDef(
        "LightComponent",
        (
            _f("type", FieldKind.ENUM, 2, LIGHT_TYPE),  # default Point
            _f("color", FieldKind.VEC3, (0.02, 0.02, 0.02)),
            _f("intensity", FieldKind.F32, 10.0),
            _f("radius", FieldKind.F32, 1.0),
            _f("outer_cone_angle", FieldKind.F32, 70.0),
            _f("inner_cone_angle", FieldKind.F32, 0.0),
            _f("cast_shadows", FieldKind.BOOL, True),
            _f("first_cascade_far_bound", FieldKind.F32, 10.0),
            _f("maximum_shadow_distance", FieldKind.F32, 1000.0),
            _f("minimum_shadow_distance", FieldKind.F32, 0.01),
            _f("first_clipmap_width", FieldKind.F32, 10.0),
            _f("clipmap_selection_bias", FieldKind.F32, -1.5),
        ),
    ),
    ComponentDef(
        "SkyComponent",
        (
            _f("solid_color", FieldKind.VEC4, (0.0, 0.0, 0.0, 1.0)),
            _f("ambient_color", FieldKind.VEC3, (0.03, 0.03, 0.03)),
            _f("texture", FieldKind.UUID),
        ),
    ),
    ComponentDef(
        "AtmosphereComponent",
        (
            _f("rayleigh_scattering", FieldKind.VEC3, (5.802, 13.558, 33.100)),
            _f("rayleigh_density", FieldKind.F32, 8.0),
            _f("mie_scattering", FieldKind.VEC3, (3.996, 3.996, 3.996)),
            _f("mie_density", FieldKind.F32, 1.2),
            _f("mie_extinction", FieldKind.F32, 4.44),
            _f("mie_asymmetry", FieldKind.F32, 3.6),
            _f("ozone_absorption", FieldKind.VEC3, (0.650, 1.881, 0.085)),
            _f("ozone_height", FieldKind.F32, 25.0),
            _f("ozone_thickness", FieldKind.F32, 15.0),
            _f("aerial_perspective_start_km", FieldKind.F32, 8.0),
            _f("aerial_perspective_exposure", FieldKind.F32, 1.0),
        ),
    ),
    ComponentDef(
        "AutoExposureComponent",
        (
            _f("min_exposure", FieldKind.F32, -11.5),
            _f("max_exposure", FieldKind.F32, 18.0),
            _f("adaptation_speed", FieldKind.F32, 1.1),
            _f("ev100_bias", FieldKind.F32, 1.0),
        ),
    ),
    ComponentDef("VignetteComponent", (_f("amount", FieldKind.F32, 0.5),)),
    ComponentDef("ChromaticAberrationComponent", (_f("amount", FieldKind.F32, 0.5),)),
    ComponentDef(
        "FilmGrainComponent",
        (_f("amount", FieldKind.F32, 0.6), _f("scale", FieldKind.F32, 0.7)),
    ),
    ComponentDef(
        "TonemappingComponent",
        (_f("tonemap_type", FieldKind.ENUM, 2, TONEMAP_TYPE),),  # default AgX
    ),
    ComponentDef(
        "RigidBodyComponent",
        (
            _f("allowed_dofs", FieldKind.U32, 0b111111),
            _f("type", FieldKind.ENUM, 2, RIGIDBODY_TYPE),  # default Dynamic
            _f("mass", FieldKind.F32, 1.0),
            _f("linear_drag", FieldKind.F32, 0.05),
            _f("angular_drag", FieldKind.F32, 0.05),
            _f("gravity_factor", FieldKind.F32, 1.0),
            _f("friction", FieldKind.F32, 0.2),
            _f("restitution", FieldKind.F32, 0.0),
            _f("allow_sleep", FieldKind.BOOL, True),
            _f("awake", FieldKind.BOOL, True),
            _f("continuous", FieldKind.BOOL, False),
            _f("interpolation", FieldKind.BOOL, False),
            _f("is_sensor", FieldKind.BOOL, False),
            # runtime pose state (Components.hpp:300-303, kept for interpolation)
            _f("previous_translation", FieldKind.VEC3, (0.0, 0.0, 0.0)),
            _f("previous_rotation", FieldKind.QUAT, (0.0, 0.0, 0.0, 1.0)),
            _f("translation", FieldKind.VEC3, (0.0, 0.0, 0.0)),
            _f("rotation", FieldKind.QUAT, (0.0, 0.0, 0.0, 1.0)),
        ),
    ),
    ComponentDef(
        "BoxColliderComponent",
        (
            _f("size", FieldKind.VEC3, (0.5, 0.5, 0.5)),
            _f("offset", FieldKind.VEC3, (0.0, 0.0, 0.0)),
        )
        + _collider_tail(),
    ),
    ComponentDef(
        "SphereColliderComponent",
        (
            _f("radius", FieldKind.F32, 0.5),
            _f("offset", FieldKind.VEC3, (0.0, 0.0, 0.0)),
        )
        + _collider_tail(),
    ),
    ComponentDef(
        "CapsuleColliderComponent",
        (
            _f("height", FieldKind.F32, 1.0),
            _f("radius", FieldKind.F32, 0.5),
            _f("offset", FieldKind.VEC3, (0.0, 0.0, 0.0)),
        )
        + _collider_tail(),
    ),
    ComponentDef(
        "TaperedCapsuleColliderComponent",
        (
            _f("height", FieldKind.F32, 1.0),
            _f("top_radius", FieldKind.F32, 0.5),
            _f("bottom_radius", FieldKind.F32, 0.5),
            _f("offset", FieldKind.VEC3, (0.0, 0.0, 0.0)),
        )
        + _collider_tail(),
    ),
    ComponentDef(
        "CylinderColliderComponent",
        (
            _f("height", FieldKind.F32, 1.0),
            _f("radius", FieldKind.F32, 0.5),
            _f("offset", FieldKind.VEC3, (0.0, 0.0, 0.0)),
        )
        + _collider_tail(),
    ),
    ComponentDef(
        "MeshColliderComponent",
        (
            _f("offset", FieldKind.VEC3, (0.0, 0.0, 0.0)),
            _f("friction", FieldKind.F32, 0.5),
            _f("restitution", FieldKind.F32, 0.0),
        ),
    ),
    ComponentDef(
        "CharacterControllerComponent",
        (
            _f("character_height_standing", FieldKind.F32, 1.35),
            _f("character_radius_standing", FieldKind.F32, 0.3),
            _f("character_height_crouching", FieldKind.F32, 0.8),
            _f("character_radius_crouching", FieldKind.F32, 0.3),
            _f("interpolation", FieldKind.BOOL, True),
            _f("control_movement_during_jump", FieldKind.BOOL, True),
            _f("jump_force", FieldKind.F32, 8.0),
            _f("auto_bunny_hop", FieldKind.BOOL, False),
            _f("air_control", FieldKind.F32, 0.3),
            _f("max_ground_speed", FieldKind.F32, 7.0),
            _f("ground_acceleration", FieldKind.F32, 14.0),
            _f("ground_deceleration", FieldKind.F32, 10.0),
            _f("max_air_speed", FieldKind.F32, 7.0),
            _f("air_acceleration", FieldKind.F32, 2.0),
            _f("air_deceleration", FieldKind.F32, 2.0),
            _f("max_strafe_speed", FieldKind.F32, 0.0),
            _f("strafe_acceleration", FieldKind.F32, 50.0),
            _f("strafe_deceleration", FieldKind.F32, 50.0),
            _f("friction", FieldKind.F32, 6.0),
            _f("gravity", FieldKind.F32, 20.0),
            _f("collision_tolerance", FieldKind.F32, 0.05),
            # runtime input/state (driven by gameplay code each frame, like the
            # reference's Lua-driven character movement)
            _f("move_input", FieldKind.VEC3, (0.0, 0.0, 0.0)),
            _f("jump_input", FieldKind.BOOL, False),
            _f("is_grounded", FieldKind.BOOL, False),
            # runtime pose state
            _f("previous_translation", FieldKind.VEC3, (0.0, 0.0, 0.0)),
            _f("previous_rotation", FieldKind.QUAT, (0.0, 0.0, 0.0, 1.0)),
            _f("translation", FieldKind.VEC3, (0.0, 0.0, 0.0)),
            _f("rotation", FieldKind.QUAT, (0.0, 0.0, 0.0, 1.0)),
        ),
    ),
    ComponentDef(
        "AudioSourceComponent",
        (
            _f("audio_source", FieldKind.UUID),
            _f("attenuation_model", FieldKind.U32, 2),  # Inverse
            _f("volume", FieldKind.F32, 1.0),
            _f("pitch", FieldKind.F32, 1.0),
            _f("play_on_awake", FieldKind.BOOL, True),
            _f("looping", FieldKind.BOOL, False),
            _f("spatialization", FieldKind.BOOL, False),
            _f("roll_off", FieldKind.F32, 1.0),
            _f("min_gain", FieldKind.F32, 0.0),
            _f("max_gain", FieldKind.F32, 1.0),
            _f("min_distance", FieldKind.F32, 0.3),
            _f("max_distance", FieldKind.F32, 1000.0),
            _f("cone_inner_angle", FieldKind.F32, _DEG360),
            _f("cone_outer_angle", FieldKind.F32, _DEG360),
            _f("cone_outer_gain", FieldKind.F32, 0.0),
            _f("doppler_factor", FieldKind.F32, 1.0),
        ),
    ),
    ComponentDef(
        "AudioListenerComponent",
        (
            _f("active", FieldKind.BOOL, False),
            _f("listener_index", FieldKind.U32, 0),
            _f("cone_inner_angle", FieldKind.F32, _DEG360),
            _f("cone_outer_angle", FieldKind.F32, _DEG360),
            _f("cone_outer_gain", FieldKind.F32, 0.0),
        ),
    ),
    ComponentDef("Hidden", (), tag=True),
    ComponentDef("Networked", (), tag=True),
)

BY_NAME: dict[str, ComponentDef] = {c.name: c for c in COMPONENTS}
BY_PATH: dict[str, ComponentDef] = {c.path: c for c in COMPONENTS}

# Components whose SoA arrays participate in the jit'd device step.
DEVICE_COMPONENTS = frozenset(
    {
        "TransformComponent",
        "SpriteComponent",
        "SpriteAnimationComponent",
        "CameraComponent",
        "ParticleSystemComponent",
        "ParticleComponent",
        "LightComponent",
        "RigidBodyComponent",
        "BoxColliderComponent",
        "SphereColliderComponent",
        "CapsuleColliderComponent",
        "CylinderColliderComponent",
        "CharacterControllerComponent",
        "MeshComponent",
        "LayerComponent",
    }
)


def lookup(name_or_path: str) -> ComponentDef | None:
    """Resolve a component by bare name or full flecs path."""
    if name_or_path in BY_PATH:
        return BY_PATH[name_or_path]
    return BY_NAME.get(name_or_path.rsplit(".", 1)[-1])
