"""Configuration: per-scene renderer settings, the app's context settings and the
CVar view (a copy of `oxylus_tpu/core/config.py`).

`RendererConfig` is copied field for field, with the same JSON layout, so a
scene's `config` object reads the same in both packages. `ContextConfig` is the
app's global settings (the reference's `ContextCVar`), and `CVarSystem` a flat
string-keyed live view over config dataclasses for console and script access
(the reference's hashed CVar registry, `Utils/CVars.hpp:27-143`).
"""

from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass
class RendererConfig:
    """Per-scene renderer settings. Defaults match `RendererCVar::init`
    (`src/Render/RendererCVar.cpp:7-52`)."""

    # debug
    enable_debug_renderer: bool = True
    draw_bounding_boxes: bool = False
    enable_physics_debug_renderer: bool = False
    freeze_culling_frustum: bool = False
    draw_camera_frustum: bool = False
    debug_view: int = 0
    # culling
    culling_frustum: bool = True
    culling_occlusion: bool = True
    culling_triangle: bool = True
    # contact shadows
    contact_shadows: bool = True
    contact_shadows_steps: int = 8
    contact_shadows_thickness: float = 0.1
    contact_shadows_length: float = 0.01
    # vbgtao
    vbgtao_enable: bool = True
    vbgtao_quality_level: int = 3
    vbgtao_thickness: float = 0.25
    vbgtao_radius: float = 0.5
    vbgtao_final_power: float = 1.2
    # bloom
    bloom_enable: bool = True
    bloom_threshold: float = 1.0
    bloom_soft_threshold: float = 0.125
    bloom_radius: float = 0.75
    bloom_intensity: float = 0.1
    bloom_clamp: float = 4.0
    # fxaa
    fxaa_enable: bool = True
    # screen-space reflections (config-5 SSSR-style pass; not part of the
    # reference's RendererCVar schema, so not serialized in to_json)
    ssr_enable: bool = False
    ssr_steps: int = 8
    ssr_max_roughness: float = 0.5
    # color
    tonemapper: int = 0
    exposure: float = 1.0
    gamma: float = 2.2

    def to_json(self) -> dict[str, Any]:
        """Emit the exact `config` object layout of `RendererCVar::to_json`."""
        return {
            "debug": {
                "enable_debug_renderer": self.enable_debug_renderer,
                "draw_bounding_boxes": self.draw_bounding_boxes,
                "enable_physics_debug_renderer": self.enable_physics_debug_renderer,
            },
            "color": {
                "tonemapper": self.tonemapper,
                "exposure": self.exposure,
                "gamma": self.gamma,
            },
            "gtao": {
                "enabled": self.vbgtao_enable,
                "quality_level": self.vbgtao_quality_level,
                "thickness": self.vbgtao_thickness,
                "radius": self.vbgtao_radius,
                "final_power": self.vbgtao_final_power,
            },
            "bloom": {
                "enabled": self.bloom_enable,
                "threshold": self.bloom_threshold,
                "soft_threshold": self.bloom_soft_threshold,
                "radius": self.bloom_radius,
                "intensity": self.bloom_intensity,
                "clamp": self.bloom_clamp,
            },
            "fxaa": {"enabled": self.fxaa_enable},
            "contact_shadows": {
                "enabled": self.contact_shadows,
                "steps": self.contact_shadows_steps,
                "thickness": self.contact_shadows_thickness,
                "length": self.contact_shadows_length,
            },
        }

    @classmethod
    def from_json(cls, obj: dict[str, Any]) -> "RendererConfig":
        """Tolerant reader matching `RendererCVar::from_json` — missing sections or
        newer keys keep defaults (`RendererCVar.cpp:103-160`)."""
        cfg = cls()
        debug = obj.get("debug")
        if debug is not None:
            cfg.enable_debug_renderer = bool(debug.get("enable_debug_renderer", cfg.enable_debug_renderer))
            cfg.draw_bounding_boxes = bool(debug.get("draw_bounding_boxes", cfg.draw_bounding_boxes))
            cfg.enable_physics_debug_renderer = bool(
                debug.get("enable_physics_debug_renderer", cfg.enable_physics_debug_renderer)
            )
        color = obj.get("color")
        if color is not None:
            cfg.tonemapper = int(color.get("tonemapper", cfg.tonemapper))
            cfg.exposure = float(color.get("exposure", cfg.exposure))
            cfg.gamma = float(color.get("gamma", cfg.gamma))
        gtao = obj.get("gtao")
        if gtao is not None:
            cfg.vbgtao_enable = bool(gtao.get("enabled", cfg.vbgtao_enable))
            cfg.vbgtao_quality_level = int(gtao.get("quality_level", cfg.vbgtao_quality_level))
            cfg.vbgtao_thickness = float(gtao.get("thickness", cfg.vbgtao_thickness))
            cfg.vbgtao_radius = float(gtao.get("radius", cfg.vbgtao_radius))
            cfg.vbgtao_final_power = float(gtao.get("final_power", cfg.vbgtao_final_power))
        bloom = obj.get("bloom")
        if bloom is not None:
            cfg.bloom_enable = bool(bloom.get("enabled", cfg.bloom_enable))
            cfg.bloom_threshold = float(bloom.get("threshold", cfg.bloom_threshold))
            cfg.bloom_soft_threshold = float(bloom.get("soft_threshold", cfg.bloom_soft_threshold))
            cfg.bloom_radius = float(bloom.get("radius", cfg.bloom_radius))
            cfg.bloom_intensity = float(bloom.get("intensity", cfg.bloom_intensity))
            cfg.bloom_clamp = float(bloom.get("clamp", cfg.bloom_clamp))
        fxaa = obj.get("fxaa")
        if fxaa is not None:
            cfg.fxaa_enable = bool(fxaa.get("enabled", cfg.fxaa_enable))
        cs = obj.get("contact_shadows")
        if cs is not None:
            cfg.contact_shadows = bool(cs.get("enabled", cfg.contact_shadows))
            cfg.contact_shadows_steps = int(cs.get("steps", cfg.contact_shadows_steps))
            cfg.contact_shadows_thickness = float(cs.get("thickness", cfg.contact_shadows_thickness))
            cfg.contact_shadows_length = float(cs.get("length", cfg.contact_shadows_length))
        return cfg


@dataclasses.dataclass
class ContextConfig:
    """Global app config (reference: `Render/ContextCVar.hpp`, persisted toml)."""

    vsync: bool = True
    frame_limit: float = 0.0  # 0 = unlimited


class CVarSystem:
    """Flat string-keyed live view over config dataclasses — the console/scripting
    surface of the reference's hashed CVar registry (`Utils/CVars.hpp:27-143`)."""

    def __init__(self) -> None:
        self._bindings: dict[str, tuple[Any, str]] = {}

    def bind_dataclass(self, prefix: str, obj: Any) -> None:
        for f in dataclasses.fields(obj):
            self._bindings[f"{prefix}.{f.name}"] = (obj, f.name)

    def names(self) -> list[str]:
        return sorted(self._bindings)

    def get(self, name: str) -> Any:
        obj, attr = self._bindings[name]
        return getattr(obj, attr)

    def set(self, name: str, value: Any) -> None:
        obj, attr = self._bindings[name]
        current = getattr(obj, attr)
        setattr(obj, attr, type(current)(value))
