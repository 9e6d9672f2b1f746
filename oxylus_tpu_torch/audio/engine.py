"""Audio engine: clips, spatialized sources, listeners, block mixing (a copy of
`oxylus_tpu/audio/engine.py`).

The miniaudio replacement (`Oxylus/include/Audio/AudioEngine.hpp:12-53`): same control
surface — per-source volume/pitch/looping, attenuation models
(none/linear/inverse/exponential), cone directivity with inner/outer angles + outer
gain, doppler — driven each frame by the ECS systems (`Scene.cpp:681-716`) through
`SceneRunner`'s audio hook. Instead of an OS audio callback, `render_block(frames)`
mixes all playing sources into a stereo float32 buffer (headless: feed it to a file, a
socket, or an audio device binding). Mixing is vectorized NumPy on the host, as in the
JAX package: one 800-sample block a frame at 60 Hz needs no kernel.
"""

from __future__ import annotations

import dataclasses
import wave
from pathlib import Path

import numpy as np

SAMPLE_RATE = 48000

# AttenuationModelType (reference AudioEngine.hpp)
ATTENUATION_NONE = 0
ATTENUATION_LINEAR = 1
ATTENUATION_INVERSE = 2
ATTENUATION_EXPONENTIAL = 3


@dataclasses.dataclass
class AudioClip:
    name: str
    samples: np.ndarray  # (N, 2) float32 stereo at SAMPLE_RATE
    sample_rate: int = SAMPLE_RATE

    @classmethod
    def load(cls, path) -> "AudioClip":
        path = Path(path)
        with wave.open(str(path), "rb") as w:
            rate = w.getframerate()
            channels = w.getnchannels()
            width = w.getsampwidth()
            raw = w.readframes(w.getnframes())
        dtype = {1: np.uint8, 2: np.int16, 4: np.int32}[width]
        data = np.frombuffer(raw, dtype).astype(np.float32)
        if width == 1:
            data = (data - 128.0) / 128.0
        else:
            data = data / float(np.iinfo(dtype).max)
        data = data.reshape(-1, channels)
        if channels == 1:
            data = np.repeat(data, 2, axis=1)
        elif channels > 2:
            data = data[:, :2]
        if rate != SAMPLE_RATE:  # linear resample
            n_out = int(len(data) * SAMPLE_RATE / rate)
            x = np.linspace(0.0, len(data) - 1.0, n_out)
            i0 = np.floor(x).astype(np.int64)
            i1 = np.minimum(i0 + 1, len(data) - 1)
            frac = (x - i0)[:, None]
            data = data[i0] * (1 - frac) + data[i1] * frac
        return cls(name=path.stem, samples=np.ascontiguousarray(data, np.float32))

    @classmethod
    def tone(cls, freq: float = 440.0, seconds: float = 1.0, name: str = "tone") -> "AudioClip":
        t = np.arange(int(SAMPLE_RATE * seconds)) / SAMPLE_RATE
        mono = np.sin(2 * np.pi * freq * t).astype(np.float32) * 0.5
        return cls(name=name, samples=np.stack([mono, mono], axis=1))


@dataclasses.dataclass
class Source:
    clip: AudioClip
    volume: float = 1.0
    pitch: float = 1.0
    looping: bool = False
    playing: bool = False
    cursor: float = 0.0  # fractional frame position
    # spatialization
    spatialization: bool = False
    position: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3, np.float32))
    velocity: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3, np.float32))
    direction: np.ndarray = dataclasses.field(default_factory=lambda: np.array([0, 0, -1], np.float32))
    attenuation_model: int = ATTENUATION_INVERSE
    roll_off: float = 1.0
    min_gain: float = 0.0
    max_gain: float = 1.0
    min_distance: float = 0.3
    max_distance: float = 1000.0
    cone_inner_angle: float = 2 * np.pi
    cone_outer_angle: float = 2 * np.pi
    cone_outer_gain: float = 0.0
    doppler_factor: float = 1.0

    def play(self) -> None:
        self.playing = True

    def stop(self) -> None:
        self.playing = False
        self.cursor = 0.0

    def pause(self) -> None:
        self.playing = False


@dataclasses.dataclass
class Listener:
    active: bool = True
    position: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3, np.float32))
    velocity: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3, np.float32))
    forward: np.ndarray = dataclasses.field(default_factory=lambda: np.array([0, 0, -1], np.float32))
    up: np.ndarray = dataclasses.field(default_factory=lambda: np.array([0, 1, 0], np.float32))
    cone_inner_angle: float = 2 * np.pi
    cone_outer_angle: float = 2 * np.pi
    cone_outer_gain: float = 0.0


SPEED_OF_SOUND = 343.0


class AudioEngine:
    MODULE_NAME = "AudioEngine"

    def __init__(self) -> None:
        self.sources: list[Source] = []
        self.listeners: list[Listener] = [Listener()]
        self.master_volume = 1.0

    def init(self, app=None) -> None: ...

    def deinit(self, app=None) -> None:
        self.sources.clear()

    # ------------------------------------------------------------- management
    def create_source(self, clip: AudioClip, **kw) -> Source:
        src = Source(clip=clip, **kw)
        self.sources.append(src)
        return src

    def destroy_source(self, src: Source) -> None:
        if src in self.sources:
            self.sources.remove(src)

    def listener(self, index: int = 0) -> Listener:
        while len(self.listeners) <= index:
            self.listeners.append(Listener(active=False))
        return self.listeners[index]

    # ------------------------------------------------------------- spatial math
    def _gain_and_pan(self, src: Source, lst: Listener) -> tuple[float, float, float]:
        """Returns (gain, pan [-1 left … 1 right], doppler_ratio)."""
        if not src.spatialization:
            return src.volume, 0.0, 1.0
        rel = src.position - lst.position
        dist = float(np.linalg.norm(rel))
        d = np.clip(dist, src.min_distance, src.max_distance)
        if src.attenuation_model == ATTENUATION_NONE:
            g = 1.0
        elif src.attenuation_model == ATTENUATION_LINEAR:
            g = 1.0 - src.roll_off * (d - src.min_distance) / max(
                src.max_distance - src.min_distance, 1e-6
            )
        elif src.attenuation_model == ATTENUATION_EXPONENTIAL:
            g = (d / src.min_distance) ** (-src.roll_off)
        else:  # inverse (default)
            g = src.min_distance / (
                src.min_distance + src.roll_off * (d - src.min_distance)
            )
        g = float(np.clip(g, src.min_gain, src.max_gain))

        # source cone directivity
        if src.cone_outer_angle < 2 * np.pi - 1e-6 and dist > 1e-6:
            to_listener = -rel / dist
            cosang = float(np.dot(src.direction, -to_listener))
            ang = np.arccos(np.clip(cosang, -1.0, 1.0)) * 2.0
            if ang <= src.cone_inner_angle:
                cone = 1.0
            elif ang >= src.cone_outer_angle:
                cone = src.cone_outer_gain
            else:
                t = (ang - src.cone_inner_angle) / max(
                    src.cone_outer_angle - src.cone_inner_angle, 1e-6
                )
                cone = 1.0 + (src.cone_outer_gain - 1.0) * t
            g *= cone

        # stereo pan from listener basis
        pan = 0.0
        if dist > 1e-6:
            right = np.cross(lst.forward, lst.up)
            pan = float(np.clip(np.dot(rel / dist, right), -1.0, 1.0))

        # doppler
        ratio = 1.0
        if src.doppler_factor > 0.0 and dist > 1e-6:
            dirn = rel / dist
            v_src = float(np.dot(src.velocity, dirn))
            v_lst = float(np.dot(lst.velocity, dirn))
            denom = SPEED_OF_SOUND + src.doppler_factor * v_src
            if abs(denom) > 1e-3:
                ratio = float(
                    np.clip((SPEED_OF_SOUND + src.doppler_factor * v_lst) / denom, 0.25, 4.0)
                )
        return g * src.volume, pan, ratio

    # ------------------------------------------------------------- mixing
    def render_block(self, frames: int) -> np.ndarray:
        """Mix all playing sources into a (frames, 2) float32 block, advancing cursors."""
        out = np.zeros((frames, 2), np.float32)
        lst = next((l for l in self.listeners if l.active), self.listeners[0])
        for src in self.sources:
            if not src.playing or len(src.clip.samples) == 0:
                continue
            gain, pan, doppler = self._gain_and_pan(src, lst)
            step = src.pitch * doppler
            n = len(src.clip.samples)
            pos = src.cursor + np.arange(frames, dtype=np.float64) * step
            if src.looping:
                pos = np.mod(pos, n)
                src.cursor = float(np.mod(src.cursor + frames * step, n))
                live = np.ones(frames, bool)
            else:
                live = pos < n - 1
                src.cursor = float(src.cursor + frames * step)
                if src.cursor >= n - 1:
                    src.playing = False
                pos = np.clip(pos, 0, n - 1.0001)
            i0 = pos.astype(np.int64)
            frac = (pos - i0)[:, None].astype(np.float32)
            samp = src.clip.samples[i0] * (1 - frac) + src.clip.samples[np.minimum(i0 + 1, n - 1)] * frac
            samp = samp * live[:, None]
            left = np.sqrt(0.5 * (1.0 - pan))
            right = np.sqrt(0.5 * (1.0 + pan))
            out[:, 0] += samp[:, 0] * gain * left * 2**0.5
            out[:, 1] += samp[:, 1] * gain * right * 2**0.5
        return np.clip(out * self.master_volume, -1.0, 1.0)


def sync_sources_from_scene(engine: AudioEngine, scene, source_map: dict[int, Source], asset_manager=None) -> None:
    """ECS → engine sync (the reference's `audio_source_update`/`audio_listener_update`
    systems, `Scene.cpp:681-716`): push component state into live sources/listeners."""
    import numpy as np

    from ..core import uuid as uuidlib

    ac = scene._comp_data["AudioSourceComponent"]
    mask = scene._comp_mask["AudioSourceComponent"]
    tc = scene._comp_data["TransformComponent"]
    for i in np.nonzero(mask & scene._alive)[0]:
        i = int(i)
        src = source_map.get(i)
        if src is None:
            clip = None
            if asset_manager is not None:
                u = uuidlib.u64_pair_to_uuid(*ac["audio_source"][i])
                asset = asset_manager.get_asset(u)
                if asset and asset.is_loaded:
                    clip = asset_manager._payload(asset)
            if clip is None:
                continue
            src = engine.create_source(clip)
            source_map[i] = src
            if ac["play_on_awake"][i]:
                src.play()
        src.volume = float(ac["volume"][i])
        src.pitch = float(ac["pitch"][i])
        src.looping = bool(ac["looping"][i])
        src.spatialization = bool(ac["spatialization"][i])
        src.attenuation_model = int(ac["attenuation_model"][i])
        src.roll_off = float(ac["roll_off"][i])
        src.min_gain = float(ac["min_gain"][i])
        src.max_gain = float(ac["max_gain"][i])
        src.min_distance = float(ac["min_distance"][i])
        src.max_distance = float(ac["max_distance"][i])
        src.cone_inner_angle = float(ac["cone_inner_angle"][i])
        src.cone_outer_angle = float(ac["cone_outer_angle"][i])
        src.cone_outer_gain = float(ac["cone_outer_gain"][i])
        src.doppler_factor = float(ac["doppler_factor"][i])
        src.position = tc["position"][i].astype(np.float32)

    lc = scene._comp_data["AudioListenerComponent"]
    lmask = scene._comp_mask["AudioListenerComponent"]
    for i in np.nonzero(lmask & scene._alive)[0]:
        i = int(i)
        idx = int(lc["listener_index"][i])
        listener = engine.listener(idx)
        listener.active = bool(lc["active"][i])
        listener.position = tc["position"][i].astype(np.float32)
        listener.cone_inner_angle = float(lc["cone_inner_angle"][i])
        listener.cone_outer_angle = float(lc["cone_outer_angle"][i])
        listener.cone_outer_gain = float(lc["cone_outer_gain"][i])
