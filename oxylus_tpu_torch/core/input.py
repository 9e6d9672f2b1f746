"""Input module: keyboard/mouse/gamepad state with pressed/released edge tracking
(a copy of `oxylus_tpu/core/input.py`).

The SDL3-input replacement (`Oxylus/include/Core/Input.hpp:110+`, `src/Core/Input.cpp`):
held/pressed/released per key and mouse button, cursor position and deltas, scroll,
gamepad axes/buttons. Headless-first: events are *injected* (by a window backend, a
replay file, a network remote, or tests) via `inject_*`; the app loop calls
`reset_pressed()` at frame end exactly like the reference (`App.cpp:101-102`).
"""

from __future__ import annotations

import dataclasses
import enum


class KeyCode(enum.IntEnum):
    UNKNOWN = 0
    A = 4; B = 5; C = 6; D = 7; E = 8; F = 9; G = 10; H = 11; I = 12; J = 13  # noqa: E702
    K = 14; L = 15; M = 16; N = 17; O = 18; P = 19; Q = 20; R = 21; S = 22  # noqa: E702
    T = 23; U = 24; V = 25; W = 26; X = 27; Y = 28; Z = 29  # noqa: E702
    NUM_1 = 30; NUM_2 = 31; NUM_3 = 32; NUM_4 = 33; NUM_5 = 34  # noqa: E702
    NUM_6 = 35; NUM_7 = 36; NUM_8 = 37; NUM_9 = 38; NUM_0 = 39  # noqa: E702
    RETURN = 40; ESCAPE = 41; BACKSPACE = 42; TAB = 43; SPACE = 44  # noqa: E702
    LEFT = 80; RIGHT = 79; UP = 82; DOWN = 81  # noqa: E702
    LSHIFT = 225; LCTRL = 224; LALT = 226  # noqa: E702
    F1 = 58; F2 = 59; F3 = 60; F4 = 61; F5 = 62; F6 = 63  # noqa: E702


class MouseButton(enum.IntEnum):
    LEFT = 1
    MIDDLE = 2
    RIGHT = 3
    X1 = 4
    X2 = 5


class CursorState(enum.Enum):
    NORMAL = "normal"
    HIDDEN = "hidden"
    DISABLED = "disabled"


@dataclasses.dataclass
class GamepadState:
    connected: bool = False
    buttons: dict[int, bool] = dataclasses.field(default_factory=dict)
    axes: dict[int, float] = dataclasses.field(default_factory=dict)


class Input:
    MODULE_NAME = "Input"

    def __init__(self) -> None:
        self._held: set[int] = set()
        self._pressed: set[int] = set()
        self._released: set[int] = set()
        self._mouse_held: set[int] = set()
        self._mouse_pressed: set[int] = set()
        self._mouse_released: set[int] = set()
        self.mouse_x = 0.0
        self.mouse_y = 0.0
        self.mouse_dx = 0.0
        self.mouse_dy = 0.0
        self.scroll_x = 0.0
        self.scroll_y = 0.0
        self.cursor_state = CursorState.NORMAL
        self.gamepads: dict[int, GamepadState] = {}

    def init(self, app=None) -> None: ...
    def deinit(self, app=None) -> None: ...

    # ------------------------------------------------------------ injection
    def inject_key_down(self, key: int) -> None:
        if key not in self._held:
            self._pressed.add(key)
        self._held.add(key)

    def inject_key_up(self, key: int) -> None:
        if key in self._held:
            self._released.add(key)
        self._held.discard(key)

    def inject_mouse_down(self, button: int) -> None:
        if button not in self._mouse_held:
            self._mouse_pressed.add(button)
        self._mouse_held.add(button)

    def inject_mouse_up(self, button: int) -> None:
        if button in self._mouse_held:
            self._mouse_released.add(button)
        self._mouse_held.discard(button)

    def inject_mouse_move(self, x: float, y: float) -> None:
        self.mouse_dx += x - self.mouse_x
        self.mouse_dy += y - self.mouse_y
        self.mouse_x = x
        self.mouse_y = y

    def inject_scroll(self, dx: float, dy: float) -> None:
        self.scroll_x += dx
        self.scroll_y += dy

    def inject_gamepad(self, index: int, buttons: dict[int, bool] | None = None, axes: dict[int, float] | None = None) -> None:
        pad = self.gamepads.setdefault(index, GamepadState(connected=True))
        pad.connected = True
        if buttons:
            pad.buttons.update(buttons)
        if axes:
            pad.axes.update(axes)

    # ------------------------------------------------------------ queries
    def get_key_held(self, key: int) -> bool:
        return key in self._held

    def get_key_pressed(self, key: int) -> bool:
        return key in self._pressed

    def get_key_released(self, key: int) -> bool:
        return key in self._released

    def get_mouse_held(self, button: int) -> bool:
        return button in self._mouse_held

    def get_mouse_pressed(self, button: int) -> bool:
        return button in self._mouse_pressed

    def get_mouse_released(self, button: int) -> bool:
        return button in self._mouse_released

    def get_mouse_position(self) -> tuple[float, float]:
        return self.mouse_x, self.mouse_y

    def get_mouse_delta(self) -> tuple[float, float]:
        return self.mouse_dx, self.mouse_dy

    def set_cursor_state(self, state: CursorState) -> None:
        self.cursor_state = state

    # ------------------------------------------------------------ frame end
    def reset_pressed(self) -> None:
        """Clear per-frame edges (`Input::reset_pressed`, called at App frame end)."""
        self._pressed.clear()
        self._released.clear()
        self._mouse_pressed.clear()
        self._mouse_released.clear()
        self.mouse_dx = 0.0
        self.mouse_dy = 0.0
        self.scroll_x = 0.0
        self.scroll_y = 0.0

    def update(self, app=None, ts=None) -> None: ...
