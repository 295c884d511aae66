"""Keyboard / mouse input state + bounded event queues.

The port's own copy of `ptre_tpu/app/events.py`, unchanged in behaviour.
Equivalents of the reference's input singletons:

* `Keyboard` — 256-entry key-state bitset plus a 16-deep FIFO of
  PRESS/RELEASE events; reading from an empty queue yields an INVALID
  event (`keyboard.h:44-66`, `keyboard.cu:31-68`).
* `Mouse` — left/right/middle button bitset, cursor position,
  enter/leave tracking, and wheel-delta accumulation that emits one
  WHEELUP/WHEELDOWN event per 120 units of accumulated delta
  (`mouse.h`, `mouse.cu:99-122`); same 16-deep FIFO discipline.

Both queues drop their OLDEST entries once the depth exceeds 16, exactly
like the reference's `trim_queue` (`keyboard.cu:64-69`, `mouse.cu:116-121`).
The window's event-routing layer (reference WndProc, `window.cu:105-201`)
is `Window.inject` in `ptre_tpu_torch.app.window`.
"""

from __future__ import annotations

import enum
from collections import deque
from dataclasses import dataclass
from typing import Deque, Optional, Tuple

NUM_EVENTS = 16  # queue depth (`keyboard.h:48`, `mouse.h:70`)
NUM_KEYS = 256  # key-state bitset size (`keyboard.h:57`)
WHEEL_DELTA = 120  # one wheel notch (`mouse.cu:101`)


class KeyEventType(enum.IntEnum):
    INVALID = -1
    PRESS = 0
    RELEASE = 1


@dataclass(frozen=True)
class KeyEvent:
    type: KeyEventType
    key: int  # 0-255; ASCII uppercase for letter keys, as in Win32 VK codes

    @property
    def valid(self) -> bool:
        return self.type != KeyEventType.INVALID


_INVALID_KEY_EVENT = KeyEvent(KeyEventType.INVALID, 0)


class Keyboard:
    """Key state + bounded PRESS/RELEASE queue (reference `keyboard`)."""

    def __init__(self):
        self._states = [False] * NUM_KEYS
        self._queue: Deque[KeyEvent] = deque()

    # -- queries ---------------------------------------------------------
    def key_is_pressed(self, key) -> bool:
        return self._states[_key_code(key)]

    def get_event(self) -> KeyEvent:
        """Pop the oldest event; INVALID if empty (`keyboard.cu:31-39`)."""
        if not self._queue:
            return _INVALID_KEY_EVENT
        return self._queue.popleft()

    def peek_event(self) -> KeyEvent:
        if not self._queue:
            return _INVALID_KEY_EVENT
        return self._queue[0]

    def __len__(self) -> int:
        return len(self._queue)

    # -- routing (window-only in the reference; public here) -------------
    def on_key_pressed(self, key) -> None:
        code = _key_code(key)
        self._states[code] = True
        self._queue.append(KeyEvent(KeyEventType.PRESS, code))
        self._trim()

    def on_key_released(self, key) -> None:
        code = _key_code(key)
        self._states[code] = False
        self._queue.append(KeyEvent(KeyEventType.RELEASE, code))
        self._trim()

    def clear_states(self) -> None:
        self._states = [False] * NUM_KEYS

    def _trim(self) -> None:
        while len(self._queue) > NUM_EVENTS:
            self._queue.popleft()


def _key_code(key) -> int:
    if isinstance(key, str):
        return ord(key.upper()[0])
    return int(key) & 0xFF


class MouseButton(enum.IntEnum):
    INVALID = -1
    LEFT = 0
    RIGHT = 1
    MIDDLE = 2


class MouseEventType(enum.IntEnum):
    INVALID = -1
    PRESS = 0
    RELEASE = 1
    MOVE = 2
    ENTER = 3
    LEAVE = 4
    WHEELDOWN = 5
    WHEELUP = 6


@dataclass(frozen=True)
class MouseEvent:
    type: MouseEventType
    button: MouseButton
    x: int
    y: int

    @property
    def valid(self) -> bool:
        return self.type != MouseEventType.INVALID

    @property
    def position(self) -> Tuple[int, int]:
        return (self.x, self.y)


_INVALID_MOUSE_EVENT = MouseEvent(MouseEventType.INVALID, MouseButton.INVALID, 0, 0)


class Mouse:
    """Button state, position, enter/leave, wheel accumulation
    (reference `mouse`)."""

    def __init__(self):
        self._states = [False] * 3
        self._queue: Deque[MouseEvent] = deque()
        self._coords: Tuple[int, int] = (0, 0)
        self._in_window = False
        self._total_delta = 0

    # -- queries ---------------------------------------------------------
    def button_is_pressed(self, btn: MouseButton) -> bool:
        return btn != MouseButton.INVALID and self._states[int(btn)]

    def is_in_window(self) -> bool:
        return self._in_window

    def get_x(self) -> int:
        return self._coords[0]

    def get_y(self) -> int:
        return self._coords[1]

    def get_position(self) -> Tuple[int, int]:
        return self._coords

    def get_event(self) -> MouseEvent:
        if not self._queue:
            return _INVALID_MOUSE_EVENT
        return self._queue.popleft()

    def peek_event(self) -> MouseEvent:
        if not self._queue:
            return _INVALID_MOUSE_EVENT
        return self._queue[0]

    def __len__(self) -> int:
        return len(self._queue)

    # -- routing ---------------------------------------------------------
    def on_mouse_move(self, x: int, y: int) -> None:
        self._coords = (x, y)
        self._queue.append(MouseEvent(MouseEventType.MOVE, MouseButton.INVALID, x, y))
        self._trim()

    def on_mouse_enter(self, x: int, y: int) -> None:
        self._in_window = True
        self._queue.append(MouseEvent(MouseEventType.ENTER, MouseButton.INVALID, x, y))
        self._trim()

    def on_mouse_leave(self, x: int, y: int) -> None:
        self._in_window = False
        self._queue.append(MouseEvent(MouseEventType.LEAVE, MouseButton.INVALID, x, y))
        self._trim()

    def on_button_pressed(self, btn: MouseButton, x: int, y: int) -> None:
        self._states[int(btn)] = True
        self._queue.append(MouseEvent(MouseEventType.PRESS, btn, x, y))
        self._trim()

    def on_button_released(self, btn: MouseButton, x: int, y: int) -> None:
        self._states[int(btn)] = False
        self._queue.append(MouseEvent(MouseEventType.RELEASE, btn, x, y))
        self._trim()

    def on_wheel_rotated(self, delta: int, x: int, y: int) -> None:
        """Accumulate raw delta; emit one WHEELUP/WHEELDOWN per ±120
        (reference `mouse.cu:99-114`)."""
        self._total_delta += delta
        while self._total_delta >= WHEEL_DELTA:
            self._queue.append(
                MouseEvent(MouseEventType.WHEELUP, MouseButton.INVALID, x, y))
            self._trim()
            self._total_delta -= WHEEL_DELTA
        while self._total_delta <= -WHEEL_DELTA:
            self._queue.append(
                MouseEvent(MouseEventType.WHEELDOWN, MouseButton.INVALID, x, y))
            self._trim()
            self._total_delta += WHEEL_DELTA

    def clear_states(self) -> None:
        self._states = [False] * 3

    def _trim(self) -> None:
        while len(self._queue) > NUM_EVENTS:
            self._queue.popleft()
