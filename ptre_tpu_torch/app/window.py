"""Headless window: message pump, event routing, presentation.

The port's own copy of `ptre_tpu/app/window.py`, unchanged in behaviour.
Equivalent of the reference's Win32 `window` (`window.{h,cu}`): a fixed
1280x720 surface (`window.h:40-41`) that routes platform messages into the
keyboard/mouse queues (`window.cu:105-201`), with `set_title`
(`window.cu:76-83`) and a typed `WindowError` (`window.cu:203-233`).

There is no OS surface in a headless process, so the message source is explicit: an
`inject(...)` API (tests / scripted sessions) or an attached `EventSource`
(e.g. stdin). Event-routing semantics match the reference WndProc:

* CLOSE posts quit; `process_messages()` then returns False (`window.cu:108-111`);
* KILLFOCUS clears held key states (`window.cu:112-118`);
* key autorepeat is suppressed — a key_down for an already-held key does not
  enqueue a second PRESS (the `lParam & BIT(30)` check, `window.cu:121-125`);
* mouse moves inside the client area enter the window (with capture),
  outside it leave unless a button is held (`window.cu:133-151`);
* wheel deltas accumulate in the mouse (`window.cu:190-196`).

Presentation: `present(frame)` stores the frame and forwards it to an
optional presenter callback — the swap-chain stand-in (a file writer, or
`ansi_presenter` for an in-terminal preview).
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Deque, Optional, Tuple

import numpy as np

from ptre_tpu_torch.app.events import Keyboard, Mouse, MouseButton
from ptre_tpu_torch.utils.errors import IoniqError

DEFAULT_WIDTH = 1280  # `window.h:40`
DEFAULT_HEIGHT = 720  # `window.h:41`

# message kinds accepted by inject(); mirrors the WM_* cases handled by the
# reference WndProc (`window.cu:105-201`)
MSG_CLOSE = "close"
MSG_KILLFOCUS = "killfocus"
MSG_KEY_DOWN = "key_down"
MSG_KEY_UP = "key_up"
MSG_MOUSE_MOVE = "mouse_move"
MSG_BUTTON_DOWN = "button_down"
MSG_BUTTON_UP = "button_up"
MSG_WHEEL = "wheel"


class WindowError(IoniqError):
    """Window-layer failure (reference `window::exception`)."""


class Window:
    """Event pump + presentation surface (reference `window`)."""

    def __init__(
        self,
        width: int = DEFAULT_WIDTH,
        height: int = DEFAULT_HEIGHT,
        title: str = "ptre_tpu_torch",
        presenter: Optional[Callable[[np.ndarray], None]] = None,
        event_source: Optional[Callable[[], list]] = None,
    ):
        if width <= 0 or height <= 0:
            raise WindowError(f"invalid client area {width}x{height}")
        self.width = width
        self.height = height
        self.title = title
        self.keyboard = Keyboard()
        self.mouse = Mouse()
        self._messages: Deque[tuple] = deque()
        self._quit = False
        self._presenter = presenter
        self._event_source = event_source
        self._last_frame: Optional[np.ndarray] = None

    # -- message pump ----------------------------------------------------
    def inject(self, kind: str, *payload) -> None:
        """Enqueue a platform message (the PostMessage analogue)."""
        self._messages.append((kind, payload))

    def process_messages(self) -> bool:
        """Drain pending messages into the input queues; False once a CLOSE
        has been seen (reference `process_message` PeekMessage pump,
        `application.cu:53-64`)."""
        if self._event_source is not None:
            for msg in self._event_source():
                self._messages.append((msg[0], tuple(msg[1:])))
        while self._messages:
            kind, payload = self._messages.popleft()
            self._handle(kind, payload)
        return not self._quit

    def _handle(self, kind: str, payload: tuple) -> None:
        kb, ms = self.keyboard, self.mouse
        if kind == MSG_CLOSE:
            self._quit = True
        elif kind == MSG_KILLFOCUS:
            kb.clear_states()
        elif kind == MSG_KEY_DOWN:
            (key,) = payload
            # suppress autorepeat PRESSes (`window.cu:121-125`)
            if not kb.key_is_pressed(key):
                kb.on_key_pressed(key)
        elif kind == MSG_KEY_UP:
            (key,) = payload
            kb.on_key_released(key)
        elif kind == MSG_MOUSE_MOVE:
            x, y = payload
            inside = 0 <= x < self.width and 0 <= y < self.height
            if inside:
                ms.on_mouse_move(x, y)
                if not ms.is_in_window():
                    ms.on_mouse_enter(x, y)
            elif ms.button_is_pressed(MouseButton.LEFT) or ms.button_is_pressed(
                MouseButton.RIGHT
            ):
                ms.on_mouse_move(x, y)
            else:
                ms.on_mouse_leave(x, y)
        elif kind == MSG_BUTTON_DOWN:
            btn, x, y = payload
            ms.on_button_pressed(MouseButton(btn), x, y)
        elif kind == MSG_BUTTON_UP:
            btn, x, y = payload
            ms.on_button_released(MouseButton(btn), x, y)
        elif kind == MSG_WHEEL:
            delta, x, y = payload
            ms.on_wheel_rotated(delta, x, y)
        else:
            raise WindowError(f"unknown window message: {kind!r}")

    def post_quit(self) -> None:
        self.inject(MSG_CLOSE)

    # -- title / presentation --------------------------------------------
    def set_title(self, title: str) -> None:
        """Reference `window::set_title` (`window.cu:76-83`); carries the
        FPS readout when driven by `Application.get_fps`."""
        self.title = title

    def present(self, frame: np.ndarray) -> None:
        """Present an (H, W, 3) uint8 frame — the swap-chain stand-in."""
        self._last_frame = frame
        if self._presenter is not None:
            self._presenter(frame)

    @property
    def last_frame(self) -> Optional[np.ndarray]:
        return self._last_frame

    @property
    def client_size(self) -> Tuple[int, int]:
        return (self.width, self.height)


def ansi_presenter(stream=None, max_cols: int = 100):
    """Presenter drawing frames as ANSI half-block cells — an in-terminal
    preview standing in for the D3D11 swap chain."""
    import sys

    out = stream if stream is not None else sys.stdout

    def present(frame: np.ndarray) -> None:
        h, w = frame.shape[:2]
        cols = min(max_cols, w)
        step = max(1, w // cols)
        small = frame[:: 2 * step, ::step]
        lines = []
        top_rows = frame[step::2 * step, ::step]
        rows = min(small.shape[0], top_rows.shape[0])
        for r in range(rows):
            cells = []
            for c in range(small.shape[1]):
                tr, tg, tb = (int(v) for v in small[r, c][:3])
                br, bg, bb = (int(v) for v in top_rows[r, c][:3])
                cells.append(
                    f"\x1b[38;2;{tr};{tg};{tb}m\x1b[48;2;{br};{bg};{bb}m▀"
                )
            lines.append("".join(cells) + "\x1b[0m")
        out.write("\n".join(lines) + "\n")
        out.flush()

    return present
