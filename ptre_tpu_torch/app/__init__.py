"""Platform / application shell.

The port's own copy of `ptre_tpu/app/` (same classes, same ``__all__``).

Headless, scriptable equivalents of the reference's Win32 layer
(`IoniqRE/window.{h,cu}`, `keyboard.{h,cu}`, `mouse.{h,cu}`, `timer.{h,cu}`,
`application.{h,cu}`, `main.cu`): an event-pump `Window` that routes injected
platform events into `Keyboard`/`Mouse` queues, a `Timer`, and an
`Application` frame loop over the engine facade — same event semantics
(16-deep queues, key bitset, wheel-delta accumulation, `P` toggles engine,
right-button resets accumulation, FPS title once per second), minus the
actual OS surface: frames present to files or an ANSI terminal preview.
"""

from ptre_tpu_torch.app.application import Application
from ptre_tpu_torch.app.events import Keyboard, KeyEvent, Mouse, MouseButton, MouseEvent
from ptre_tpu_torch.app.timer import Timer
from ptre_tpu_torch.app.window import Window, WindowError

__all__ = [
    "Application",
    "Keyboard",
    "KeyEvent",
    "Mouse",
    "MouseButton",
    "MouseEvent",
    "Timer",
    "Window",
    "WindowError",
]
