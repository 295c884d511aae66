"""Application frame loop: window + timer + input -> engine facade.

The port's own copy of `ptre_tpu/app/application.py`; the demo renderer it
builds lives on ``device`` (None: the card, RendererError where there is
none).
Equivalent of the reference's `application` (`application.{h,cu}`) and
`WinMain` (`main.cu:8-33`): construct the window and renderer over the demo
scene, then pump `process_message()` / `run_frame()` until quit. Per-frame
behavior matches `application::update_frame` (`application.cu:74-94`):

* dt from the timer, FPS/ms pushed to the window title once per second in
  the reference's exact format (`application.cu:101-113`);
* a `P` key PRESS toggles the engine (deferred to the frame boundary by the
  facade, `renderer.cu:45-53`);
* while the right mouse button is held, accumulation is reset
  (`application.cu:87-89`);
* frames are drawn by the active engine and presented to the window.

`main()` is the `WinMain` analogue with the reference's 3-tier exception
handling (`main.cu:24-32`) reporting to stderr instead of a MessageBox.
"""

from __future__ import annotations

import math
from typing import Optional

from ptre_tpu_torch.app.events import KeyEventType, MouseButton
from ptre_tpu_torch.app.timer import Timer
from ptre_tpu_torch.app.window import Window
from ptre_tpu_torch.render.engine import Renderer
from ptre_tpu_torch.utils.errors import IoniqError

TAU = 2.0 * math.pi


class Application:
    """Frame-loop driver (reference `application`)."""

    def __init__(
        self,
        window: Optional[Window] = None,
        renderer: Optional[Renderer] = None,
        spp_per_frame: int = 1,
        device=None,
    ):
        self.window = window if window is not None else Window()
        if renderer is None:
            from ptre_tpu_torch.models import demo
            from ptre_tpu_torch.ops import camera as cam_ops

            # demo scene + camera at the window's client size
            # (`application.cu:16-34`)
            scene = demo.reference_demo_scene()
            cam = cam_ops.Camera.create(
                width=self.window.width, height=self.window.height, device=device
            )
            renderer = Renderer(scene, cam, spp_per_frame=spp_per_frame, device=device)
        self.renderer = renderer
        self.timer = Timer()
        self.dt = 0.0
        self.radians = 0.0  # animation accumulator (`application.cu:91-93`)
        self._fps_frames = 0
        self._fps_time = 0.0

    # -- loop (`application.cu:53-72`) ------------------------------------
    def process_message(self) -> bool:
        return self.window.process_messages()

    def run_frame(self) -> None:
        """One iteration of the main loop (`application::run`)."""
        self.renderer.begin_frame()
        self.update_frame()
        self.draw_frame()
        self.end_frame()

    def run(self, max_frames: Optional[int] = None) -> int:
        """Pump until quit (or max_frames); returns frames rendered
        (`main.cu:18-20`)."""
        frames = 0
        while self.process_message():
            if max_frames is not None and frames >= max_frames:
                break
            self.run_frame()
            frames += 1
        return frames

    # -- per-frame (`application.cu:74-113`) -------------------------------
    def update_frame(self) -> None:
        self.dt = self.timer.get_delta()
        self.get_fps(self.dt)

        e = self.window.keyboard.get_event()
        if e.type == KeyEventType.PRESS and e.key == ord("P"):
            self.renderer.toggle_engine()

        if self.window.mouse.button_is_pressed(MouseButton.RIGHT):
            self.renderer.reset()

        self.radians = math.fmod(self.radians + self.dt, TAU)

    def draw_frame(self) -> None:
        self._last_img = self.renderer.draw_frame()

    def end_frame(self) -> None:
        self.window.present(self._last_img)

    def get_fps(self, dt: float) -> None:
        """FPS/ms title once per second, reference format
        (`application.cu:101-113`)."""
        self._fps_frames += 1
        self._fps_time += dt
        if self._fps_time > 1.0:
            n = self._fps_frames
            self.window.set_title(f"FPS: {n} ({1000.0 / n}ms)")
            self._fps_time = 0.0
            self._fps_frames = 0


def main(argv=None) -> int:
    """`WinMain` analogue: window + application + pump, tiered exception
    reporting (`main.cu:8-33`)."""
    import sys

    try:
        app = Application()
        app.run()
        return 0
    except IoniqError as e:  # framework-typed (`main.cu:24-26`)
        print(f"ioniq error: {e}", file=sys.stderr)
    except Exception as e:  # std::exception tier (`main.cu:27-29`)
        print(f"error: {e}", file=sys.stderr)
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
