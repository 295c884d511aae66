"""The port's application shell (`ptre_tpu_torch/app/`): the contracts of
`tests/test_app.py`, case for case, against the port's classes, with the
renderer on the CPU (``device="cpu"``), plus the port's own: the demo
application built at the window's size on the device asked for, and
`main()`'s tiered error reporting.

Covers the event-queue semantics of `keyboard.{h,cu}`/`mouse.{h,cu}` (16-deep
FIFO with oldest-dropped trim, key bitset, wheel-delta accumulation), the
window message routing of `window.cu:105-201` (autorepeat suppression,
enter/leave with held-button exception, killfocus clearing), the timer, and
the application loop of `application.cu:66-113` (P-key engine toggle at the
frame boundary, right-button accumulation reset, FPS title format).
"""

from __future__ import annotations

import io

import numpy as np
import pytest

from ptre_tpu_torch.app.events import (
    NUM_EVENTS,
    Keyboard,
    KeyEventType,
    Mouse,
    MouseButton,
    MouseEventType,
)
from ptre_tpu_torch.app.timer import Timer
from ptre_tpu_torch.app.window import (
    MSG_BUTTON_DOWN,
    MSG_BUTTON_UP,
    MSG_CLOSE,
    MSG_KEY_DOWN,
    MSG_KEY_UP,
    MSG_KILLFOCUS,
    MSG_MOUSE_MOVE,
    MSG_WHEEL,
    Window,
    WindowError,
    ansi_presenter,
)


# ---------------------------------------------------------------- keyboard
def test_keyboard_press_release_and_state():
    kb = Keyboard()
    kb.on_key_pressed("P")
    assert kb.key_is_pressed("P") and not kb.key_is_pressed("Q")
    e = kb.get_event()
    assert e.type == KeyEventType.PRESS and e.key == ord("P")
    kb.on_key_released("P")
    assert not kb.key_is_pressed("P")
    assert kb.get_event().type == KeyEventType.RELEASE


def test_keyboard_empty_queue_yields_invalid():
    kb = Keyboard()
    assert not kb.get_event().valid
    assert not kb.peek_event().valid


def test_keyboard_queue_trims_oldest_beyond_16():
    kb = Keyboard()
    for i in range(NUM_EVENTS + 5):
        kb.on_key_pressed(i)
    assert len(kb) == NUM_EVENTS
    # oldest 5 dropped (`keyboard.cu:64-69`)
    assert kb.get_event().key == 5


def test_keyboard_peek_does_not_pop():
    kb = Keyboard()
    kb.on_key_pressed("A")
    assert kb.peek_event().key == ord("A")
    assert len(kb) == 1
    assert kb.get_event().key == ord("A")
    assert len(kb) == 0


# ------------------------------------------------------------------- mouse
def test_mouse_buttons_and_position():
    m = Mouse()
    m.on_button_pressed(MouseButton.RIGHT, 10, 20)
    assert m.button_is_pressed(MouseButton.RIGHT)
    assert not m.button_is_pressed(MouseButton.LEFT)
    e = m.get_event()
    assert e.type == MouseEventType.PRESS and e.position == (10, 20)
    m.on_button_released(MouseButton.RIGHT, 11, 21)
    assert not m.button_is_pressed(MouseButton.RIGHT)


def test_mouse_wheel_accumulates_to_notches():
    m = Mouse()
    # +300 = two WHEELUP notches, 60 left over (`mouse.cu:99-114`)
    m.on_wheel_rotated(300, 0, 0)
    assert m.get_event().type == MouseEventType.WHEELUP
    assert m.get_event().type == MouseEventType.WHEELUP
    assert not m.get_event().valid
    # +60 more crosses the threshold once
    m.on_wheel_rotated(60, 0, 0)
    assert m.get_event().type == MouseEventType.WHEELUP
    # negative deltas emit WHEELDOWN
    m.on_wheel_rotated(-240, 0, 0)
    assert m.get_event().type == MouseEventType.WHEELDOWN
    assert m.get_event().type == MouseEventType.WHEELDOWN


def test_mouse_queue_trims_oldest():
    m = Mouse()
    for i in range(NUM_EVENTS + 3):
        m.on_mouse_move(i, i)
    assert len(m) == NUM_EVENTS
    assert m.get_event().x == 3


# ------------------------------------------------------------------ window
def test_window_routes_key_messages_and_suppresses_autorepeat():
    w = Window(64, 64)
    w.inject(MSG_KEY_DOWN, "P")
    w.inject(MSG_KEY_DOWN, "P")  # autorepeat: must NOT enqueue a 2nd PRESS
    w.inject(MSG_KEY_UP, "P")
    assert w.process_messages()
    assert w.keyboard.get_event().type == KeyEventType.PRESS
    assert w.keyboard.get_event().type == KeyEventType.RELEASE
    assert not w.keyboard.get_event().valid


def test_window_killfocus_clears_key_states():
    w = Window(64, 64)
    w.inject(MSG_KEY_DOWN, "W")
    w.process_messages()
    assert w.keyboard.key_is_pressed("W")
    w.inject(MSG_KILLFOCUS)
    w.process_messages()
    assert not w.keyboard.key_is_pressed("W")


def test_window_mouse_enter_leave_semantics():
    w = Window(100, 100)
    w.inject(MSG_MOUSE_MOVE, 50, 50)
    w.process_messages()
    assert w.mouse.is_in_window()
    types = []
    while True:
        e = w.mouse.get_event()
        if not e.valid:
            break
        types.append(e.type)
    assert MouseEventType.ENTER in types
    # outside with no button held -> leave
    w.inject(MSG_MOUSE_MOVE, 500, 500)
    w.process_messages()
    assert not w.mouse.is_in_window()
    # outside with a button held -> still tracked (capture semantics)
    w.inject(MSG_MOUSE_MOVE, 50, 50)
    w.inject(MSG_BUTTON_DOWN, int(MouseButton.LEFT), 50, 50)
    w.process_messages()
    w.inject(MSG_MOUSE_MOVE, 500, 500)
    w.process_messages()
    assert w.mouse.get_position() == (500, 500)
    w.inject(MSG_BUTTON_UP, int(MouseButton.LEFT), 500, 500)
    w.process_messages()


def test_window_close_ends_pump_and_wheel_routing():
    w = Window(64, 64)
    w.inject(MSG_WHEEL, 120, 5, 5)
    assert w.process_messages()
    assert w.mouse.get_event().type == MouseEventType.WHEELUP
    w.post_quit()
    assert not w.process_messages()


def test_window_rejects_bad_geometry_and_unknown_message():
    with pytest.raises(WindowError):
        Window(0, 10)
    w = Window(8, 8)
    w.inject("bogus")
    with pytest.raises(WindowError):
        w.process_messages()


def test_ansi_presenter_writes_truecolor_cells():
    buf = io.StringIO()
    w = Window(16, 8, presenter=ansi_presenter(stream=buf, max_cols=16))
    frame = np.zeros((8, 16, 3), np.uint8)
    frame[..., 0] = 255
    w.present(frame)
    out = buf.getvalue()
    assert "\x1b[38;2;255;0;0m" in out
    assert w.last_frame is frame


# ------------------------------------------------------------------- timer
def test_timer_delta_and_total_with_fake_clock():
    t = {"now": 100.0}
    tm = Timer(clock=lambda: t["now"])
    t["now"] = 100.25
    assert tm.get_delta() == pytest.approx(0.25)
    t["now"] = 100.75
    assert tm.get_delta() == pytest.approx(0.5)
    assert tm.get_total_time() == pytest.approx(0.75)


# ------------------------------------------------------------- application
@pytest.fixture()
def tiny_renderer():
    from ptre_tpu_torch.models import demo
    from ptre_tpu_torch.ops import camera as cam_ops
    from ptre_tpu_torch.render.engine import Renderer
    from ptre_tpu_torch.utils.config import RasterConfig, RenderConfig

    scene = demo.reference_demo_scene(8, 4)
    cam = cam_ops.Camera.create(width=16, height=12, device="cpu")
    return Renderer(
        scene,
        cam,
        RenderConfig(width=16, height=12),
        RasterConfig(width=16, height=12),
        device="cpu",
    )


def test_application_p_key_toggles_engine(tiny_renderer):
    from ptre_tpu_torch.app.application import Application
    from ptre_tpu_torch.render.engine import EngineKind

    w = Window(16, 12)
    app = Application(window=w, renderer=tiny_renderer)
    assert tiny_renderer.engine == EngineKind.PATHTRACER
    w.inject(MSG_KEY_DOWN, "P")
    assert app.run(max_frames=1) == 1
    assert tiny_renderer.engine == EngineKind.RASTERIZER
    # presented frame reached the window
    assert w.last_frame is not None and w.last_frame.shape == (12, 16, 3)
    # toggle back: one event is consumed per frame (`application.cu:78-85`),
    # so the RELEASE is read first and the PRESS lands on the next frame
    w.inject(MSG_KEY_UP, "P")
    w.inject(MSG_KEY_DOWN, "P")
    app.run(max_frames=2)
    assert tiny_renderer.engine == EngineKind.PATHTRACER


def test_application_right_button_resets_accumulation(tiny_renderer):
    from ptre_tpu_torch.app.application import Application

    w = Window(16, 12)
    app = Application(window=w, renderer=tiny_renderer)
    app.run(max_frames=2)
    assert int(tiny_renderer.accum.frame) >= 2
    w.inject(MSG_BUTTON_DOWN, int(MouseButton.RIGHT), 1, 1)
    app.run(max_frames=1)
    # reset applied before the frame's sample -> counter restarted at 1
    assert int(tiny_renderer.accum.frame) == 1
    w.inject(MSG_BUTTON_UP, int(MouseButton.RIGHT), 1, 1)


def test_application_quit_message_stops_loop(tiny_renderer):
    from ptre_tpu_torch.app.application import Application

    w = Window(16, 12)
    app = Application(window=w, renderer=tiny_renderer)
    w.post_quit()
    assert app.run(max_frames=10) == 0


def test_application_fps_title_format(tiny_renderer):
    from ptre_tpu_torch.app.application import Application

    w = Window(16, 12)
    app = Application(window=w, renderer=tiny_renderer)
    t = {"now": 0.0}
    app.timer = Timer(clock=lambda: t["now"])
    for _ in range(4):
        t["now"] += 0.3
        app.run_frame()
    # 1.2s elapsed at the 4th frame -> title shows FPS: 4 (250.0ms)
    assert w.title == "FPS: 4 (250.0ms)"


def test_application_builds_the_demo_renderer_at_the_window_size():
    from ptre_tpu_torch.app import __all__ as port_all
    from ptre_tpu_torch.app.application import Application
    from ptre_tpu.app import __all__ as jax_all

    assert port_all == jax_all
    w = Window(20, 10)
    app = Application(window=w, spp_per_frame=2, device="cpu")
    r = app.renderer
    assert (r.camera.width, r.camera.height) == (20, 10)
    assert r.spp_per_frame == 2 and r.device.type == "cpu"
    assert app.run(max_frames=1) == 1
    assert r.accum.frame == 2 and w.last_frame.shape == (10, 20, 3)


def test_main_reports_framework_and_other_errors(monkeypatch, capsys):
    from ptre_tpu_torch.app import application
    from ptre_tpu_torch.utils.errors import RendererError

    def fail(exc):
        def init(self, *a, **k):
            raise exc
        return init

    monkeypatch.setattr(application.Application, "__init__", fail(RendererError("no card")))
    assert application.main() == 1
    assert "ioniq error: no card" in capsys.readouterr().err
    monkeypatch.setattr(application.Application, "__init__", fail(ValueError("bad")))
    assert application.main() == 1
    assert "error: bad" in capsys.readouterr().err


# ------------------------------------------------- against the JAX package
# The same message scripts, fed to the reference's classes (`ptre_tpu/app/`,
# pure Python) and to the port's, must leave the same observable state.
from ptre_tpu.app import application as japplication  # noqa: E402
from ptre_tpu.app import timer as jtimer  # noqa: E402
from ptre_tpu.app import window as jwindow  # noqa: E402
from ptre_tpu_torch.app import application  # noqa: E402
from ptre_tpu_torch.app import timer  # noqa: E402
from ptre_tpu_torch.app import window  # noqa: E402

KEYS = ("P", "W", 65, 300)  # 300 & 0xFF = 44: codes wrap as in the reference
INSIDE, OUTSIDE = ((0, 0), (5, 7), (19, 9)), ((20, 5), (-1, 3), (500, 500), (4, 10))


def _drain(q):
    out = []
    while True:
        e = q.get_event()
        if not e.valid:
            return out
        out.append((int(e.type), e.key) if hasattr(e, "key")
                   else (int(e.type), int(e.button), e.x, e.y))


def _state(w, drain):
    """Everything a caller can observe of a window and its input queues."""
    kb, ms = w.keyboard, w.mouse
    state = {
        "keys": [kb.key_is_pressed(k) for k in range(256)],
        "buttons": [ms.button_is_pressed(b) for b in (0, 1, 2)],
        "position": ms.get_position(),
        "inside": ms.is_in_window(),
        "wheel": ms._total_delta,
        "lengths": (len(kb), len(ms)),
        "title": w.title,
    }
    if drain:
        state["key_events"], state["mouse_events"] = _drain(kb), _drain(ms)
    return state


def _random_script(seed, n=240):
    """Seeded chunks of window messages: autorepeated keys, moves in and out
    of a 20x10 window with and without a held button, wheel deltas,
    killfocus; the queues drained after some chunks only, so they overflow."""
    gen = np.random.default_rng(seed)
    chunks, chunk = [], []
    for _ in range(n):
        kind = gen.choice(["key_down", "key_down", "key_up", "move", "move", "button_down",
                           "button_up", "wheel", "killfocus"])
        if kind in ("key_down", "key_up"):
            chunk.append((MSG_KEY_DOWN if kind == "key_down" else MSG_KEY_UP,
                          KEYS[gen.integers(len(KEYS))]))
        elif kind == "move":
            pts = INSIDE if gen.random() < 0.5 else OUTSIDE
            chunk.append((MSG_MOUSE_MOVE, *pts[gen.integers(len(pts))]))
        elif kind in ("button_down", "button_up"):
            chunk.append((MSG_BUTTON_DOWN if kind == "button_down" else MSG_BUTTON_UP,
                          int(gen.integers(3)), 3, 4))
        elif kind == "wheel":
            chunk.append((MSG_WHEEL, int(gen.choice([-360, -120, -50, 30, 90, 120, 250])), 1, 2))
        else:
            chunk.append((MSG_KILLFOCUS,))
        if gen.random() < 0.1:
            chunks.append((chunk, bool(gen.random() < 0.5)))
            chunk = []
    chunks.append((chunk + [(MSG_CLOSE,)], True))
    return chunks


NAMED_SCRIPTS = {
    "autorepeat": [([(MSG_KEY_DOWN, "P")] * 3 + [(MSG_KEY_UP, "P"), (MSG_KEY_DOWN, "p")], True)],
    "overflow": [([(MSG_KEY_DOWN, k) for k in range(40)]
                  + [(MSG_MOUSE_MOVE, i % 20, i % 10) for i in range(40)], True)],
    "enter_leave": [([(MSG_MOUSE_MOVE, 5, 5), (MSG_MOUSE_MOVE, 30, 5), (MSG_MOUSE_MOVE, 5, 5)],
                     True),
                    ([(MSG_BUTTON_DOWN, 1, 5, 5), (MSG_MOUSE_MOVE, 30, 5),
                      (MSG_MOUSE_MOVE, 31, 6)], False),
                    ([(MSG_BUTTON_UP, 1, 31, 6), (MSG_MOUSE_MOVE, 32, 6),
                      (MSG_BUTTON_DOWN, 2, 5, 5), (MSG_MOUSE_MOVE, 40, 5)], True)],
    "wheel": [([(MSG_WHEEL, d, 1, 1) for d in (300, 60, -50, -240, 119, 1, -1000)], True)],
    "killfocus": [([(MSG_KEY_DOWN, "W"), (MSG_KEY_DOWN, "A"), (MSG_KILLFOCUS,),
                    (MSG_KEY_DOWN, "W")], True)],
    "close": [([(MSG_KEY_DOWN, "Q"), (MSG_CLOSE,), (MSG_KEY_DOWN, "R")], True),
              ([(MSG_KEY_UP, "Q")], True)],
}


def _run_script(chunks):
    """(the JAX window's states, the port's) after each chunk."""
    out = []
    for mod in (jwindow, window):
        w, states = mod.Window(20, 10, title="t"), []
        for chunk, drain in chunks:
            for msg in chunk:
                w.inject(*msg)
            states.append((w.process_messages(), _state(w, drain)))
        out.append(states)
    return out


@pytest.mark.parametrize("name", sorted(NAMED_SCRIPTS))
def test_window_matches_jax_on_named_scripts(name):
    want, got = _run_script(NAMED_SCRIPTS[name])
    assert got == want


@pytest.mark.parametrize("seed", range(6))
def test_window_matches_jax_on_seeded_scripts(seed):
    want, got = _run_script(_random_script(seed))
    assert got == want
    assert any(s["lengths"][0] == 16 or s["lengths"][1] == 16 for _, s in got)  # a trim ran


class _StubRenderer:
    """Records the calls an application makes; each frame is a distinct image."""

    def __init__(self):
        self.calls = []

    def begin_frame(self):
        self.calls.append("begin")

    def toggle_engine(self):
        self.calls.append("toggle")

    def reset(self):
        self.calls.append("reset")

    def draw_frame(self):
        self.calls.append("draw")
        return np.full((10, 20, 3), len(self.calls) % 256, np.uint8)


@pytest.mark.parametrize("seed", range(3))
def test_application_matches_jax_over_a_fake_clock(seed):
    """Both applications over one fake clock, a stub renderer each and the
    same per-frame messages (P presses, held right button, noise): the same
    calls to the renderer, titles, dt, animation angle and presented frames
    after every frame, and the same frame counts from `run`."""
    gen = np.random.default_rng(100 + seed)
    frames = []
    for _ in range(30):
        msgs = []
        for _ in range(int(gen.integers(0, 4))):
            kind = gen.integers(5)
            if kind == 0:
                msgs.append((MSG_KEY_DOWN, "P"))
            elif kind == 1:
                msgs.append((MSG_KEY_UP, str(gen.choice(["P", "Q"]))))
            elif kind == 2:
                msgs.append((MSG_BUTTON_DOWN, int(gen.integers(3)), 2, 2))
            elif kind == 3:
                msgs.append((MSG_BUTTON_UP, int(gen.integers(3)), 2, 2))
            else:
                msgs.append((MSG_KEY_DOWN, "Q"))
        frames.append((msgs, float(gen.choice([0.05, 0.125, 0.25, 0.5, 1.0, 1.25]))))
    runs = []
    for app_mod, win_mod, tim_mod in ((japplication, jwindow, jtimer),
                                      (application, window, timer)):
        t = {"now": 10.0}
        w, r = win_mod.Window(20, 10, title="t"), _StubRenderer()
        app = app_mod.Application(window=w, renderer=r)
        app.timer = tim_mod.Timer(clock=lambda: t["now"])
        trace = []
        for msgs, dt in frames:
            for msg in msgs:
                w.inject(*msg)
            t["now"] += dt
            n = app.run(max_frames=1)
            trace.append((n, list(r.calls), w.title, app.dt, app.radians,
                          w.last_frame.tobytes()))
        w.post_quit()
        trace.append(app.run(max_frames=5))
        runs.append(trace)
    assert runs[1] == runs[0]
    assert any("toggle" in calls for _, calls, *_ in runs[1][:-1])
    assert any("reset" in calls for _, calls, *_ in runs[1][:-1])


def test_timer_and_ansi_presenter_match_jax():
    t = {"now": 3.0}
    timers = [mod.Timer(clock=lambda: t["now"]) for mod in (jtimer, timer)]
    for dt in (0.25, 0.5, 1e-3, 2.0):
        t["now"] += dt
        deltas = [tm.get_delta() for tm in timers]
        assert deltas[0] == deltas[1]
        assert timers[0].get_total_time() == timers[1].get_total_time()
    frame = np.random.default_rng(4).integers(0, 256, (9, 33, 3), dtype=np.uint8)
    outs = []
    for mod in (jwindow, window):
        buf = io.StringIO()
        mod.ansi_presenter(stream=buf, max_cols=12)(frame)
        outs.append(buf.getvalue())
    assert outs[1] == outs[0] and "\x1b[38;2;" in outs[0]
