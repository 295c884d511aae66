"""engine.host_ms (ms): mean host time inside Renderer.draw_frame, from call
to return, over the window's frames (the harness's span; host clock)."""


def read(run):
    return run.mean_call_ms()
