"""render_step.host_ms (ms): mean host time of pathtracer.render_step, from
call to return without a synchronize, over the window's steps (the
harness's span; host clock)."""


def read(run):
    return run.mean_call_ms()
