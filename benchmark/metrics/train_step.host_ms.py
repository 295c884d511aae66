"""train_step.host_ms (ms): mean host time of train.mse_step, from call to
return, over the window's steps (the harness's span; host clock)."""


def read(run):
    return run.mean_call_ms()
