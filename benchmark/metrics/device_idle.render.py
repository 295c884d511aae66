"""device_idle.render (%): 100 x (1 - busy / wall) over the traced stretch of
render calls, busy the union of the device events' intervals
(torch.profiler)."""


def read(run):
    if run.profile is None or not run.profile.device:
        return None
    return 100.0 * (1.0 - run.profile.busy_s / run.profile.wall_s)
