"""launches.frame (count): device events (kernels, copies, fills) a frame in
the traced stretch (torch.profiler)."""


def read(run):
    if run.profile is None or not run.profile.device:
        return None
    return run.profile.device_events_per_call()
