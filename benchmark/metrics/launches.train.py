"""launches.train (count): device events (kernels, copies, fills) a training
step in the traced stretch, the recomputed samples' included
(torch.profiler)."""


def read(run):
    if run.profile is None or not run.profile.device:
        return None
    return run.profile.device_events_per_call()
