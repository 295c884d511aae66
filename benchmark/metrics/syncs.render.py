"""syncs.render (count): host calls that wait for the device (stream, device
and event synchronizes: the wavefront's kept live-count reads among them) a
render step, inside the traced steps (torch.profiler)."""

from benchmark.devtrace import SYNC_CALLS


def read(run):
    if run.profile is None or not run.profile.device:
        return None
    return run.profile.host_events_in_calls(SYNC_CALLS) / run.profile.calls
