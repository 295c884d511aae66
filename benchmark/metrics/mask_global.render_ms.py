"""mask_global.render_ms (ms): device milliseconds in the launches of the mask
kernel's global instantiation (wave_mask_global_kernel, past 1,024
leaves) a render step, from the traced stretch (torch.profiler); None
where the trace holds no launch of it."""

from benchmark.rooflines import mask_global


def read(run):
    if run.profile is None or not run.profile.device:
        return None
    launches, seconds = run.profile.kernel(mask_global.matches)
    if launches == 0:
        return None
    return 1e3 * seconds / run.profile.calls
