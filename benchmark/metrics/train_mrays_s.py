"""train_mrays_s (Mrays/s): the nominal rays, W x H x spp x max_depth, of
every training step (forward and backward) completed in the window, over the
window's time; the window ends in a device synchronize (host clock)."""


def read(run):
    return run.rays_per_call * run.calls / run.window_s / 1e6
