"""train_peak_gib (GiB): the card memory the training steps of the window
held at most, torch.cuda.max_memory_allocated() with its peak reset as the
window opens (device allocator)."""


def read(run):
    if run.device.type != "cuda":
        return None
    return run.window_peak_bytes / 2.0 ** 30
