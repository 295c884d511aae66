"""setup_s (s): from the process's start to the first timed call: the
kernel library, the scene and its packing, the warm-up of the cell's own
shapes (host clock)."""


def read(run):
    return run.setup_s
