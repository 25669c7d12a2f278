"""device_peak_gib: ``torch.cuda.max_memory_allocated()`` over set-up
and window, in GiB: the working set that decides how large a graph one
card serves."""


def read(run):
    if not run.memory_peak_bytes:
        return None
    return run.memory_peak_bytes / 2 ** 30
