"""``torch.cuda.max_memory_allocated`` over the training window (the peak
statistics reset as it opens), in GiB."""


def read(run):
    return run.memory_peak_bytes / 2 ** 30 if run.memory_peak_bytes > 0 else None
