"""``torch.cuda.max_memory_allocated`` over the whole process up to the
window's close (set-up, the captured graph's pool and the window), MiB."""


def read(run):
    return run.memory_peak_bytes / 2**20 if run.memory_peak_bytes is not None else None
