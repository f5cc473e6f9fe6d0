"""Peak of the caching allocator's allocated memory on the card over the
window (``torch.cuda.max_memory_allocated`` after a reset at its start)."""


def read(run):
    if run.window_peak_bytes is None:
        return None
    return run.window_peak_bytes / 2**20
