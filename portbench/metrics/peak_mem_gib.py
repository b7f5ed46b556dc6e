"""``torch.cuda.max_memory_allocated()`` over the window, the stats reset
at its start, so the resident store and index count (the card only)."""


def read(rec):
    if rec.peak_window_bytes is None:
        return None
    return rec.peak_window_bytes / 2 ** 30
