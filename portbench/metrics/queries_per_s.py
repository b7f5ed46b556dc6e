"""All queries answered over the window's whole time (host clock)."""


def read(rec):
    return rec.items / rec.window_s if rec.window_s > 0 else None
