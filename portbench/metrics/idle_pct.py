"""The device's idle share of the first whole batch of the traced window,
from ``torch.profiler``: 100 (1 - busy / span), busy the union of device
activity."""


def read(rec):
    if rec.profile is None or rec.profile["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - rec.profile["busy_s"] / rec.profile["window_s"])
