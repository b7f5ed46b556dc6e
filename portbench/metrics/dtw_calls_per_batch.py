"""Calls through the DTW boundary (``CascadeConfig.dtw_fn()``) a batch:
the engine's rounds plus the cascade's seeds' call."""


def read(rec):
    if rec.probes is None or rec.batches == 0:
        return None
    return rec.probes.dtw_calls / rec.batches
