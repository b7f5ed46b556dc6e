"""Device milliseconds a batch of the engine's call into ``run_plan``
(CUDA events around it)."""


def read(rec):
    if rec.probes is None or rec.batches == 0:
        return None
    s = rec.probes.cascade.seconds()
    return None if s is None else s * 1e3 / rec.batches
