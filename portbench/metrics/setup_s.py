"""Process start to the window's start (host clock): import, library
load, data on the device, the index, the warm-up batches."""


def read(rec):
    return rec.setup_s
