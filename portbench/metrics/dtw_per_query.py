"""Mean of ``SearchResult.n_dtw`` over the window's queries: the
program's own count of necessary verifications, the paper's
pruning-power numerator."""


def read(rec):
    if rec.items == 0:
        return None
    return rec.counters["n_dtw"] / rec.items
