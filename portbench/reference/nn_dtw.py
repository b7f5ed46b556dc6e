"""Plain exact 1-NN under banded DTW, in PyTorch alone.

The reference for every search configuration.  It imports nothing of the
program: it works out its own envelopes and bounds from the raw store and
queries, and its DTW is a sweep over anti-diagonals written here.

DTW is the squared-cost sum along the best warping path inside the
Sakoe-Chiba band ``|i - j| <= w`` (``w >= L`` is unconstrained):

    D(i, j) = (a_i - b_j)^2 + min(D(i-1, j-1), D(i-1, j), D(i, j-1))

Each cell is one subtraction, one multiply and one add, each rounded, so
any sweep order gives the same float32 value.  Anti-diagonal ``k = i + j``
depends only on ``k - 1`` and ``k - 2``, so a whole diagonal of a batch of
pairs is a few elementwise calls.

Pruning is exact.  LB_Keogh against the query's envelope (Keogh and
Ratanamahatana, 2005) never exceeds DTW, so a candidate whose bound is
above the threshold cannot beat it; ``_LB_SLACK`` covers the bound's own
rounding.  A pair whose frontier minimum (the least of two consecutive
diagonals, which every warping path crosses) passes its cutoff is
dropped: costs are never negative, so its DTW is above the cutoff too.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

Tensor = torch.Tensor

_INF = float("inf")
# relative room for the rounding of the bound's sum (its terms are exact
# squares; a sum of L of them errs by far less than 1e-4)
_LB_SLACK = 1e-4
# elements of one (queries, candidates, L) block of the bound
_LB_BLOCK = 1 << 26


def band_half_width(L: int, w: int) -> int:
    return L - 1 if w >= L else min(w, L - 1)


def dtw_sweep(a: Tensor, b: Tensor, w: int, cutoff=None,
              check_every: int = 64) -> Tensor:
    """``(P, L) x (P, L) -> (P,)`` banded DTW in ``a``'s dtype.

    ``cutoff`` (scalar or ``(P,)``): every ``check_every`` diagonals the
    pairs whose frontier minimum is above it are dropped from the sweep
    and return ``+inf``; a pair whose DTW is at most its cutoff is never
    dropped, and its value is exact.
    """
    P, L = a.shape
    wb = band_half_width(L, w)
    dt, dev = a.dtype, a.device
    out = torch.full((P,), _INF, dtype=dt, device=dev)
    if P == 0:
        return out
    rows = torch.arange(P, device=dev)
    cut = None
    if cutoff is not None:
        cut = torch.as_tensor(cutoff, dtype=dt, device=dev).expand(P).clone()
    a = a.contiguous()
    brev = b.flip(-1).contiguous()              # brev[t] = b[L - 1 - t]
    # diagonal k's values sit at column i + 1; columns lo and hi + 2 are
    # +inf sentinels, which is all that later diagonals read outside it
    bufs = [torch.full((P, L + 2), _INF, dtype=dt, device=dev)
            for _ in range(3)]
    prev_span = None
    for k in range(2 * L - 1):
        lo = max(0, k - (L - 1), -((wb - k) // 2))
        hi = min(L - 1, k, (k + wb) // 2)
        cur = bufs[k % 3]
        p1 = bufs[(k - 1) % 3]
        p2 = bufs[(k - 2) % 3]
        diff = a[:, lo:hi + 1] - brev[:, L - 1 - k + lo:L - k + hi]
        cost = diff.mul_(diff)
        if k == 0:
            cur[:, lo + 1:hi + 2] = cost
        else:
            m = torch.minimum(p1[:, lo:hi + 1], p1[:, lo + 1:hi + 2])
            m = torch.minimum(m, p2[:, lo:hi + 1])
            cur[:, lo + 1:hi + 2] = cost.add_(m)
        cur[:, lo] = _INF
        cur[:, hi + 2] = _INF
        last = k == 2 * L - 2
        if cut is not None and not last and k > 0 \
                and (k + 1) % check_every == 0:
            plo, phi = prev_span
            fmin = torch.cat([cur[:, lo + 1:hi + 2],
                              p1[:, plo + 1:phi + 2]], dim=1).amin(1)
            keep = fmin <= cut
            n_keep = int(keep.sum())
            if n_keep < keep.shape[0]:
                if n_keep == 0:
                    return out
                rows, a, brev, cut = rows[keep], a[keep], brev[keep], \
                    cut[keep]
                bufs = [x[keep] for x in bufs]
        prev_span = (lo, hi)
    out[rows] = bufs[(2 * L - 2) % 3][:, L]
    if cut is not None:
        out = torch.where(out <= torch.as_tensor(
            cutoff, dtype=dt, device=dev).expand(P), out, _INF)
    return out


def query_envelope(q: Tensor, w: int) -> tuple[Tensor, Tensor]:
    """``(upper, lower)`` running max and min of each query row over
    ``[i - w, i + w]``."""
    L = q.shape[1]
    wb = band_half_width(L, w)
    if wb == L - 1:
        return (q.amax(1, keepdim=True).expand_as(q),
                q.amin(1, keepdim=True).expand_as(q))
    x = q[:, None]
    up = F.max_pool1d(x, 2 * wb + 1, stride=1, padding=wb)[:, 0]
    lo = -F.max_pool1d(-x, 2 * wb + 1, stride=1, padding=wb)[:, 0]
    return up, lo


def lb_keogh(q: Tensor, store: Tensor, w: int) -> Tensor:
    """``(Q, N)`` LB_Keogh of every store series against each query's
    envelope, in blocks of the store."""
    Q, L = q.shape
    N = store.shape[0]
    up, lo = query_envelope(q, w)
    out = torch.empty((Q, N), dtype=q.dtype, device=q.device)
    step = max(1, _LB_BLOCK // max(1, Q * L))
    for s in range(0, N, step):
        c = store[None, s:s + step]
        ex = (c - up[:, None]).clamp(min=0) + (lo[:, None] - c).clamp(min=0)
        out[:, s:s + step] = (ex * ex).sum(-1)
    return out


def nn_dtw(queries: Tensor, store: Tensor, w: int, *, threshold=None,
           pairs_per_sweep: int = 65536, check_every: int = 64
           ) -> tuple[Tensor, Tensor]:
    """Exact 1-NN of each query: ``(dists (Q,), ids (Q,) int64)``, in the
    inputs' dtype.

    ``threshold`` ((Q,), optional): a distance known to be reached (the
    judged neighbour's); only candidates that could beat it are swept,
    and a query none beats gets ``+inf`` and id -1.  Without it the
    lowest-bounded candidates are swept first and their best becomes the
    threshold.  Candidates go in ascending bound order, a batch of
    queries' candidates in one sweep; ties go to the lowest id.
    """
    Q, L = queries.shape
    dev, dt = queries.device, queries.dtype
    N = store.shape[0]
    lb = lb_keogh(queries, store, w)
    lb_sorted, order = torch.sort(lb, dim=1, stable=True)
    best_d = torch.full((Q,), _INF, dtype=dt, device=dev)
    best_i = torch.full((Q,), -1, dtype=torch.int64, device=dev)
    thr = best_d.clone() if threshold is None else \
        torch.as_tensor(threshold, dtype=dt, device=dev).clone()
    cursor = [0] * Q
    while True:
        # each query's candidates whose bound could still beat it
        limit = torch.searchsorted(lb_sorted, (thr * (1 + _LB_SLACK))[:, None],
                                   right=True)[:, 0].tolist()
        todo = [q for q in range(Q) if cursor[q] < limit[q]]
        if not todo:
            break
        share = max(1, pairs_per_sweep // len(todo))
        qi, ci = [], []
        for q in todo:
            e = min(limit[q], cursor[q] + share)
            ci.append(order[q, cursor[q]:e])
            qi.append(torch.full((e - cursor[q],), q, dtype=torch.int64,
                                 device=dev))
            cursor[q] = e
        qi = torch.cat(qi)
        ci = torch.cat(ci)
        d = dtw_sweep(queries[qi], store[ci], w, cutoff=thr[qi],
                      check_every=check_every)
        # per query: the least value, the lowest id among its ties
        key_d = torch.full((Q,), _INF, dtype=dt, device=dev)
        key_d = key_d.scatter_reduce(0, qi, d, reduce="amin")
        hit = (d == key_d[qi]) & torch.isfinite(d)
        cand_i = torch.where(hit, ci, N)
        key_i = torch.full((Q,), N, dtype=torch.int64, device=dev)
        key_i = key_i.scatter_reduce(0, qi, cand_i, reduce="amin")
        better = (key_d < best_d) | ((key_d == best_d) & (key_i < best_i))
        better = better & torch.isfinite(key_d)
        best_d = torch.where(better, key_d, best_d)
        best_i = torch.where(better, key_i, best_i)
        thr = torch.minimum(thr, best_d)
    return best_d, best_i
