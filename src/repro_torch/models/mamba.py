"""Mamba-1 selective SSM block (port of ``repro.models.mamba``).

The selective scan has two routes, as in the JAX package: ``"scan"``, a
chunked linear recurrence (a loop over sequence chunks carrying the
``(B, d_inner, n)`` state, a log-depth prefix scan inside each chunk),
and ``"kernel"`` (JAX's ``"pallas"``), the K10 op, which keeps the state
on chip for the whole sequence; ``"bypass"`` is the dry-run's stand-in
for K10 (JAX's ``"bypass"``, ``launch.dryrun``), shapes with no
recurrence.  The depthwise causal conv is shifted adds, with the
previous segment's tail from the cache.  ``A = -exp(A_log)``, softplus
in f32, and the state ``h`` in f32 in the cache.  Under a mesh
the channels shard over tp and the conv and the scan run on each rank's
channels (``mamba_apply``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops
from repro_torch.models.layers import lecun_normal, normal

Tensor = torch.Tensor


def mamba_init(gen: torch.Generator, device, d_model: int, d_inner: int,
               d_state: int, dt_rank: int,
               conv_width: int = 4) -> dict[str, Tensor]:
    f32 = dict(dtype=torch.float32, device=device)
    A = torch.arange(1, d_state + 1, **f32).expand(d_inner, d_state)
    return {
        "in_proj": lecun_normal((d_model, 2 * d_inner), gen, device),
        "conv_w": normal((conv_width, d_inner), 0.1, gen, device),
        "conv_b": torch.zeros(d_inner, **f32),
        "x_proj": lecun_normal((d_inner, dt_rank + 2 * d_state), gen, device),
        "dt_proj": lecun_normal((dt_rank, d_inner), gen, device),
        "dt_bias": torch.full((d_inner,), -4.6, **f32),  # softplus ~ 0.01
        "A_log": torch.log(A).contiguous(),
        "D": torch.ones(d_inner, **f32),
        "out_proj": lecun_normal((d_inner, d_model), gen, device),
    }


def _causal_conv(x: Tensor, w: Tensor, b: Tensor,
                 prev: Tensor | None) -> Tensor:
    """Depthwise causal conv as shifted adds.  x: (B, S, C), w: (K, C).

    ``prev`` is the (B, K-1, C) tail of the previous segment (decode
    cache); zeros when starting from scratch.
    """
    K = w.shape[0]
    if prev is None:
        prev = x.new_zeros((x.shape[0], K - 1, x.shape[2]))
    xp = torch.cat([prev.to(x.dtype), x], dim=1)          # (B, S+K-1, C)
    S = x.shape[1]
    out = torch.zeros_like(x)
    for i in range(K):
        out = out + xp[:, i:i + S] * w[i].to(x.dtype)
    return out + b.to(x.dtype)


def _prefix_scan(a: Tensor, b: Tensor) -> tuple[Tensor, Tensor]:
    """Inclusive scan along dim 1 of the affine maps ``h -> a h + b``
    (combine ``(a1, b1), (a2, b2) -> (a1 a2, a2 b1 + b2)``), in
    log2(T) doubling steps."""
    T = a.shape[1]
    off = 1
    while off < T:
        b = torch.cat([b[:, :off], a[:, off:] * b[:, :-off] + b[:, off:]], 1)
        a = torch.cat([a[:, :off], a[:, :-off] * a[:, off:]], 1)
        off *= 2
    return a, b


def _scan_chunk(d: Tensor, uu: Tensor, A: Tensor, bm: Tensor, cm: Tensor,
                h: Tensor, scan_dtype: torch.dtype = torch.float32
                ) -> tuple[Tensor, Tensor]:
    """One chunk of the recurrence from state h: (y (B, T, C), last h).
    The prefix scan runs in ``scan_dtype`` (JAX ``mamba.py:119-120``); the
    state is carried in f32."""
    a = torch.exp(d[..., None] * A).to(scan_dtype)         # (B, T, C, N)
    b = ((d * uu)[..., None] * bm[:, :, None, :]).to(scan_dtype)
    a_pre, b_pre = _prefix_scan(a, b)
    h_t = a_pre.float() * h[:, None] + b_pre.float()       # (B, T, C, N)
    # a copy, not a view: the state outlives the chunk in the cache, and
    # a view would keep the whole (B, T, C, N) chunk alive
    return torch.einsum("btcn,btn->btc", h_t, cm), h_t[:, -1].clone()


def _chunked_selective_scan(delta: Tensor, u: Tensor, A: Tensor,
                            Bmat: Tensor, Cmat: Tensor, h0: Tensor,
                            chunk: int,
                            scan_dtype: torch.dtype = torch.float32
                            ) -> tuple[Tensor, Tensor]:
    """Linear recurrence ``h_t = exp(delta_t A) h_{t-1} + delta_t u_t B_t``
    over chunks of ``chunk`` steps; the ``(B, chunk, C, N)`` discretised
    tensors exist for one chunk at a time.  ``scan_dtype=torch.bfloat16``
    halves the prefix scan's traffic (a dry-run lever, JAX's
    ``scan_dtype``); the state is re-accumulated in f32 at each chunk's
    boundary.  Under autograd each chunk runs in
    ``torch.utils.checkpoint``, as the reference checkpoints its chunk
    body, so its backward too holds one chunk's tensors at a time.
    Returns (y (B, S, C) f32 with ``y_t = <h_t, C_t>``, final state h)."""
    S = delta.shape[1]
    chunk = max(1, min(chunk, S))
    grad = torch.is_grad_enabled() and any(
        x.requires_grad for x in (delta, u, A, Bmat, Cmat, h0))
    h = h0
    ys = []
    for s0 in range(0, S, chunk):
        args = (delta[:, s0:s0 + chunk], u[:, s0:s0 + chunk], A,
                Bmat[:, s0:s0 + chunk], Cmat[:, s0:s0 + chunk], h,
                scan_dtype)
        y, h = (checkpoint(_scan_chunk, *args, use_reentrant=False) if grad
                else _scan_chunk(*args))
        ys.append(y)
    if not ys:
        return delta.new_zeros(delta.shape), h0
    return torch.cat(ys, dim=1), h


def _conv_silu(xi: Tensor, w: Tensor, b: Tensor, prev: Tensor | None,
               conv_width: int, keep_tail: bool):
    """silu of the causal conv, and the new conv tail when ``keep_tail``
    (a copy, not a view of the (B, S + K - 1, C) concat)."""
    u = F.silu(_causal_conv(xi, w, b, prev))
    if not keep_tail:
        return u, None
    return u, torch.cat([prev, xi.to(prev.dtype)],
                        dim=1)[:, -(conv_width - 1):].clone()


def _scan(delta: Tensor, uf: Tensor, A: Tensor, Bmat: Tensor, Cmat: Tensor,
          h0: Tensor, *, impl: str, chunk: int, scan_dtype: torch.dtype):
    if impl == "kernel":
        return ops.mamba_scan_op(delta, uf, A.float(), Bmat, Cmat, h0)
    if impl == "bypass":
        # the dry-run's stand-in (JAX "bypass"): shapes and dtypes, no
        # recurrence
        y = delta * uf * torch.sum(Bmat * Cmat, -1, keepdim=True)
        h = h0 + torch.einsum("bsc,bsn->bcn", delta * uf, Bmat) * 0.0
        return y, h
    return _chunked_selective_scan(delta, uf, A, Bmat, Cmat, h0, chunk,
                                   scan_dtype)


def mamba_apply(
    p: dict[str, Tensor],
    x: Tensor,                      # (B, S, d_model)
    *,
    d_state: int,
    conv_width: int = 4,
    chunk: int = 256,
    cache: dict[str, Tensor] | None = None,
    impl: str = "scan",             # "scan" | "kernel" | "bypass" (dry-run)
    scan_dtype: torch.dtype = torch.float32,
    ctx=None,
) -> tuple[Tensor, dict[str, Tensor] | None]:
    """Mamba-1 mixer.  With ``cache`` (dict h/conv) it runs as an
    incremental segment and stores the new state and conv tail in that
    dict.  Returns (output, the cache or None).

    Under a mesh (``ctx``, DTensor activations) the d_inner channels shard
    over tp: ``in_proj``'s ``2 d_inner`` product is resharded before the
    split into x and z (a local split of the sharded product would hand
    all of x to the first half of the ranks), the conv and the scan (K10
    on the local channels) run on each rank's shard with no collective,
    and ``x_proj``'s contraction over the sharded channels is reduced
    before dt, B and C are read.
    """
    if impl not in ("scan", "kernel", "bypass"):
        raise ValueError(f"unknown ssm impl {impl!r}")
    B, S, _ = x.shape
    dt = x.dtype
    d_inner = p["out_proj"].shape[0]
    dt_rank = p["dt_proj"].shape[0]

    xz = x @ p["in_proj"].to(dt)                       # (B, S, 2*din)
    if ctx is not None:   # d_inner channels over tp: zero-collective scan
        xz = ctx.con(xz, "dp", None, "tp")
    xi, z = torch.chunk(xz, 2, dim=-1)
    prev = cache["conv"] if cache is not None else None
    if ctx is None:
        u, tail = _conv_silu(xi, p["conv_w"], p["conv_b"], prev,
                             conv_width, cache is not None)
    else:
        from repro_torch.distributed.sharding import shard_map_compat

        xi = ctx.con(xi, "dp", None, "tp")
        z = ctx.con(z, "dp", None, "tp")
        cpl = tuple(xi.placements)
        u, tail = shard_map_compat(
            lambda *a: _conv_silu(*a, conv_width, cache is not None),
            mesh=ctx.mesh,
            in_specs=(cpl, tuple(p["conv_w"].placements),
                      tuple(p["conv_b"].placements),
                      None if prev is None else cpl),
            out_specs=[cpl, None if prev is None else cpl])(
                xi, p["conv_w"], p["conv_b"], prev)

    proj = u @ p["x_proj"].to(dt)                      # (B, S, dtr + 2n)
    if ctx is not None:   # the contraction over sharded channels: reduce
        proj = ctx.con(proj, "dp", None, None)
    dt_raw = proj[..., :dt_rank]
    Bmat = proj[..., dt_rank:dt_rank + d_state].float().contiguous()
    Cmat = proj[..., dt_rank + d_state:].float().contiguous()
    delta = F.softplus((dt_raw @ p["dt_proj"].to(dt)).float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])                         # (din, n)
    uf = u.float()

    if cache is not None:
        h0 = cache["h"]
    else:
        h0 = torch.zeros((B, d_inner, d_state), dtype=torch.float32,
                         device=x.device)
    if ctx is None:
        y, h = _scan(delta, uf, A, Bmat, Cmat, h0, impl=impl, chunk=chunk,
                     scan_dtype=scan_dtype)
    else:
        from repro_torch.distributed.sharding import shard_map_compat

        delta = ctx.con(delta, "dp", None, "tp")
        uf = ctx.con(uf, "dp", None, "tp")
        h0 = ctx.con(h0, "dp", "tp", None)
        cpl, bpl = tuple(uf.placements), tuple(Bmat.placements)
        y, h = shard_map_compat(
            lambda *a: _scan(*a, impl=impl, chunk=chunk,
                             scan_dtype=scan_dtype), mesh=ctx.mesh,
            in_specs=(cpl, cpl, tuple(A.placements), bpl, bpl,
                      tuple(h0.placements)),
            out_specs=[cpl, tuple(h0.placements)])(
                delta, uf, A, Bmat, Cmat, h0)
    y = y + uf * p["D"]
    y = y.to(dt) * F.silu(z)
    if ctx is not None:
        y = ctx.con(y, "dp", None, "tp")
    out = y @ p["out_proj"].to(dt)
    if ctx is not None:
        out = ctx.con(out, "dp", None, None)

    if cache is not None:
        cache["conv"] = tail
        cache["h"] = h
    return out, cache


def init_mamba_cache(batch: int, d_inner: int, d_state: int,
                     conv_width: int = 4, dtype=torch.bfloat16,
                     device=None) -> dict[str, Tensor]:
    return {
        "h": torch.zeros((batch, d_inner, d_state), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((batch, conv_width - 1, d_inner), dtype=dtype,
                            device=device),
    }
