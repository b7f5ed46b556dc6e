"""Mixture-of-Experts FFN (port of ``repro.models.moe``).

The port runs on one device, so the expert axis holds every padded
expert (JAX's ``El = E_padded``, ``e0 = 0``) and JAX's ``psum`` over it
is the identity: this is the computation of JAX's ``mesh=None`` path.
Expert parallelism over ranks waits for ``distributed/sharding.py``
(ROADMAP Queue 1, distributed LM and launch).

Routing keeps the reference's discrete choices exactly:
  * top-k by a stable descending sort of the router probabilities, so an
    exact tie goes to the lower expert index, as ``lax.top_k`` does;
  * GShard capacity ``ceil(T k / n_real * capacity_factor)`` per expert,
    positions in an expert by flat assignment index ``t * k + j`` (a
    stable ``argsort``); an assignment past capacity is dropped (its
    weight is 0 and it writes no expert row);
  * padded experts get logits of -1e30 before the softmax.
The expert products are ``torch.bmm`` over ``(E, cap, d)`` buffers, as
JAX's ``einsum``s; the combine adds a token's k contributions one by
one in ascending expert order (no atomics), so a run on the card is
repeatable.
"""

from __future__ import annotations

import math

import torch

from repro_torch.models.layers import (activation, lecun_normal, mlp_apply,
                                       mlp_init)

Tensor = torch.Tensor


def moe_init(gen: torch.Generator, device, d_model: int, d_expert: int,
             n_experts_padded: int, n_shared: int,
             act: str) -> dict[str, Tensor]:
    """Parameters sized for the padded expert count, in JAX's shapes:
    ``router`` (d, E), ``wi`` / ``wg`` (E, d, f), ``wo`` (E, f, d) and,
    with shared experts, ``shared`` = a dense MLP of width
    ``n_shared * d_expert``."""
    ep = n_experts_padded
    p = {
        "router": lecun_normal((d_model, ep), gen, device),
        "wi": lecun_normal((ep, d_model, d_expert), gen, device),
        "wg": lecun_normal((ep, d_model, d_expert), gen, device),
        "wo": lecun_normal((ep, d_expert, d_model), gen, device),
    }
    if n_shared:
        p["shared"] = mlp_init(gen, device, d_model, n_shared * d_expert, act)
    return p


def route(xt: Tensor, router: Tensor, top_k: int,
          n_real: int) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """The router: f32 logits of ``xt @ router`` (padded experts at
    -1e30), their softmax, and its top k, ties to the lower expert index.
    Returns (logits (T, E), probs, renormalised gates (T, k), expert ids
    (T, k))."""
    logits = (xt @ router.to(xt.dtype)).float()
    E = logits.shape[1]
    if n_real < E:
        pad = torch.arange(E, device=xt.device) >= n_real
        logits = torch.where(pad[None, :], -1e30, logits)
    probs = torch.softmax(logits, dim=-1)
    w, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, ids = w[:, :top_k], ids[:, :top_k]
    w = w / torch.clamp(torch.sum(w, -1, keepdim=True), min=1e-9)
    return logits, probs, w, ids


def _routed(xt: Tensor, router: Tensor, wi: Tensor, wg: Tensor, wo: Tensor,
            *, top_k: int, n_real: int, capacity_factor: float,
            act: str, with_aux: bool) -> tuple[Tensor, Tensor | None]:
    """``_routed_local`` of the reference on one device (every expert
    local): (y (T, d), aux, or None without ``with_aux``)."""
    T, d = xt.shape
    E = wi.shape[0]
    dt = xt.dtype
    logits, probs, w, ids = route(xt, router, top_k, n_real)

    flat_ids = ids.reshape(-1)                                  # (T*k,)
    flat_w = w.reshape(-1)
    order = torch.argsort(flat_ids, stable=True)
    sids = flat_ids[order]
    pos = (torch.arange(T * top_k, device=xt.device)
           - torch.searchsorted(sids, sids, right=False))
    cap = int(math.ceil(T * top_k / n_real * capacity_factor))
    local = pos < cap
    dest = torch.where(local, sids * cap + pos, E * cap)         # drop row
    src_tok = order // top_k

    # the expert buffers: slot (e, c) holds the token routed there, or a
    # zero row (index T) when the slot is empty.  Dropped assignments all
    # write the spare slot E * cap, which is cut off (a boolean-mask index
    # would wait for the device to count the kept ones, every layer)
    slot_tok = torch.full((E * cap + 1,), T, dtype=torch.long,
                          device=xt.device)
    slot_tok.scatter_(0, dest, src_tok)
    xz = torch.cat([xt, xt.new_zeros(1, d)])
    eb = xz[slot_tok[:E * cap]].reshape(E, cap, d)
    h = torch.bmm(eb, wi.to(dt))
    g = torch.bmm(eb, wg.to(dt))
    out = torch.bmm(activation(act)(g) * h, wo.to(dt)).reshape(E * cap, d)

    contrib = out[torch.clamp(dest, max=E * cap - 1)]
    contrib = contrib * (flat_w[order] * local)[:, None].to(dt)
    # back to (T, k) in assignment order, then each token's k terms added
    # in ascending expert order (the order of the reference's scatter-add
    # over the expert-sorted assignments)
    per_tok = torch.empty_like(contrib)
    per_tok[order] = contrib
    per_tok = per_tok.reshape(T, top_k, d)
    by_expert = torch.argsort(ids, dim=1)
    per_tok = torch.gather(per_tok, 1, by_expert[..., None].expand(-1, -1, d))
    y = xt.new_zeros(T, d)
    for j in range(top_k):
        y = y + per_tok[:, j]
    if not with_aux:
        return y, None

    # aux losses: load balance + z-loss, in f32
    me = torch.mean(probs, dim=0)                               # (E,)
    one_hot_top1 = (ids[:, :1] == torch.arange(E, device=xt.device)).float()
    ce = torch.mean(one_hot_top1, dim=0)
    aux = n_real * torch.sum(me * ce) + 1e-3 * torch.mean(
        torch.logsumexp(logits, -1) ** 2)
    return y, aux


def moe_apply(p: dict[str, Tensor], x: Tensor, *, top_k: int, n_real: int,
              act: str, capacity_factor: float = 1.25,
              with_aux: bool = True) -> tuple[Tensor, Tensor | None]:
    """MoE FFN of ``x`` (B, S, d): the routed experts plus, where the
    parameters have them, the shared experts.  Returns (output, aux loss;
    None without ``with_aux``, which skips computing it: a prefill or a
    decode step reads no aux)."""
    B, S, d = x.shape
    y, aux = _routed(x.reshape(B * S, d), p["router"], p["wi"], p["wg"],
                     p["wo"], top_k=top_k, n_real=n_real,
                     capacity_factor=capacity_factor, act=act,
                     with_aux=with_aux)
    y = y.reshape(B, S, d)
    if "shared" in p:
        y = y + mlp_apply(p["shared"], x, act)
    return y, aux
