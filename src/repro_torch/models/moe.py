"""Mixture-of-Experts FFN with expert parallelism over the ``model`` axis
(port of ``repro.models.moe``).

Without a mesh the expert axis holds every padded expert on one device
(JAX's ``mesh=None`` path: ``El = E_padded``, ``e0 = 0``, the ``psum``
the identity).  Under a mesh the routed path is the reference's
``shard_map`` island (``distributed.sharding.shard_map_compat``):

  * tokens stay on their (pod, data) shard, replicated across ``model``
    (or replicated everywhere when ``B * S`` does not divide the data
    axes, as a decode step's do);
  * model rank r owns ``El = E_padded / tp`` experts from ``e0 = r El``
    and processes the capacity-limited slice of its local tokens routed
    to them; the capacity comes from the local token count, as in JAX;
  * the partial outputs are summed over ``model`` (a ``Partial``
    placement, reduced after the island) and the aux loss is averaged
    over the data axes.

Routing keeps the reference's discrete choices exactly:
  * top-k by a stable descending sort of the router probabilities, so an
    exact tie goes to the lower expert index, as ``lax.top_k`` does;
  * GShard capacity ``ceil(T k / n_real * capacity_factor)`` per expert,
    positions in an expert by flat assignment index ``t * k + j`` (a
    stable ``argsort``); an assignment past capacity is dropped (its
    weight is 0 and it writes no expert row);
  * padded experts get logits of -1e30 before the softmax.
The expert products are ``torch.bmm`` over ``(El, cap, d)`` buffers, as
JAX's ``einsum``s; the combine adds a token's k contributions one by
one in ascending expert order (no atomics), so a run on the card is
repeatable.  A rank adds zeros for the experts it does not own, so with
top-2 routing the rank-order sum of the partial outputs adds the same
terms in the same order as one device does.
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
            act: str, with_aux: bool,
            e0: int = 0) -> tuple[Tensor, Tensor | None]:
    """``_routed_local`` of the reference: the local tokens ``xt`` through
    the ``El = wi.shape[0]`` local experts from ``e0`` (every expert on one
    device).  Returns (y (T, d), this rank's summand of the output; aux, or
    None without ``with_aux``)."""
    T, d = xt.shape
    E = wi.shape[0]           # the local experts (El in the reference)
    dt = xt.dtype
    logits, probs, w, ids = route(xt, router, top_k, n_real)

    flat_ids = ids.reshape(-1)                                  # (T*k,)
    flat_w = w.reshape(-1)
    order = torch.argsort(flat_ids, stable=True)
    sids = flat_ids[order]
    pos = (torch.arange(T * top_k, device=xt.device)
           - torch.searchsorted(sids, sids, right=False))
    cap = int(math.ceil(T * top_k / n_real * capacity_factor))
    local = (sids >= e0) & (sids < e0 + E) & (pos < cap)
    dest = torch.where(local, (sids - e0) * cap + pos, E * cap)  # drop row
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
    one_hot_top1 = (ids[:, :1] == torch.arange(
        probs.shape[1], device=xt.device)).float()
    ce = torch.mean(one_hot_top1, dim=0)
    aux = n_real * torch.sum(me * ce) + 1e-3 * torch.mean(
        torch.logsumexp(logits, -1) ** 2)
    return y, aux


def moe_apply(p: dict[str, Tensor], x: Tensor, *, top_k: int, n_real: int,
              act: str, capacity_factor: float = 1.25,
              with_aux: bool = True, mesh=None, ep_axis: str = "model",
              dp_axes: tuple[str, ...] = ("data",),
              ctx=None) -> tuple[Tensor, Tensor | None]:
    """MoE FFN of ``x`` (B, S, d): the routed experts plus, where the
    parameters have them, the shared experts (dense TP under a mesh).
    Returns (output, aux loss; None without ``with_aux``, which skips
    computing it: a prefill or a decode step reads no aux).  With
    ``mesh`` (DTensor ``x`` and parameters) the routed experts run as the
    expert-parallel island over ``ep_axis``."""
    B, S, d = x.shape
    opts = dict(top_k=top_k, n_real=n_real, capacity_factor=capacity_factor,
                act=act, with_aux=with_aux)
    if mesh is None:
        y, aux = _routed(x.reshape(B * S, d), p["router"], p["wi"], p["wg"],
                         p["wo"], **opts)
    else:
        y, aux = _routed_island(p, x.reshape(B * S, d), mesh, ep_axis,
                                dp_axes, opts)
    y = y.reshape(B, S, d)
    if "shared" in p:
        y = y + mlp_apply(p["shared"], x, act, ctx=ctx)
    return y, aux


def _routed_island(p: dict[str, Tensor], xt: Tensor, mesh, ep_axis: str,
                   dp_axes: tuple[str, ...], opts: dict):
    """The routed experts as ``shard_map``'s island (JAX
    ``moe.py:126-193``): tokens over the data axes (replicated when they
    do not divide), the experts over ``ep_axis``, the outputs summed over
    it, the aux loss averaged over the data axes."""
    from repro_torch.distributed.sharding import (axis_names, mesh_axes,
                                                  placements, scale_grad,
                                                  shard_map_compat)

    sizes = mesh_axes(mesh)
    dp = tuple(a for a in dp_axes if a in axis_names(mesh))
    dp_size = math.prod(sizes[a] for a in dp)
    if xt.shape[0] % dp_size:
        dp = ()
        dp_size = 1
    ep_size = sizes.get(ep_axis, 1)
    tok = (dp or None, None)

    def island(xt, router, wi, wg, wo):
        rank = mesh.get_local_rank(ep_axis) if ep_size > 1 else 0
        y, aux = _routed(xt, router, wi, wg, wo, e0=rank * wi.shape[0],
                         **opts)
        if aux is not None:
            # every model rank computes the whole aux; its gradient is
            # summed over them with the experts' partial ones
            aux = scale_grad(aux, 1.0 / ep_size)
            if dp:      # this rank's summand of the mean over the data axes
                aux = aux / dp_size
        return y, aux

    experts = (ep_axis if ep_size > 1 else None, None, None)
    y, aux = shard_map_compat(
        island, mesh=mesh,
        in_specs=(tok, (None, None), experts, experts, experts),
        out_specs=[placements(mesh, tok, partial=(ep_axis,)),
                   placements(mesh, (), partial=dp)
                   if opts["with_aux"] else None])(
            xt, p["router"], p["wi"], p["wg"], p["wo"])
    y = y.redistribute(mesh, placements(mesh, tok))
    if aux is not None:
        aux = aux.redistribute(mesh, placements(mesh, ()))
    return y, aux
