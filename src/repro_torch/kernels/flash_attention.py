"""K9 wrapper: fused attention forward on the card
(csrc/flash_attention.cu), in two forms, which ``k9_form(dtype, D)``
picks: the bf16 tensor-core form for bfloat16 inputs with head dims up to
``MAX_HEAD_DIM`` = 256, and the f32-arithmetic form for everything else.

Replaces ``src/repro/kernels/flash_attention.py:flash_attention_pallas``
(``_flash_fwd_kernel``).  Bound on this card: operations, 4 D per
unmasked (query head, key) pair (two products of D multiply-adds); at
gemma2-2b's B = 2, S = 8192, Hq = 8, Hkv = 4, D = 256 a global layer is
~0.55 TFLOP against ~0.2 GB of q, k, v and o.  Both forms fold the g
query heads of a kv head into a block's rows and skip key tiles outside
the causal wedge or the window.

- ``"bf16"`` (launch count ``flash_attention``): tensor cores.  Blocks of
  128 folded rows in two consumer warpgroups, S = Q K^T and O += P V on
  ``wgmma`` with f32 accumulators, K/V tiles of 64 keys by TMA into a
  two-stage ring, the online softmax in registers, P rounded to bf16 for
  the PV product.
- ``"f32"`` (launch count ``flash_attention_f32``, named for its
  arithmetic): every float32 call at any head dim, and bfloat16 past
  ``MAX_HEAD_DIM``, in f32 on CUDA cores (the f32 tolerance, 1e-4, is
  below what bf16 or TF32 products reach).  One launch: a thread-block
  cluster of up to 16 blocks splits D into 128-column chunks, each block
  holding one chunk of O, its partial scores summed through distributed
  shared memory in rank order, so every block that shares a row runs the
  same softmax; past D = 2048 the grid's z dimension splits O into groups
  of at most 2048 columns, each group computing the scores over all of D
  the same way.  bf16 inputs are read as bf16 and the output rounded to
  bf16 once.  These two counts are K9's only ones: the earlier
  ``flash_attention_wide`` and ``flash_attention_wide_2pass`` counts went
  with the forms this one replaced.

The wrapper takes what the kernels do not, exactly: a group of more than
``MAX_GROUP`` query heads per kv head runs in launches of at most that
many heads of each group; in the bf16 form, a head dim that is not a
multiple of 8 (the TMA's row stride) runs on copies zero-padded to the
next multiple of 8, with the true ``D ** -0.5`` scale, and the output is
cut back, and storage that is not 16-byte aligned runs on an aligned copy
(the f32-arithmetic form reads unaligned storage element by element).

Forward only: inputs that require a gradient are refused.  Training
reaches the kernel through ``kernels.ops.flash_attention_op``'s autograd
Function, which hands it detached inputs and recomputes the backward
through the plain version, as ``repro.kernels.ops._fa_bwd`` does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels._launch import stream_ptr

Tensor = torch.Tensor

# query rows (query, head) of one block: a launch folds at most this many
# query heads of a kv head (g = Hq / Hkv)
MAX_GROUP = 64
# the largest head dim of the bf16 tensor-core form
MAX_HEAD_DIM = 256
_DTYPES = (torch.float32, torch.bfloat16)


def k9_form(dtype: torch.dtype, D: int) -> str:
    """K9's form for inputs of ``dtype`` and head dim ``D``: ``"bf16"``
    (tensor cores) for bfloat16 up to ``MAX_HEAD_DIM``, else ``"f32"``
    (f32 arithmetic on CUDA cores)."""
    return "bf16" if dtype == torch.bfloat16 and D <= MAX_HEAD_DIM else "f32"


def flash_attention_cuda(q: Tensor, k: Tensor, v: Tensor, causal: bool = True,
                         window: int | None = None,
                         score_cap: float | None = None) -> Tensor:
    """q ``(B, Sq, Hq, D)``, k and v ``(B, Skv, Hkv, D)`` (float32 or
    bfloat16, one type) ``-> (B, Sq, Hq, D)`` in q's type, on the card.
    Positions are implicit: query row i attends key rows ``<= i`` when
    ``causal`` and ``> i - window`` when ``window`` is set."""
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not isinstance(x, Tensor) or not x.is_cuda:
            raise ValueError(f"{name}: expected a CUDA tensor")
        if x.dim() != 4:
            raise ValueError(f"{name}: expected (B, S, H, D), got "
                             f"{tuple(x.shape)}")
        if x.dtype != q.dtype or x.dtype not in _DTYPES:
            raise ValueError(f"{name}: expected float32 or bfloat16 like q, "
                             f"got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous tensor")
        if x.device != q.device:
            raise ValueError(f"{name}: on {x.device}, expected {q.device}")
        if x.requires_grad:
            raise ValueError(f"{name}: the kernel is forward-only; its "
                             "input may not require a gradient")
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if tuple(k.shape) != (B, Skv, Hkv, D) or v.shape != k.shape:
        raise ValueError(f"k, v: expected shape {(B, Skv, Hkv, D)}, got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"Hq = {Hq} is not a multiple of Hkv = {Hkv}")
    if window is not None and window < 1:
        raise ValueError(f"window = {window}: expected None or >= 1")
    if score_cap is not None and not score_cap > 0:
        raise ValueError(f"score_cap = {score_cap}: expected None or > 0")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    _attend(q, k, v, out, causal, window, score_cap, D ** -0.5)
    return out


def _attend(q: Tensor, k: Tensor, v: Tensor, out: Tensor, causal: bool,
            window: int | None, score_cap: float | None,
            scale: float) -> None:
    """Write the attention of checked inputs into ``out``, splitting the
    query-head groups, in the form ``k9_form`` picks, padding or copying
    the bf16 form's operands as it needs."""
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    g = Hq // Hkv
    if g > MAX_GROUP:
        # heads [j0, j1) of every group: a contiguous (B, Sq, Hkv * gc, D)
        # copy, whose group of gc heads attends kv head j as before
        parts = -(-g // MAX_GROUP)
        gc = -(-g // parts)
        q5 = q.view(B, Sq, Hkv, g, D)
        o5 = out.view(B, Sq, Hkv, g, D)
        for j0 in range(0, g, gc):
            j1 = min(j0 + gc, g)
            qs = q5[:, :, :, j0:j1].reshape(B, Sq, Hkv * (j1 - j0), D)
            os_ = torch.empty_like(qs)
            _attend(qs, k, v, os_, causal, window, score_cap, scale)
            o5[:, :, :, j0:j1] = os_.view(B, Sq, Hkv, j1 - j0, D)
        return
    if k9_form(q.dtype, D) == "f32":
        _build.check(_build.library().flash_attention_cuda_cores_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq,
            k.shape[1], Hq, Hkv, D, int(bool(causal)),
            0 if window is None else int(window),
            0.0 if score_cap is None else float(score_cap), float(scale),
            int(q.dtype == torch.bfloat16), stream_ptr(q.device)),
            "flash_attention_f32")
        _build.COUNTS["flash_attention_f32"] += 1
        return
    if D % 8:
        # zero columns add nothing to q k^T; v's zero columns are cut off
        pad = (0, -D % 8)
        qp, kp, vp = (F.pad(x, pad) for x in (q, k, v))
        op = torch.empty_like(qp)
        _attend(qp, kp, vp, op, causal, window, score_cap, scale)
        out.copy_(op[..., :D])
        return
    # the TMA reads 16-byte aligned storage (out is always fresh)
    q, k, v = (x.clone() if x.data_ptr() % 16 else x for x in (q, k, v))
    _build.check(_build.library().flash_attention_bf16_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq,
        k.shape[1], Hq, Hkv, D, int(bool(causal)),
        0 if window is None else int(window),
        0.0 if score_cap is None else float(score_cap), float(scale),
        stream_ptr(q.device)), "flash_attention")
    _build.COUNTS["flash_attention"] += 1
