"""K9 wrapper: fused attention forward on the card
(csrc/flash_attention.cu), in three forms: two for head dims up to 256,
chosen by the input type, and a wide form for any head dim past 256.

Replaces ``src/repro/kernels/flash_attention.py:flash_attention_pallas``
(``_flash_fwd_kernel``).  Bound on this card: operations, 4 D per
unmasked (query head, key) pair (two products of D multiply-adds); at
gemma2-2b's B = 2, S = 8192, Hq = 8, Hkv = 4, D = 256 a global layer is
~0.55 TFLOP against ~0.2 GB of q, k, v and o.  Both forms fold the g
query heads of a kv head into a block's rows and skip key tiles outside
the causal wedge or the window.

- bfloat16 (launch count ``flash_attention``): tensor cores.  Blocks of
  128 folded rows in two consumer warpgroups, S = Q K^T and O += P V on
  ``wgmma`` with f32 accumulators, K/V tiles of 64 keys by TMA into a
  two-stage ring, the online softmax in registers, P rounded to bf16 for
  the PV product.
- float32 (``flash_attention_f32``): CUDA cores in f32, blocks of 64
  rows, key tiles of 32 in shared memory; the f32 tolerance (1e-4) is
  below what bf16 or TF32 products reach.
- D > 256, float32 or bfloat16, in f32 on CUDA cores: both forms above
  keep a block's rows in shared memory sized by D.  Up to
  ``MAX_WIDE_ONE_PASS`` = 1024 (``flash_attention_wide``, one launch): one
  pass over a thread-block cluster of ``ceil(D / 128)`` blocks, each
  holding 128 columns of the query tile, its partial scores summed
  through distributed shared memory in rank order, so every score is
  computed once and every block of the cluster runs the same softmax on
  its slice of O.  Past it (``flash_attention_wide_2pass``, one count per
  call of its two kernels): two passes with shared memory fixed in D, the
  first taking each row's softmax max and sum, the second recomputing the
  scores for its own 128 output columns.  bf16 inputs are read as bf16
  and the output rounded to bf16 once.  No configuration reaches either
  (gemma2-2b's d_head 256 is the largest).

The wrapper takes what the kernels do not, exactly: a group of more than
``MAX_GROUP`` query heads per kv head runs in launches of at most that
many heads of each group; in bfloat16, a head dim that is not a multiple
of 8 (the TMA's row stride) runs on copies zero-padded to the next
multiple of 8, with the true ``D ** -0.5`` scale, and the output is cut
back; storage that is not 16-byte aligned runs on an aligned copy (neither
applies to the wide form, which reads unaligned storage element by
element).

Forward only: inputs that require a gradient are refused (training,
ROADMAP Queue 1 item 13(b), is to recompute through the plain version,
as ``repro.kernels.ops._fa_bwd`` does).
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
# the largest head dim of the f32 and bf16 forms; past it the wide form
MAX_HEAD_DIM = 256
# the largest head dim of the wide form's one pass (8 blocks of 128
# columns, the portable cluster size); past it the two-pass form
MAX_WIDE_ONE_PASS = 1024
_DTYPES = (torch.float32, torch.bfloat16)


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
    query-head groups, running the wide form past ``MAX_HEAD_DIM`` and
    padding or copying bf16 operands as the other forms need."""
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
    bf16 = q.dtype == torch.bfloat16
    if D > MAX_HEAD_DIM:
        lib = _build.library()
        args = (B, Sq, k.shape[1], Hq, Hkv, D, int(bool(causal)),
                0 if window is None else int(window),
                0.0 if score_cap is None else float(score_cap), float(scale),
                int(bf16), stream_ptr(q.device))
        if D <= MAX_WIDE_ONE_PASS:
            name = "flash_attention_wide"
            rc = lib.flash_attention_wide_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                *args)
        else:
            # each row's softmax max and sum, from the first pass to the
            # second
            ml = torch.empty((2, B, Sq, Hq), dtype=torch.float32,
                             device=q.device)
            name = "flash_attention_wide_2pass"
            rc = lib.flash_attention_wide_2pass_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                ml.data_ptr(), *args)
        _build.check(rc, name)
        _build.COUNTS[name] += 1
        return
    if bf16 and D % 8:
        # zero columns add nothing to q k^T; v's zero columns are cut off
        pad = (0, -D % 8)
        qp, kp, vp = (F.pad(x, pad) for x in (q, k, v))
        op = torch.empty_like(qp)
        _attend(qp, kp, vp, op, causal, window, score_cap, scale)
        out.copy_(op[..., :D])
        return
    if bf16:
        # the TMA reads 16-byte aligned storage (out is always fresh)
        q, k, v = (x.clone() if x.data_ptr() % 16 else x for x in (q, k, v))
    lib = _build.library()
    launch, name = ((lib.flash_attention_bf16_launch, "flash_attention")
                    if bf16 else
                    (lib.flash_attention_f32_launch, "flash_attention_f32"))
    _build.check(launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq,
        k.shape[1], Hq, Hkv, D, int(bool(causal)),
        0 if window is None else int(window),
        0.0 if score_cap is None else float(score_cap), float(scale),
        stream_ptr(q.device)), name)
    _build.COUNTS[name] += 1
