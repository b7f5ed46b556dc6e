#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py            # one CUDA card, from the repo root
    python3 chip_smoke.py --profile  # also profile each path's warm search
                                     # (after the kernel checks), one
                                     # request of each LM and one warm
                                     # train step of each stepped case
    python3 chip_smoke.py --lm-only  # only the build and the LM requests
                                     # (7 and 7a), with their checks; no
                                     # result lines (with --profile, their
                                     # profiles)
    python3 chip_smoke.py --shapes-only  # only the build, train-moe (7b)
                                     # and the shapes phase (8a1b), with
                                     # their sizing and checks; no result
                                     # lines (with --profile, a profile of
                                     # the gemma2-2b prefill_32k cell and
                                     # of a train-moe step)

1. prints the card (``nvidia-smi`` name and power limit) and builds the
   nine CUDA sources of K1-K10 from ``src/repro_torch/csrc`` (``nvcc``,
   ``sm_90a``, one process per source), compiling the six redesigned
   sources once more with ``-Xptxas -v`` alongside; prints a ``ptxas:``
   line (registers and spill bytes of each instantiation of K4's and K6's
   warp form, of K10 and its wide-state form, of K7, of K8, of K2's full
   form and of K9's
   f32-arithmetic form, and the resident warps per SM of K4's, K6's,
   K10's, K7's and K9's f32-arithmetic form, whose blocks per SM it also
   prints; any spill fails);
2. drives the main path once at full size -- ``build_index`` ->
   ``classify`` (which runs ``nn_search``, guards on by default) on
   N = 16384 store series of length L = 512 (w = 51, V = 4, k = 1,
   Q = 256 queries) -- with every kernel's launch count set to 0 just
   before and read just after (K4 must have run in its warp form only),
   and records the inputs each kernel was given there (K2 runs one launch
   over the whole store per tier call); then searches again with K2
   launched per chunk of ``candidate_chunk`` candidates, the earlier
   dispatch (``_kernel_route`` patched), which must give the same ids,
   distances and ``n_dtw`` (so do the sketch and long paths);
3. checks the search: finite distances, neighbour ids equal to the
   kernel brute force for the first 64 queries and to a brute force
   through the plain DTW for the first 8, distances bit-equal;
4. drives the sketch path: ``build_index(sketch=16, calibrate=cfg,
   mask=True)`` -> ``classify`` -> a warm ``nn_search`` with
   ``cfg = EngineConfig(CascadeConfig(w=51, use_sketch=True),
   auto_plan=True)`` on N = 65536 store series (L = 512, Q = 256), counts
   set to 0 before the build and read after ``classify``; checks that
   K1-K4 (K4 in its warp form only) and K7 ran, ids equal the kernel
   brute force on 32 queries with distances bit-equal, and no guard
   tripped on either path (every violation counter 0, ``degraded`` 0, no
   ``GuardWarning``);
5. guard phase: ``faults.corrupt_dtw(scale=0.05)`` on 4 queries of the
   main-path store, first through the main path's own index (w = 51),
   where it prints the guards' verdict and the LB / DTW ratios that
   explain it, then through the store indexed at w = 0, where it must
   raise a ``GuardWarning``, trip admissibility, degrade once, and still
   return the brute-force neighbours (see ``guard_phase``);
6. drives the long path: ``build_index`` -> ``classify`` -> a warm
   ``nn_search`` on N = 1024 store series of length L = 17984 (the UEA
   EigenWorms length) under an unconstrained window (w = L, V = 4, k = 1,
   Q = 16), counts set to 0 before the build and read after
   ``classify`` (six warm searches: the first is the path's warm time,
   three run after the recorded DTW inputs are freed, and each reads
   its device span and its K5 device time);
   every DTW there runs in K5's form (a), "rows" (the band
   state does not fit K4's shared memory), so it must have launched and
   K4 (in any form) and K5's other forms not; ids and distances equal
   the kernel brute force for every query and no guard tripped;
6b. drives the wide path, the paper's large windows: ``build_index`` ->
   ``classify`` -> a warm ``nn_search`` (guards on) on the main path's
   store at w = 307 (0.6 L, wide-a) and w = 512 (L, wide-b), and on the
   long path's store at w = 3596 (0.2 L, wide-c), each case in its own
   count window (the ``kernels`` line sums them); every DTW there runs in
   K4's slots form, never its warp or block form nor K5; ids equal the
   kernel brute force (64 queries of the main store, all 16 of the long
   one) with distances bit-equal, no guard trips, ``degraded`` 0; the
   warm search runs once more with K4 forced into its block form, outside
   the windows, and must return the same ids, distances and n_dtw; one
   ``wide path:`` line a case, with both warm walls (with ``--profile``,
   a profile of wide-b's and wide-c's warm search, taken after the kernel
   checks of 8: a profiler session of a whole search before them left
   the short sessions of ``device_ms`` seeing no kernel);
6c. drives the dense path, the unstaged search (``CascadeConfig(
   staged=False)``: ``dense_plan`` scores every pair with K2's full form,
   the paper's baseline): ``build_index`` -> ``classify`` -> a warm
   ``nn_search`` (guards on) on the main store at w = 51 (dense-a) and
   w = L (dense-b), and on the sketch store with the sketch tier under its
   build-time mask (dense-c, ``build_index(sketch=16, calibrate=<the sketch
   path's staged config>, mask=True)``), each case in its own count window;
   the warm search must launch K2's full form (count ``lb_enhanced_full``)
   and not its bands form, give ids and distances equal to the staged
   search on the same index and to the kernel brute force (64 queries),
   trip no guard, ``degraded`` 0; one ``dense path:`` line a case with
   both mean ``n_dtw`` (with ``--profile``, a profile of dense-a's warm
   search, after the kernel checks of 8); no other path may launch the
   full form;
7. LM serve phase, at full width with random weights drawn on the card
   from a seed (bf16 compute and KV cache), each request in its own
   launch-count window: gemma2-2b (26 layers) scores 2 prompts of 8192
   with ``LM.prefill`` into a full cache (K9 in every layer: 26
   launches), then ``greedy_decode`` continues 4 prompts of 1024 by 32
   tokens (cache S + 32, so K9 never runs); falcon-mamba-7b (64 layers)
   ``greedy_decode``s 4 prompts of 2048 by 32 tokens and ``LM.prefill``s
   the same prompts (K10: 64 per prefill, 0 per step).  Checks: the
   launch counts, finite logits and tokens in ``[0, vocab)``; each
   kernel-routed prefill against the plain route (``attn_impl=
   "chunked"``, ``ssm_impl="scan"``) and each model's first decode step
   against a full-cache prefill of prompt + token, in f32 compute to
   rtol 1e-3, atol 1e-3 and in bf16 to a fixed largest difference per
   model (see ``LM_BF16_MAX_ABS``); prints one ``lm request``
   line per request (prefill seconds, prompt and decode tokens/s,
   launches, peak device memory, the checks' readings);
7a. the MoE, hybrid, VLM and audio requests (``run_lm_families``), each
   in its own launch-count window: moe-qwen (qwen2-moe-a2.7b unmodified,
   its bf16 tree built a layer at a time) and moe-deepseek
   (deepseek-moe-16b at 4 layers) score 2 x 8192 in a full cache (K9 an
   attention layer) and ``greedy_decode`` 4 x 1024 + 32 (no kernel);
   hybrid-jamba (jamba-1.5-large-398b at full width, its first period's
   layers 0-4: Mamba at 0-3 with MoE at 1 and 3, attention at 4)
   ``greedy_decode``s 2 x 8192 + 16 (K10 a Mamba layer) and prefills the
   same prompts in a full cache (K9 and K10); audio-hubert (hubert-xlarge
   unmodified) prefills 2 x 8192 frames (K9 non-causal at D = 80, 48
   launches; ``decode_step`` must refuse); vlm-qwen2vl (qwen2-vl-72b at 2
   layers) prefills 2 x 8192 with a 1024-patch ``vision_embeds`` prefix
   and (B, 3, S) M-RoPE streams, then steps a ``DecodeSession`` 32 times.
   Checks: the launch counts, finite logits and tokens in ``[0, vocab)``,
   the kernel route against the plain route in bf16 (``LM_BF16_MAX_ABS``,
   beside the reading of two plain routes that differ in chunk size) and
   in f32 (``LM_F32_TOL``; the MoE models on a 2-layer cut at full
   width, jamba's Mamba + MLP and Mamba + MoE layers, drawn after its
   served tree is freed), the MoE models' routing agreement between the
   routes, and the
   first decode step: for a model with MoE layers the kernel route's step
   against the plain route's (a step's capacity drops what a prefill
   keeps), for qwen2-vl-72b against a full-cache prefill of prompt +
   token; one ``lm request`` line each, with the prefill's FLOP bound
   (the routed experts' kept rows, as routed in this run) and the MoE
   decode step's least bytes (the experts this run's steps route to),
   each beside the dense formulation's cost (every padded expert, every
   capacity slot);
8. holds each kernel against its plain PyTorch version on the card: at the
   paths' recorded inputs (timed with CUDA events) and over a sweep of
   small shapes (w in {0, 1, L/4, L}, odd L, cutoffs that kill pairs,
   ``live`` masks with all-dead tiles, ragged sizes); K2 at the path's
   whole-store launch, at the earlier chunk shape (C = 512) and as the
   earlier chunked tier call (32 launches and a ``torch.cat``); K2's full
   form at dense-a's tier call (with and without a live mask) and dense-c's
   (under the store's mask) against the plain version over chunks of 512
   candidates, over a sweep (nb = 0, 1, 4, 8, 9 and L / 2, ragged Q, C and
   L, lo > u, NaN and +-inf envelopes, L = 17984), its bands part (infinite
   envelopes) bit-equal to the bands form and K8 bit-equal to it at V = 0,
   with its issue floor; K7 also at Q
   = 257, N = 65541 and on int8 storage off 16-byte alignment, with its
   issue floor (7 FP32 instructions per (q, n, j) at 128 lanes an SM a
   clock, the card's maximum SM clock); K4 and K6 in their three forms
   at the main path's input (the slots and block forms forced, the forms
   timed in turns), in the slots form on wide-b's and wide-c's largest
   rounds beside the block form and K5's rows form forced (all three
   bit-equal, timed in turns; the slots form against the plain version
   on wide-b's round and on pairs of wide-c's), and in every form that
   holds the band over the sweep, which crosses the warp form's edge (wb = 255 /
   256), runs the slots form in one warp and in several and runs row
   blocks of 7, and in the slots form's cluster of two blocks (wb = 8300,
   17 warps), K4 and K6 with cutoffs and without; K1, K2 (both
   forms) and K3 (both forms) also at the long path's inputs; K5 in each of its
   three forms just over the K4/K5 crossover (a plain run without
   cutoffs, whose values set cutoffs that spare one pair and kill the
   other mid-sweep in a second plain run), on the long
   path's largest round with its cutoffs (form (a), and (b) and (c)
   forced) and form (a) on pairs of all its rounds, (a) at its edge (L =
   20480, w = L), (b) and (c) just past it (L = 20481; (b) in its 2
   blocks and in 3, 4 and 8; one plain run with cutoffs from the kernel's
   values at each), (b) at L = 65536, w = L timed in clusters of 3, 4
   and 8 blocks and (c) there, each held against one pair's plain run,
   and at its widest
   band (wb = 231423, 8 blocks, a cutoff that abandons at the first
   check); K6 at the main path's K4 inputs; K1 at L = 65536 with w
   in {655, 65536}. Envelopes, banded DTW (K4, K5, K6), the bands-only
   LB_ENHANCED and the sketch bound must be bit-equal, with the same +-inf
   positions; the full LB_ENHANCED forms and LB_Keogh agree to rtol 1e-5,
   atol 1e-6 (their L-term sums run in another order); K9 (bf16: tensor
   cores; f32: CUDA cores) at a local and a global layer of the scoring
   prefill (and without the cap, beside ``F.scaled_dot_product_attention``
   as the library time, for the local layer with a boolean window mask),
   its f32 form at the global layer's inputs in f32, at layer 0 of
   qwen2-moe-a2.7b's scoring prefill (MHA, D = 128, causal) and of
   hubert-xlarge's (D = 80, non-causal) beside SDPA, and over a sweep (g
   in {1, 2, 4, 8}, D in {64, 80, 96, 128, 256}, causal and not, window,
   cap, ragged S), each shape in its own type and in bf16, to rtol 1e-4,
   atol 1e-5 in f32 and 1e-2 in bf16, where the relative RMS error must
   also stay within 1e-2; K9 also at the shapes its wrapper repairs (g = 96 in f32
   and bf16, bf16 D = 100, bf16 storage off 16-byte alignment) and its
   f32-arithmetic form (every f32 call, and bf16 past D = 256: one
   cluster of ceil(D / 128) blocks up to D = 2048, column groups past it)
   beside SDPA in f32 at the global layer without the cap, at D = 320 and
   512 in f32 and bf16 against the plain version, at D = 512 (S = 2048),
   1100 and 2048 (S = 1024) in f32 with SDPA as the library time, and over
   a sweep of D in {64, 96, 200, 256} in f32 and {257, 320, 512, 1024,
   1100, 2048, 4100} in both types (each call one launch of
   ``flash_attention_f32``); K10 at a layer of the falcon prefill and
   over a sweep (N in {4, 16, 17, 32, 64, 128, 256}, ragged S and C,
   nonzero h0), bit-equal, and its wide-state form at N in {257, 512,
   1024} and at B = 4, S = 2048, C = 8192, N = 512, bit-equal; K8 also
   over tiles and chunks cut ragged, at L = 17984, on random walks and on
   envelopes with lo > u and +-inf bounds, with its issue floor;
7b. the train path (after the LM kernels' checks), each case in the
   train launch-count window from weights drawn on the card from
   ``LM_SEED`` (f32 at rest), batches from ``TokenPipeline(seed=0)``,
   AdamW at ``TRAIN_OPT``: train-gemma (gemma2-2b unmodified, bf16,
   remat, B = 1, S = 8192, 3 steps; K9 exactly 2 x 26 a step, the
   forward and remat's recompute), train-gemma-f32 (its width cut to 2
   layers, f32, one step's gradients; K9's f32-arithmetic form 2 x 2),
   train-falcon (falcon-mamba-7b at full width cut to 16 layers, S =
   2048, 3 steps; K10 2 x 16 a step) and train-moe (qwen2-moe-a2.7b's
   train_4k at full width, bf16, remat, S = 4096, 3 steps, its depth and
   batch sized by the dry-run (``start_sizing``: the largest depth that
   fits at batch 1 within ``SHAPES_MEM_SHARE`` of the card, then the
   largest batch there); K9 2 a layer a step); no other kernel may
   launch.  Step 1's loss and gradients on the kernel route are held
   against the plain route (``TRAIN_BF16_TOL``, ``TRAIN_F32_LEAF_REL_L2``)
   on parameters drawn before the optimizer state (the state is then
   drawn again from the same seed), and for a model with MoE layers the
   kernel route against itself run again (the routing's accumulating
   backwards: the drift held to ``TRAIN_BF16_TOL``); every loss must be
   finite; one ``train path:`` line a case with the losses, warm step
   wall, tokens/s, peak memory, each leaf's relative L2 gradient error
   and, but for train-falcon, the model FLOPs (``train_flop_per_token``,
   the routed experts only) and their utilisation of 989 TFLOP/s;
   train-moe's predicted state bytes must equal the card's and its
   predicted peak be at least ``DRYRUN_PEAK_MIN`` of the card's (one
   ``shapes:`` line) (with ``--profile``, a profile of one warm step of
   each stepped case);
8a1. the dryrun phase (``run_dryrun_phase``, after the train path and
   before ``init_world``, host only): ``launch.dryrun``'s memory dict over
   a one-rank fake world on the meta device for train-gemma (the plain
   routes), the gemma2-2b scoring prefill (the ``"bypass"`` attention
   where the card runs K9) and one step of its decode request, held
   against the card's readings of the same work (for the decode case,
   the peak of one step after the prefill): state and cache bytes equal
   exactly, the predicted peak at least ``DRYRUN_PEAK_MIN`` of
   ``max_memory_allocated`` less what was resident before the request,
   train-gemma's ``speed_of_light_s`` beside its warm step (the measured
   roofline fraction), the phase within ``DRYRUN_LIMIT_S``; one
   ``dryrun:`` line a case, with the card's name and power limit;
8a1b. the shapes phase (``run_shapes_phase``, after the dryrun phase and
   before ``init_world``): the repo's shapes at their own lengths, each
   sized by the dry-run in a worker process started before the LM phase
   (``start_sizing``, ``launch.dryrun.fit_cell``: the largest batch whose
   predicted peak, with what
   is resident, is within ``SHAPES_MEM_SHARE`` of the card; a cell that
   does not fit at batch 1 is printed and skipped), weights drawn on the
   card in bf16 at rest, in one launch-count window: gemma2-2b
   ``prefill_32k`` (``LM.prefill`` of B x 32768 into a full cache, K9 in
   all 26 layers; the kernel route against the plain route at B = 1 to
   ``LM_BF16_MAX_ABS``; K9 on that prefill's inputs of a local and a
   global layer against its plain version, timed beside its bound and
   SDPA) and ``decode_32k`` (``SHAPES_DECODE_STEPS`` steps against
   32768-slot caches drawn from the seed), falcon-mamba-7b
   ``prefill_32k`` (K10 in all 64 layers; its kernel route against the
   plain route on ``LM_F32_LAYERS`` layers at B = 1; K10 on layer 0's
   last ``SHAPES_K10_SLICE`` channels bit-equal to its plain version)
   with one decode step after it (the prefill's state continues) and
   ``decode_32k`` (``SHAPES_DECODE_STEPS`` steps at its sized batch, the
   SSM state drawn from the seed), and ``long_500k`` (a prefill at the
   largest power-of-two length that fits, then decode steps, then K10
   alone at (1, 524288, 8192, 16) on inputs drawn on the card, its last
   channels bit-equal to the plain version).  Every cell's predicted peak at least
   ``DRYRUN_PEAK_MIN`` of the card's, a decode cell's caches equal to
   the prediction; one ``shapes:`` line a cell (with ``--profile``, a
   profile of the gemma2-2b prefill); the window is the K9 / K10
   records' ``shapes_path_launches`` and their new readings their
   ``shapes`` key;
8a. the sharded lm phase (``run_sharded_lm``, after ``init_world``; NCCL
   refuses two ranks on one card, so the collectives of a real mesh are
   emulated in one process, and tests/test_torch_sharded_lm.py runs them
   over gloo): K9 on each rank's local heads of gemma2-2b's global layer
   (2 x 8192, Hq = 8, Hkv = 4, D = 256, bf16, cap 50; tp = 2 and 4 split
   the kv heads, tp = 8 replicates them and each rank reads the kv head of
   its q head) and of qwen2-moe-a2.7b's (Hq = Hkv = 16, D = 128; tp = 2,
   4, 8), K10 on each rank's channel slice of falcon-mamba-7b's layer
   (4 x 2048, C = 8192, N = 16; tp = 2, 4, 8, 16), concatenated as the
   collective would and bit-equal to the unsharded call, each local call
   timed beside its plain version, its bound and (K9) SDPA; the MoE island
   of each model rank of qwen2-moe-a2.7b's layer (2 x 8192 tokens, 64
   padded experts, tp = 2, 4, 8) summed in rank order against the
   one-device routed output (top-4: a token's terms split across ranks
   associate otherwise, so it is held to K9's bf16 tolerance and says
   why); then gemma2-2b at full width on the one-rank (1, 1) ``("data",
   "model")`` mesh (DTensor parameters, ``LM(mesh=...)``): its 2 x 8192
   scoring prefill's logits, and one train step's loss and gradients at 2
   layers, bit-equal to the unsharded LM's with the same K9 launches; then
   the launcher ``launch.train.main`` as train-gemma runs (gemma2-2b full,
   bf16, B = 1, S = 8192, 3 steps; K9 2 x 26 a step; its s/step beside the
   train path's) and its restart check at ``--preset reduced``: steps 1-4
   with ``--ckpt-every 2``, then a resume from a directory holding only
   step 2's checkpoint, whose losses must equal steps 3-4 at rtol 1e-5,
   and whose heartbeat holds the last step; one ``sharded lm emulation``,
   ``sharded lm mesh`` and ``sharded lm launcher`` line; its launch window
   (the mesh LM and the launcher, not the emulations) is the K9 / K10
   records' ``sharded_lm_path_launches``, and the emulations' timings
   their ``local_shards``;
8b. after the LM phase and every kernel's check and timing (a short
   profiler session after the paper path saw no kernel on the H100
   machine), drives the paper path, the paper's own cell
   (``configs/paper_dtw.py`` ``PAPER_SEARCH``) on one card: N = 2^20 store series of L = 512 (the
   store made by ``make_dataset`` in a background process started first,
   its host seconds printed apart), Q = 2048 queries, w = 154, V = 4,
   k = 1, ``candidate_chunk`` 512, ``verify_chunk`` 64, guards on:
   ``build_index`` -> ``make_distributed_search`` on a one-rank NCCL
   ``("data", "model")`` mesh -> the step over every query in blocks of
   512, counts set to 0 before the build and read after the step, then a
   warm repeat; ids and distances bit-equal to single-device
   ``nn_search`` over the same blocks for all 2048 queries and to the
   kernel brute force on 32 strided queries, no guard trip, only K1-K4
   launched (K4 in its warp form); one ``paper path:`` line (with
   ``--profile``, at the end of the run, a profile of a 128-query block's
   warm step on the store indexed again);
8c. drives the distributed sketch path: the sketch path's store through
   ``calibrate_distributed_plan`` -> ``make_distributed_search(
   with_sketch=True, plan=decision.plan, with_guards=True)`` on the same
   mesh, counts set to 0 before the calibration and read after the step;
   ids and distances equal to the sketch path's ``nn_search``, the merged
   guard vector clean with the echo check counted, K7 launched; one
   ``dist sketch path:`` line; then dense-dist: the main store at w = 51
   through ``make_distributed_search`` with the unstaged cascade on the
   same mesh, ids and distances equal to dense-a's ``nn_search``, the
   full form launched and the bands form not, its window added to the
   dense path's, one ``dense path:`` line; then K1-K4 at the paper path's
   inputs (``paper_path_*`` keys: K1 over the whole 2^20 store, K2's one
   launch over it for a query block, and K2's full form over the same
   block and store, timed with CUDA events and held against the plain
   version over its first 512 candidates; K3's and K4's largest calls),
   bit-equal (K3 and K2's full form within rtol 1e-5), and adds the
   paper and dist launch windows to the records;
8d. runs each ``examples_torch/`` script once at its defaults on the
   card (``train_lm.py`` for 20 steps), in a subprocess: it must exit 0
   and print its verdict as ``True``; one ``examples:`` line;
9. prints one ``{"kernels": [...]}`` line (K9's and K10's records with
   ``train_path_launches``, ``shapes_path_launches`` and
   ``sharded_lm_path_launches``) and, last,
   the device line
   ``{"ok": true, "device": {...}}``.

It runs with ``PYTORCH_CUDA_ALLOC_CONF=expandable_segments:True`` unless
the caller sets that variable (see ``main``).
Any failed check exits non-zero before the last line.  The script imports
nothing of the JAX package; without a CUDA device it exits 1.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM3 bytes/s, FP32 non-tensor
# FLOP/s, bf16 dense tensor-core FLOP/s
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
PEAK_BF16 = 989e12

# main-path configuration: the store is ~100 MB of f32 on the card with
# its two envelopes, the scale of the largest UCR training sets
MAIN = dict(n_classes=8, n_train_per_class=2048, n_test_per_class=32,
            length=512, seed=7)
# sketch-path store: 65536 series (~400 MB of f32 with the envelopes, a
# 2 MB int8 sketch), the scale at which the sketch tier and the store
# mask pay
SKETCH = dict(n_classes=8, n_train_per_class=8192, n_test_per_class=32,
              length=512, seed=7)
# long path: long series under an unconstrained window, N = 1024 series
# of the UEA EigenWorms length (~221 MB of f32 store and envelopes); the
# band half-width L - 1 = 17983 needs 288 KB of K4's band state per pair,
# past a block's shared memory, so every DTW runs in K5 (form (a), rows)
LONG = dict(n_classes=8, n_train_per_class=128, n_test_per_class=2,
            length=17984, seed=7)
# wide path: the paper's large windows on the main and long paths' stores
# (each indexed again at its window): Table III's w = 0.6 L and w = L
# (benchmarks/paper_tables.py WINDOW_FRACTIONS) at L = 512, and the UCR
# example's default w = 0.2 L (examples/ucr_classification.py) on the
# EigenWorms-length series; every band there (wb = 307, 511, 3596) is K4's
# slots form's.  Not cut.
WIDE = (("wide-a", "main", 0.6), ("wide-b", "main", 1.0),
        ("wide-c", "long", 0.2))
# queries of a main-store wide case held against the kernel brute force
# (all of the long store's 16)
WIDE_BRUTE_Q = 64
# dense path: the unstaged search (CascadeConfig(staged=False), the
# paper's dense LB_ENHANCED^V on every pair: K2's full form) on the main
# store at the main path's window (dense-a) and at w = L (dense-b, Table
# III's widest), and on the sketch store under its build-time mask with
# the sketch tier (dense-c); dense-dist runs dense-a through the
# distributed step on the one-rank NCCL mesh, after the paper path (the
# distributed paths come after every device_ms reading).  Not cut.
DENSE = (("dense-a", "main", 0.1), ("dense-b", "main", 1.0),
         ("dense-c", "sketch", 0.1))
DENSE_BRUTE_Q = 64
# paper path: the paper's own cell (configs/paper_dtw.py PAPER_SEARCH),
# N = 2^20 store series of L = 512 (2 GiB of f32, 6 GiB with the
# envelopes), Q = 2048 queries, w = 154 (0.3 L), V = 4, k = 1, through the
# distributed step on a one-rank NCCL mesh.  Not cut.  The step runs over
# query blocks of PAPER_BLOCK: a block's (Q, N) f32 bound matrix is 2 GiB
# (the whole batch's 8 GiB, several of them live at once, with (Q, N, 4)
# Kim terms).  At 128 queries a block (Q over the production mesh's
# 16-way model axis) the step peaked at 11.7 GiB and single-device
# nn_search at 19.7, with the device idle 0.44 of a block's step (PERF.md);
# 512 fits the card and takes a quarter of the rounds.
PAPER = dict(n_classes=8, n_train_per_class=131072, n_test_per_class=256,
             length=512, seed=7)
PAPER_BLOCK = 512
PAPER_BRUTE_Q = 32
# queries of the block --profile traces (a 512-query block's trace took
# minutes to summarise)
PAPER_PROFILE_Q = 128
# the examples_torch/ scripts and the exactness verdict each prints
EXAMPLES = {"quickstart.py": "every bound below DTW",
            "ucr_classification.py": "exact vs brute force",
            "distributed_search.py": "exact vs single-device brute force",
            "train_lm.py": "loss fell"}
# arguments past the defaults: 20 AdamW steps of CFG_100M (batch 8 x 256)
EXAMPLE_ARGS = {"train_lm.py": ["--steps", "20"]}
# LM serve phase: the repo's gemma2-2b and falcon-mamba-7b configurations
# at full width (all 26 and 64 layers), random weights drawn on the card
# from LM_SEED, bf16 compute and KV cache.  The scoring request is the
# repo's prefill_32k shape (32 x 32768) cut to 2 x 8192: twice gemma2's
# 4096 window, so its 13 local layers mask and skip key tiles.
LM_SEED = 0
LM_SCORE = dict(batch=2, prompt=8192)
LM_GEMMA = dict(batch=4, prompt=1024, new=32)
LM_FALCON = dict(batch=4, prompt=2048, new=32)
# Route and decode-step checks.  In f32 compute (the same f32 weights) the
# kernel route and the plain route differ only in the order of f32 sums
# and must agree to LM_F32_TOL.  In bf16 compute (the served
# configuration) every difference of summation order is rounded to bf16
# in every layer and carried through the depth: at full width two plain
# routes that differ only in their chunk sizes (KV chunk 1024 and 512,
# scan chunk 256 and 64) differ by 0.0469 (gemma2-2b) and 0.172
# (falcon-mamba-7b) in the last-token logits (PERF.md, section 6).  So a
# bf16 difference is held to a fixed largest absolute difference per
# model, about three times those readings.  The same reading (printed as
# bf16_plain_chunk_noise_max_abs; KV chunk 512, or a quarter of a shorter
# prompt) on one H100 80GB HBM3 (700 W), run_lm_families' requests:
# qwen2-moe-a2.7b 0.0781 (its two plain routes route 4.5 % of (token,
# layer) pairs to other experts), deepseek-moe-16b 0.0352, hubert-xlarge
# 0.0391, qwen2-vl-72b 0.0313; jamba-1.5-large-398b 0.0313 at full width,
# layers 0-4, 2 x 8192 (two bf16 ulps of its logits below 4, one of the
# largest, 4.375; at 2 x 2048 it read 0.0156), the kernel route 0.0313.
LM_F32_TOL = dict(rtol=1e-3, atol=1e-3)
LM_BF16_MAX_ABS = {"gemma2-2b": 0.15, "falcon-mamba-7b": 0.5,
                   "qwen2-moe-a2.7b": 0.25, "deepseek-moe-16b": 0.1,
                   "jamba-1.5-large-398b": 0.094, "hubert-xlarge": 0.12,
                   "qwen2-vl-72b": 0.1}
# The MoE, hybrid, VLM and audio requests (run_lm_families): qwen2-moe-a2.7b
# unmodified and deepseek-moe-16b score LM_SCORE and greedy_decode
# LM_MOE_DECODE; jamba-1.5-large-398b at full width and 5 layers
# greedy_decodes LM_JAMBA and prefills the same prompts; hubert-xlarge
# unmodified prefills
# LM_AUDIO frames; qwen2-vl-72b prefills LM_VLM (a vision prefix of 32 x 32
# patches, M-RoPE streams) and steps a DecodeSession.  The f32 route checks
# of the MoE models run LM_F32_LAYERS layers at full width.
LM_MOE_DECODE = dict(batch=4, prompt=1024, new=32)
LM_JAMBA = dict(batch=2, prompt=8192, new=16)
LM_AUDIO = dict(batch=2, frames=8192)
LM_VLM = dict(batch=2, prompt=8192, patches=1024, grid=32, steps=32)
LM_DEPTH = {"deepseek-moe-16b": 4, "qwen2-vl-72b": 2,
            "jamba-1.5-large-398b": 5}
LM_DEPTH_WHY = {
    "deepseek-moe-16b": "its dense prelude layer and 3 MoE layers, the "
                        "structure it adds to qwen2-moe-a2.7b, whose MoE "
                        "layers run at full depth",
    "jamba-1.5-large-398b": "its first period's layers 0-4 (Mamba at 0-3, "
                            "MoE at 1 and 3, attention at 4), 48 GB in "
                            "bf16; its 398B weights are ~800 GB",
    "qwen2-vl-72b": "its 72B weights are 144 GB in bf16"}
LM_F32_LAYERS = 2
# Train path: AdamW steps from weights drawn on the card from LM_SEED (f32
# at rest), batches from the port's TokenPipeline(seed=0).  train-gemma is
# gemma2-2b unmodified in bf16 with remat, S = 8192 (twice the window, as
# the scoring prefill); train-gemma-f32 its full width cut to 2 layers (one
# local, one global) in f32, one step's gradients; train-falcon
# falcon-mamba-7b at full width, depth cut 64 -> 16 (AdamW's 16 bytes a
# parameter for 64 layers, ~115 GB, exceed the card's 80 GB); train-moe
# qwen2-moe-a2.7b's train_4k (S = 4096, B cut from 256) at full width, in
# bf16 with remat and AdamW (dryrun.opt_config_for's pick below 1e11
# parameters), its depth and batch sized by the dry-run (``sized``: the
# largest depth that fits at batch 1, then the largest batch there; its
# 24 layers' AdamW state alone is ~230 GB).
TRAIN_CASES = (
    dict(label="train-gemma", arch="gemma2-2b", n_layers=None,
         dtype="bfloat16", batch=1, seq=8192, steps=3),
    dict(label="train-gemma-f32", arch="gemma2-2b", n_layers=2,
         dtype="float32", batch=1, seq=8192, steps=0),
    dict(label="train-falcon", arch="falcon-mamba-7b", n_layers=16,
         dtype="bfloat16", batch=1, seq=2048, steps=3),
    dict(label="train-moe", arch="qwen2-moe-a2.7b", n_layers=None,
         dtype="bfloat16", batch=None, seq=4096, steps=3, sized="train_4k"),
)
TRAIN_OPT = dict(lr=3e-4, warmup=20)          # examples/train_lm.py's
# the LM kernels' launch counts (one a form): the records that carry
# ``train_path_launches``
LM_KERNELS = ("flash_attention", "flash_attention_f32", "mamba_scan",
              "mamba_scan_wide")
# Route agreement at step 1 (kernel route vs attn_impl="chunked",
# ssm_impl="scan"): in bf16 the loss within the JAX package's own
# kernel-versus-chunked loss tolerance (tests/test_kernels.py) and the
# global gradient norm within 2e-2; in f32 every leaf's relative L2 error.
TRAIN_BF16_TOL = dict(loss_rtol=2e-3, grad_norm_rtol=2e-2)
TRAIN_F32_LEAF_REL_L2 = 1e-3
V = 4
K = 1
VERIFY_CHUNK = 32
# long-path pairs the K5 check and the death-block reading take
LONG_SAMPLE = 32
# the long path's warm searches with its recorded DTW inputs held (the
# first is nn_search_warm_s), then as many after they are freed
WARM_HELD = 3

RTOL, ATOL = 1e-5, 1e-6
# K9 against its plain version, by input type: f32 sums in another
# order; bf16 outputs may round one bf16 ulp apart
K9_TOL = {"float32": dict(rtol=1e-4, atol=1e-5),
          "bfloat16": dict(rtol=1e-2, atol=1e-2)}
# ... and in bf16 also to a relative RMS error |o - ref| / |ref| (norms
# over the whole output), which scales with the layer's typical output
# where the atol may not: rounding P and each output to bf16 (unit
# roundoff 2^-8) puts it near 2e-3 to 5e-3
K9_BF16_REL_RMS = 1e-2
# K9 sweep: g in {1, 2, 4, 8}, D in {64, 80, 96, 128, 256}, causal and
# not, window, cap, ragged and unequal Sq / Skv, f32 and bf16
FLASH_SWEEP = [
    # B, Sq, Skv, Hq, Hkv, D, causal, window, cap, dtype
    (2, 40, 40, 4, 4, 64, True, None, None, "float32"),
    (1, 77, 77, 8, 1, 128, True, 16, 30.0, "float32"),
    (2, 100, 70, 2, 1, 256, False, None, None, "float32"),
    (1, 33, 90, 8, 4, 64, False, 20, 50.0, "float32"),
    (2, 129, 129, 16, 2, 128, True, None, 50.0, "bfloat16"),
    (1, 300, 300, 8, 4, 256, True, 64, 50.0, "bfloat16"),
    (3, 65, 65, 2, 2, 96, False, None, None, "bfloat16"),
    (1, 1, 17, 8, 4, 256, False, None, 50.0, "float32"),
    (2, 100, 100, 4, 4, 80, False, None, None, "bfloat16"),
    (1, 77, 90, 8, 2, 80, True, 16, 30.0, "float32"),
]
# K10 sweep: N in {4, 16, 17, 32, 64, 128, 256}, S and C multiples of no
# tile, h0 nonzero
MAMBA_SWEEP = [(2, 33, 70, 4), (3, 100, 300, 16), (1, 17, 129, 64),
               (2, 1, 5, 16), (1, 50, 128, 32), (2, 40, 33, 17),
               (1, 70, 40, 128), (1, 40, 33, 256)]
# K10's wide-state form: N in {257, 512, 1024}, ragged S and C
MAMBA_WIDE_SWEEP = [(1, 40, 33, 257), (2, 37, 70, 512), (1, 20, 9, 1024)]
# K2's full form: nb = 0 (pure Keogh), 1, 4, 8, 9 (the generic bands) and
# L / 2 (an empty bridge at even L, one column at odd L); L not a multiple
# of 4 or 32; Q < 8, C < 64; several 128 x 64 tiles, ragged; L = 17984
K2_FULL_SWEEP = [
    # Q, C, L, w, v
    (5, 37, 33, 8, 0), (3, 70, 66, 1, 4), (130, 150, 100, 10, 4),
    (9, 65, 64, 12, 8), (40, 129, 97, 20, 9), (7, 70, 16, 16, 8),
    (6, 64, 17, 17, 9), (257, 200, 512, 51, 4), (4, 70, 17984, 179, 4),
]


class SmokeFailure(Exception):
    pass


# ptxas reports of the redesigned kernels: the source, and for each
# instantiation (mangled-name pattern) the record it belongs to and a label
PTXAS_SOURCES = ("dtw_band.cu", "mamba_scan.cu", "sketch.cu", "lb_keogh.cu",
                 "lb_enhanced.cu", "flash_attention.cu")
PTXAS_KERNELS = [
    (r"_Z20dtw_band_warp_kernelILi(\d+)ELb0E", "dtw_band", "M={}"),
    (r"_Z20dtw_band_warp_kernelILi(\d+)ELb1E", "dtw_band_step", "M={}"),
    (r"_Z21dtw_band_slots_kernelILi(\d+)ELb0ELi(\d+)E", "dtw_band_slots",
     "M={} CL={}"),
    (r"_Z21dtw_band_slots_kernelILi(\d+)ELb1ELi(\d+)E",
     "dtw_band_step_slots", "M={} CL={}"),
    (r"_Z15dtw_band_kernelILb0ELb0E", "dtw_band_block", "block"),
    (r"_Z15dtw_band_kernelILb1ELb0E", "dtw_band_step_block", "block"),
    (r"_Z17mamba_scan_kernelILi(\d+)ELb0E", "mamba_scan", "G={}"),
    (r"_Z17mamba_scan_kernelILi(\d+)ELb1E", "mamba_scan_wide", "G={}"),
    (r"_Z19sketch_bound_kernel", "sketch_bound", "kernel"),
    (r"_Z15lb_keogh_kernel", "lb_keogh", "kernel"),
    (r"_Z23lb_enhanced_full_kernelILi(\d+)E", "lb_enhanced_full", "NB={}"),
    (r"_ZN2fw16flash_f32_kernelIfE", "flash_attention_f32", "float32"),
    (r"_ZN2fw16flash_f32_kernelI13__nv_bfloat16E", "flash_attention_f32",
     "bfloat16"),
]


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def max_sm_clock_hz() -> float:
    """The card's maximum SM clock (``nvidia-smi``), in Hz."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def ptxas_start(tmp: Path) -> list:
    """Compile the redesigned kernels' sources once more with
    ``-Xptxas -v`` (the build's flags otherwise), one nvcc each, started
    together; ``ptxas_report`` reads them."""
    from repro_torch.kernels import _build

    return [subprocess.Popen(
        [_build._nvcc(), *_build._FLAGS, "-Xptxas", "-v", "-c",
         str(_build._CSRC / src), "-o", str(tmp / (src + ".o"))],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src in PTXAS_SOURCES]


def ptxas_report(procs) -> dict:
    """``{record name: {"ptxas": {label: {"registers", "spill_bytes"}}}}``
    from the ``ptxas_start`` processes."""
    import re

    rep = {}
    for proc in procs:
        log, _ = proc.communicate(timeout=600)
        check(proc.returncode == 0, f"nvcc -Xptxas -v failed:\n{log}")
        entry = None
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                entry = m.group(1)
                continue
            found = None
            for pat, name, label in PTXAS_KERNELS:
                km = re.match(pat, entry or "")
                if km:
                    found = name, label.format(*km.groups())
            if found is None:
                continue
            info = rep.setdefault(found[0], {"ptxas": {}})["ptxas"]
            slot = info.setdefault(found[1], {})
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m:
                slot["spill_bytes"] = int(m.group(1)) + int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                slot["registers"] = int(m.group(1))
    for name in {name for _, name, _ in PTXAS_KERNELS}:
        check(name in rep, f"ptxas reported no kernel of {name}")
        for label, slot in rep[name]["ptxas"].items():
            check(slot.get("spill_bytes") == 0,
                  f"{name} {label} spills: {slot}")
    return rep


def occupancy_report(rep: dict) -> dict:
    """Add each redesigned instantiation's resident warps per SM (CUDA's
    occupancy calculator at its launch's block size and shared memory)
    to a ``ptxas_report``: K4's and K6's warp form at the widest band of
    each M, their slots form at the widest band of each instantiation
    (one warp a pair of each M; 29 warps in a cluster of two blocks),
    K10 at N = 8 G (its wide-state form past 256), K7 at the
    sketch path's S = 16, K9's f32-arithmetic form (8 warps a block; its
    blocks per SM too)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.dtw_band import K4_SLOTS_ONE_WARP

    lib = _build.library()
    got = {}
    for name, per_step in (("dtw_band", 0), ("dtw_band_step", 1)):
        for m in (2, 4, 8, 16):
            got[name, f"M={m}"] = lib.dtw_band_warp_occupancy(
                (32 * m - 1) // 2, per_step)
    for g in (1, 2, 4, 8, 16, 32):
        got["mamba_scan", f"G={g}"] = lib.mamba_scan_occupancy(8 * g)
    # the slots form's instantiations at the widest band each takes
    for name, per_step in (("dtw_band_slots", 0), ("dtw_band_step_slots", 1)):
        for m, cl, wb in ([(m, 1, (32 * m - 1) // 2)
                           for m in K4_SLOTS_ONE_WARP]
                          + [(32, 2, 14463)]):
            got[name, f"M={m} CL={cl}"] = lib.dtw_band_slots_occupancy(
                wb, m, per_step)
    got["mamba_scan_wide", "G=32"] = lib.mamba_scan_occupancy(257)
    got["sketch_bound", "kernel"] = lib.sketch_bound_occupancy(16)
    for bf16, label in ((0, "float32"), (1, "bfloat16")):
        blocks = lib.flash_attention_cuda_cores_occupancy(bf16)
        rep["flash_attention_f32"]["ptxas"][label]["blocks_per_sm"] = blocks
        got["flash_attention_f32", label] = 8 * blocks
    for (name, label), warps in got.items():
        check(warps > 0, f"{name} {label}: occupancy query failed ({warps})")
        rep[name]["ptxas"][label]["resident_warps_per_sm"] = warps
    return rep


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds per call over ``reps`` calls, CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# a pause between a profiler session's start and its first launch (see
# prime_profiler)
PROFILER_PAD_S = 0.2

# the port's kernels by function name (the profiler's kernel names hold
# these), to pick them out of a profile
PORT_KERNELS = ("envelope_kernel", "lb_bands_kernel", "lb_enhanced_full",
                "lb_enhanced_pairwise", "dtw_band", "sketch_bound_kernel",
                "lb_keogh_kernel", "flash_fwd", "flash_f32",
                "mamba_scan_kernel")


def prime_profiler() -> None:
    """Open profiler sessions, each pausing ``PROFILER_PAD_S`` before 8
    tiny kernels, until one records all 8.  On the H100 machine a session that
    starts long after the previous one loses its first kernel records: 3
    of 3 after 60 s without a session, 11 of 20 after 45 s, and 3 of 3,
    even behind a 0.1 s pause, after 60 s of launches; a session that
    follows one that recorded its kernels loses none, and 0.1 s between a
    session's start and its first launch brought back all 3 after 60 and
    120 s idle.  So ``device_ms`` and ``profile_call`` call this and then
    pause inside their session before launching."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x = torch.zeros(1, device="cuda")
    for _ in range(10):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILER_PAD_S)
            for _ in range(8):
                x.add_(1.0)
            torch.cuda.synchronize()
        if sum(e.count for e in prof.key_averages()
               if getattr(e, "device_type", None) == DeviceType.CUDA) >= 8:
            return


def device_ms(fn, key: str, reps: int = 20) -> float:
    """Mean device milliseconds per launch of the kernels whose name holds
    ``key``, over ``reps`` calls of ``fn`` under ``torch.profiler``.
    Back-to-back calls of a small kernel are host-bound (the wrapper's
    checks and the ctypes call), so CUDA events around them time the
    host; the profiler's device time is the kernel's own."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(5):              # until the session saw every call
        prime_profiler()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILER_PAD_S)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total, n = 0.0, 0
        for e in prof.key_averages():
            if key in e.key and getattr(e, "device_type", None) == \
                    DeviceType.CUDA:
                total += getattr(e, "self_device_time_total", 0)
                n += e.count
        if n >= reps:
            break
    check(n > 0 and total > 0, f"the profiler saw no device time of {key}")
    return total / n / 1e3


def timed(fn):
    """One call's result and its milliseconds, CUDA events, no warm-up."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    res = fn()
    end.record()
    torch.cuda.synchronize()
    return res, start.elapsed_time(end)


def compare(name: str, got, want, exact: bool, rtol: float = RTOL,
            atol: float = ATOL) -> float:
    """Max abs difference of finite entries (compared in float32); the
    +-inf positions must match.  ``exact`` demands equal values
    (``torch.equal``; -0.0 == 0.0), otherwise ``rtol``, ``atol`` (default
    1e-5, 1e-6)."""
    import torch

    got = [got] if isinstance(got, torch.Tensor) else list(got)
    want = [want] if isinstance(want, torch.Tensor) else list(want)
    err = 0.0
    for g, w in zip(got, want):
        g, w = g.float(), w.float()
        check(g.shape == w.shape, f"{name}: shape {tuple(g.shape)} != "
              f"{tuple(w.shape)}")
        check(not torch.isnan(g).any().item(), f"{name}: NaN in output")
        check(torch.equal(torch.isposinf(g), torch.isposinf(w))
              and torch.equal(torch.isneginf(g), torch.isneginf(w)),
              f"{name}: +-inf positions differ from the plain version")
        fin = torch.isfinite(w)
        if exact:
            check(torch.equal(g[fin], w[fin]),
                  f"{name}: not bit-equal to the plain version")
        else:
            if not torch.allclose(g[fin], w[fin], rtol=rtol, atol=atol):
                raise SmokeFailure(
                    f"{name}: outside rtol={rtol}, atol={atol} (max abs "
                    f"err {(g[fin] - w[fin]).abs().max().item()})")
        if fin.any():
            err = max(err, (g[fin] - w[fin]).abs().max().item())
    return err


class Recorder:
    """Wraps a kernel wrapper in ``kernels.ops`` to keep the inputs of its
    largest call on a path (the count stays the wrapper's own), and in
    ``calls`` the inputs of its first ``keep`` calls (``None``: of every
    call).  It keeps references, not copies, so the timed path does no
    extra work: the path makes every kernel input afresh and never writes
    to one after the launch."""

    def __init__(self, ops_module, attr: str, keep: int | None = 0):
        self.ops, self.attr = ops_module, attr
        self.orig = getattr(ops_module, attr)
        self.args = self.kwargs = None
        self.size = -1
        self.keep = keep
        self.calls = []
        setattr(ops_module, attr, self)

    def __call__(self, *args, **kwargs):
        size = args[0].numel()
        if size > self.size:
            self.size, self.args, self.kwargs = size, args, kwargs
        if self.keep is None or len(self.calls) < self.keep:
            self.calls.append(args)
        return self.orig(*args, **kwargs)

    def restore(self):
        setattr(self.ops, self.attr, self.orig)


class LaunchTimer:
    """Wraps a kernel wrapper in ``kernels.ops`` to put a CUDA event
    before and after each call (no synchronisation); ``ms`` sums their
    device time since ``events`` was last emptied."""

    def __init__(self, ops_module, attr: str):
        self.ops, self.attr = ops_module, attr
        self.orig = getattr(ops_module, attr)
        self.events = []
        setattr(ops_module, attr, self)

    def __call__(self, *args, **kwargs):
        import torch

        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = self.orig(*args, **kwargs)
        ev[1].record()
        self.events.append(ev)
        return out

    def ms(self) -> float:
        import torch

        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in self.events)

    def restore(self):
        setattr(self.ops, self.attr, self.orig)


def run_main_path(torch, dev):
    """build_index -> classify at full size, counts set to 0 just before
    and read just after.  Returns what the later phases need."""
    from repro_torch.data import make_dataset
    from repro_torch.kernels import _build, ops
    from repro_torch.search import (CascadeConfig, EngineConfig,
                                    build_index, classify, nn_search)

    ds = make_dataset(**MAIN)
    L = ds.length
    w = int(0.1 * L)
    cfg = EngineConfig(cascade=CascadeConfig(w=w, v=V), verify_chunk=VERIFY_CHUNK,
                       k=K)
    recs = {n: Recorder(ops, n) for n in
            ("envelope_cuda", "lb_enhanced_cuda",
             "lb_enhanced_pairwise_cuda", "dtw_band_cuda")}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.synchronize()
        _build.reset_counts()
        t0 = time.perf_counter()
        index = build_index(ds.x_train, w, ds.y_train, device=dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        pred, res = classify(index, ds.x_test, cfg)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        launches = _build.counts()
        for r in recs.values():
            r.restore()

        # steady state: the same search again (survivor budget memoised)
        t3 = time.perf_counter()
        res2, guard = nn_search(index, ds.x_test, cfg, with_guards=True)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
    check_no_guard_trip("main path", caught, guard)
    check(torch.equal(res2.idx, res.idx) and torch.equal(res2.dists,
                                                         res.dists),
          "a repeated nn_search gave another result")

    cost = guard_cost(torch, index, ds.x_test, cfg)
    k2_parity = chunked_parity(torch, "main path", index, ds.x_test, cfg)

    y = torch.as_tensor(ds.y_test, device=dev)
    acc = (pred.long() == y.long()).float().mean().item()
    n_dtw = res.n_dtw.float()
    summary = {
        "N": index.n, "L": L, "w": w, "v": V, "k": K, "Q": len(ds.x_test),
        "verify_chunk": VERIFY_CHUNK,
        "build_index_s": t1 - t0, "classify_s": t2 - t1,
        "nn_search_warm_s": t4 - t3,
        "mean_n_dtw": n_dtw.mean().item(),
        "pruning_power": res.pruning_power().mean().item(),
        "lb_over_dtw_at_nn_median": lb_over_dtw_at_nn(torch, index,
                                                      ds.x_test, res, w),
        "accuracy": acc, "launches": launches,
        "guards": guard.summary(), "warm_search_guards": cost,
        "warm_search_k2_parity": k2_parity,
    }
    print("main path: " + json.dumps(summary))
    return ds, index, cfg, res, launches, recs


def chunked_parity(torch, label: str, index, queries, cfg) -> dict:
    """A warm ``nn_search`` with K2 over the whole store per tier call,
    then the same with K2 launched per chunk of ``candidate_chunk``
    candidates (the earlier dispatch, ``_kernel_route`` patched; every
    kernel still on the card): ids, distances and ``n_dtw`` must be
    equal.  Returns each run's K2 launches."""
    from repro_torch.kernels import _build
    from repro_torch.search import cascade, nn_search

    got = {}
    orig = cascade._kernel_route
    for mode in ("whole_store", "chunked"):
        if mode == "chunked":
            cascade._kernel_route = lambda q, c: False
        try:
            _build.reset_counts()
            got[mode] = nn_search(index, queries, cfg)
            torch.cuda.synchronize()
        finally:
            cascade._kernel_route = orig
        got[mode + "_lb_enhanced_launches"] = _build.counts()["lb_enhanced"]
    a, b = got["whole_store"], got["chunked"]
    check(torch.equal(a.idx, b.idx) and torch.equal(a.dists, b.dists)
          and torch.equal(a.n_dtw, b.n_dtw),
          f"{label}: K2 over the whole store changed ids, distances or "
          "n_dtw against the chunked launches")
    # one launch per tier call: the chunked run makes ceil(N / chunk) a call
    per_call = -(-index.n // min(cfg.cascade.candidate_chunk, index.n))
    check(got["whole_store_lb_enhanced_launches"] > 0
          and got["chunked_lb_enhanced_launches"]
          == per_call * got["whole_store_lb_enhanced_launches"],
          f"{label}: K2 made {got['whole_store_lb_enhanced_launches']} "
          f"launches over the store against "
          f"{got['chunked_lb_enhanced_launches']} chunked ({per_call} a "
          "tier call)")
    return {k: v for k, v in got.items() if k.endswith("_launches")}


def guard_cost(torch, index, queries, cfg, reps: int = 2) -> dict:
    """Warm ``nn_search`` wall seconds with the config's guards (on by
    default) and with ``GuardConfig(enabled=False)``, in the order on,
    off, off, on repeated ``reps`` times so drift falls on both; the two
    must return the same result."""
    from repro_torch.search import GuardConfig, nn_search

    cfgs = {"on": cfg,
            "off": dataclasses.replace(cfg, guards=GuardConfig(enabled=False))}
    secs = {"on": [], "off": []}
    res = {}
    for mode in ("on", "off", "off", "on") * reps:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res[mode] = nn_search(index, queries, cfgs[mode])
        torch.cuda.synchronize()
        secs[mode].append(time.perf_counter() - t0)
    check(torch.equal(res["on"].idx, res["off"].idx)
          and torch.equal(res["on"].dists, res["off"].dists)
          and torch.equal(res["on"].n_dtw, res["off"].n_dtw),
          "guards on and off gave different results")
    med = {m: sorted(v)[len(v) // 2] for m, v in secs.items()}
    return {"guards_on_s": secs["on"], "guards_off_s": secs["off"],
            "guards_on_median_s": med["on"], "guards_off_median_s": med["off"],
            "guards_cost_median_s": med["on"] - med["off"]}


def lb_over_dtw_at_nn(torch, index, queries, res, w: int) -> float:
    """Median over queries of LB_ENHANCED^V (the cascade's tightest tier)
    at the returned nearest neighbour over its DTW: how tight the bound
    is where pruning needs it."""
    from repro_torch.kernels import ops

    q = torch.as_tensor(queries, dtype=torch.float32, device=index.device)
    nn = res.idx[:, 0].long()
    lb = ops.lb_enhanced_pairwise_op(q, index.series[nn], index.upper[nn],
                                     index.lower[nn], w, V)
    return (lb / res.dists[:, 0]).median().item()


def check_no_guard_trip(path: str, caught, guard) -> None:
    """No ``GuardWarning`` during the path, and every violation counter
    and the degradation count of its warm search at 0."""
    from repro_torch.search import GuardWarning

    trips = [str(c.message) for c in caught
             if issubclass(c.category, GuardWarning)]
    check(not trips, f"{path}: a guard warned: {trips[:2]}")
    g = guard.values()
    for f in ("admiss_viol", "conserve_viol", "account_viol",
              "nonfinite_bounds", "nonfinite_dtw", "degraded"):
        check(g[f] == 0.0, f"{path}: guard counter {f} = {g[f]}")
    check(g["admiss_checked"] > 0 and g["account_checked"] > 0,
          f"{path}: the guards checked nothing")


def run_sketch_path(torch, dev):
    """build_index(sketch=16, calibrate=cfg, mask=True) -> classify, counts
    set to 0 before the build and read after classify, then a warm
    nn_search; checks and prints the ``sketch path:`` line."""
    from repro_torch.data import make_dataset
    from repro_torch.kernels import _build
    from repro_torch.search import (CascadeConfig, EngineConfig,
                                    brute_force, build_index, classify,
                                    nn_search)

    ds = make_dataset(**SKETCH)
    L = ds.length
    w = int(0.1 * L)
    cfg = EngineConfig(cascade=CascadeConfig(w=w, v=V, use_sketch=True),
                       verify_chunk=VERIFY_CHUNK, k=K, auto_plan=True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.synchronize()
        _build.reset_counts()
        t0 = time.perf_counter()
        index = build_index(ds.x_train, w, ds.y_train, device=dev,
                            sketch=16, calibrate=cfg, mask=True)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        pred, res = classify(index, ds.x_test, cfg)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        launches = _build.counts()
        t3 = time.perf_counter()
        res2, stats = nn_search(index, ds.x_test, cfg, with_stats=True)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
    check_no_guard_trip("sketch path", caught, stats.guards)
    check(not stats.degraded, "sketch path: the warm search degraded")
    for kname in ("envelope", "lb_enhanced", "lb_enhanced_pairwise",
                  "dtw_band", "sketch_bound"):
        check(launches[kname] > 0,
              f"kernel {kname} was not launched on the sketch path")
    check(launches["dtw_band_block"] == 0, "sketch path: K4 ran its block "
          "form at w = 51, where k4_form picks the warp form")
    check(torch.equal(res2.idx, res.idx) and torch.equal(res2.dists,
                                                         res.dists),
          "sketch path: a repeated nn_search gave another result")
    check(torch.isfinite(res.dists).all().item(), "sketch path: non-finite "
          "distances")
    cost = guard_cost(torch, index, ds.x_test, cfg)
    k2_parity = chunked_parity(torch, "sketch path", index, ds.x_test, cfg)
    t5 = time.perf_counter()
    bd, bi = brute_force(index, ds.x_test[:32], w, k=K)
    torch.cuda.synchronize()
    t6 = time.perf_counter()
    check(torch.equal(bi, res.idx[:32]),
          "sketch path: ids differ from the kernel brute force")
    check(torch.equal(bd, res.dists[:32]),
          "sketch path: distances not bit-equal to the kernel brute force")
    y = torch.as_tensor(ds.y_test, device=dev)
    summary = {
        "N": index.n, "L": L, "w": w, "v": V, "k": K, "Q": len(ds.x_test),
        "verify_chunk": VERIFY_CHUNK, "sketch_S": index.sk_lo.shape[1],
        "build_index_s": t1 - t0, "classify_s": t2 - t1,
        "nn_search_warm_s": t4 - t3,
        "mean_n_dtw": res.n_dtw.float().mean().item(),
        "pruning_power": res.pruning_power().mean().item(),
        "accuracy": (pred.long() == y.long()).float().mean().item(),
        "plan": list(stats.plan_tiers), "dropped": list(stats.dropped),
        "budget": stats.budget, "limit": stats.limit,
        "live_fraction": index.live.float().mean().item(),
        "launches": launches, "guards": stats.guards.summary(),
        "warm_search_guards": cost, "warm_search_k2_parity": k2_parity,
        "brute_force_32_queries_s": t6 - t5,
    }
    print("sketch path: " + json.dumps(summary))
    return ds, index, cfg, launches


def long_sample(torch, calls, dev):
    """``LONG_SAMPLE`` pairs spread evenly over the pairs of every recorded
    DTW launch, with their cutoffs: ``(a, b, cutoff)``."""
    a = torch.cat([c[0] for c in calls])
    b = torch.cat([c[1] for c in calls])
    cut = torch.cat([torch.as_tensor(
        float("inf") if c[3] is None else c[3], dtype=torch.float32,
        device=dev).expand(c[0].shape[0]) for c in calls])
    sel = torch.linspace(0, a.shape[0] - 1, LONG_SAMPLE,
                         device=dev).round().long()
    return a[sel].contiguous(), b[sel].contiguous(), cut[sel].contiguous()


def run_long_path(torch, dev):
    """build_index -> classify -> warm nn_search on the long path, counts
    set to 0 before the build and read after classify, the inputs of each
    kernel's largest launch recorded (and of every DTW launch); checks
    that K5 ran and K4 did not, ids and distances against the kernel brute
    force for every query, and no guard trip; prints the ``long path:``
    line.  Returns the recorders and the launch counts."""
    from repro_torch.core.dtw import (dtw_band_death_blocks,
                                      row_block_policy, tile_skip_rate)
    from repro_torch.data import make_dataset
    from repro_torch.kernels import _build, ops
    from repro_torch.search import (CascadeConfig, EngineConfig,
                                    brute_force, build_index, classify,
                                    nn_search)

    ds = make_dataset(**LONG)
    L = ds.length
    w = L
    cfg = EngineConfig(cascade=CascadeConfig(w=w, v=V),
                       verify_chunk=VERIFY_CHUNK, k=K)
    recs = {n: Recorder(ops, n) for n in
            ("envelope_cuda", "lb_enhanced_cuda",
             "lb_enhanced_pairwise_cuda")}
    recs["dtw_band_cuda"] = Recorder(ops, "dtw_band_cuda", keep=None)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.synchronize()
        _build.reset_counts()
        t0 = time.perf_counter()
        index = build_index(ds.x_train, w, ds.y_train, device=dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        pred, res = classify(index, ds.x_test, cfg)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        launches = _build.counts()
        for r in recs.values():
            r.restore()
        # nn_search_warm_s is the first warm search.  Five more follow: two
        # with every recorded DTW input still held (as in the first), then
        # three after those inputs are freed.  Each run also reads its
        # device span and its K5 launches' device time, to tell a stall on
        # the host from one on the card.
        timer = LaunchTimer(ops, "dtw_band_cuda")
        runs = []
        for run in range(2 * WARM_HELD):
            if run == WARM_HELD:
                rec = recs["dtw_band_cuda"]
                rec.sample = long_sample(torch, rec.calls, dev)
                k5_pairs = sum(c[0].shape[0] for c in rec.calls)
                rec.calls = []
            timer.events = []
            span = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            t3 = time.perf_counter()
            span[0].record()
            res2, guard = nn_search(index, ds.x_test, cfg, with_guards=True)
            span[1].record()
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t3,
                         span[0].elapsed_time(span[1]), timer.ms()))
            check(torch.equal(res2.idx, res.idx)
                  and torch.equal(res2.dists, res.dists),
                  "long path: a repeated nn_search gave another result")
        timer.restore()
    check_no_guard_trip("long path", caught, guard)
    for kname in ("envelope", "lb_enhanced", "lb_enhanced_pairwise",
                  "dtw_band_stream"):
        check(launches[kname] > 0,
              f"kernel {kname} was not launched on the long path")
    check(launches["dtw_band"] == 0 and launches["dtw_band_block"] == 0,
          "long path: K4 ran a band it cannot hold (in either form)")
    check(launches["dtw_band_stream_cluster"] == 0
          and launches["dtw_band_stream_scratch"] == 0,
          "long path: K5 ran another form than its rows form (a)")
    check(torch.isfinite(res.dists).all().item(), "long path: non-finite "
          "distances")
    t5 = time.perf_counter()
    bd, bi = brute_force(index, ds.x_test, w, k=K)
    torch.cuda.synchronize()
    t6 = time.perf_counter()
    check(torch.equal(bi, res.idx),
          "long path: ids differ from the kernel brute force")
    check(torch.equal(bd, res.dists),
          "long path: distances not bit-equal to the kernel brute force")
    k2_parity = chunked_parity(torch, "long path", index, ds.x_test, cfg)
    # row blocks K5 skipped on the path: death blocks (plain version) of
    # LONG_SAMPLE pairs spread evenly over every pair it verified
    sa, sb, sc = recs["dtw_band_cuda"].sample
    death = dtw_band_death_blocks(sa, sb, w, sc)
    n_blocks = -(-(2 * L - 1) // row_block_policy(L))
    y = torch.as_tensor(ds.y_test, device=dev)
    summary = {
        "N": index.n, "L": L, "w": w, "v": V, "k": K, "Q": len(ds.x_test),
        "verify_chunk": VERIFY_CHUNK,
        "build_index_s": t1 - t0, "classify_s": t2 - t1,
        "nn_search_warm_s": runs[0][0],
        "nn_search_warm_runs_s": [r[0] for r in runs],
        "nn_search_warm_median_s": statistics.median(r[0] for r in runs),
        "nn_search_warm_runs_device_span_ms": [r[1] for r in runs],
        "nn_search_warm_runs_k5_ms": [r[2] for r in runs],
        "nn_search_warm_runs_inputs_held": WARM_HELD,
        "mean_n_dtw": res.n_dtw.float().mean().item(),
        "pruning_power": res.pruning_power().mean().item(),
        "lb_over_dtw_at_nn_median": lb_over_dtw_at_nn(torch, index,
                                                      ds.x_test, res, w),
        "accuracy": (pred.long() == y.long()).float().mean().item(),
        "launches": launches, "guards": guard.summary(),
        "warm_search_k2_parity": k2_parity,
        "brute_force_all_queries_s": t6 - t5,
        "k5_pairs": k5_pairs,
        "sample_pairs": LONG_SAMPLE, "n_row_blocks": n_blocks,
        "skipped_block_share_sample": tile_skip_rate(death, n_blocks, 1),
    }
    print("long path: " + json.dumps(summary))
    return ds, index, cfg, recs, launches


def run_wide_path(torch, dev, stores: dict, profiles: list | None):
    """The wide path: for each case of ``WIDE``, build_index -> classify
    -> a warm nn_search with guards on, counts set to 0 before the build
    and read after classify, then the warm search once more with K4
    forced into its block form (the same ids, distances and n_dtw; its
    wall beside the slots form's); checks that K4 ran in its slots form only
    (never the warp or block form, never K5), ids equal to the kernel brute
    force with distances bit-equal, and no guard trip; prints one ``wide
    path:`` line per case (with ``profiles``, a list, the warm searches of
    wide-b and wide-c go into it, to be profiled later by
    ``profile_search``).  Returns the summed launch window and each case's
    recorder of its largest DTW launch."""
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.dtw_band import k4_form, k4_slots
    from repro_torch.search import (CascadeConfig, EngineConfig,
                                    brute_force, build_index, classify,
                                    nn_search)

    total = dict.fromkeys(_build.COUNTS, 0)
    recs = {}
    for label, store, frac in WIDE:
        ds = stores[store]
        L = ds.length
        w = int(frac * L)
        check(k4_form(L, w) == "slots", f"{label}: k4_form({L}, {w}) is not "
              "the slots form")
        cfg = EngineConfig(cascade=CascadeConfig(w=w, v=V),
                           verify_chunk=VERIFY_CHUNK, k=K)
        rec = Recorder(ops, "dtw_band_cuda")
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.synchronize()
            _build.reset_counts()
            t0 = time.perf_counter()
            index = build_index(ds.x_train, w, ds.y_train, device=dev)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            pred, res = classify(index, ds.x_test, cfg)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            launches = _build.counts()
            rec.restore()
            _build.reset_counts()
            t3 = time.perf_counter()
            res2, guard = nn_search(index, ds.x_test, cfg, with_guards=True)
            torch.cuda.synchronize()
            t4 = time.perf_counter()
            warm = _build.counts()
        check_no_guard_trip(label, caught, guard)
        # the same warm search with K4 forced into its block form (outside
        # the count windows): the slots form's gain end to end
        k4 = ops.dtw_band_cuda
        ops.dtw_band_cuda = lambda *a, **kw: k4(*a, form="block", **kw)
        try:
            t5 = time.perf_counter()
            res3 = nn_search(index, ds.x_test, cfg)
            torch.cuda.synchronize()
            t6 = time.perf_counter()
        finally:
            ops.dtw_band_cuda = k4
        check(torch.equal(res3.idx, res.idx) and torch.equal(res3.dists,
                                                             res.dists)
              and torch.equal(res3.n_dtw, res.n_dtw),
              f"{label}: the block form gave another result")
        check(torch.equal(res2.idx, res.idx) and torch.equal(res2.dists,
                                                             res.dists),
              f"{label}: a repeated nn_search gave another result")
        check(launches["dtw_band_slots"] > 0, f"{label}: K4's slots form "
              "was not launched")
        for other in ("dtw_band", "dtw_band_block", "dtw_band_stream",
                      "dtw_band_stream_cluster", "dtw_band_stream_scratch"):
            check(launches[other] == 0, f"{label}: {other} ran where k4_form "
                  "picks the slots form")
        check(torch.isfinite(res.dists).all().item(), f"{label}: non-finite "
              "distances")
        nq = len(ds.x_test) if store == "long" else WIDE_BRUTE_Q
        t7 = time.perf_counter()
        bd, bi = brute_force(index, ds.x_test[:nq], w, k=K)
        torch.cuda.synchronize()
        t8 = time.perf_counter()
        check(torch.equal(bi, res.idx[:nq]),
              f"{label}: ids differ from the kernel brute force")
        check(torch.equal(bd, res.dists[:nq]),
              f"{label}: distances not bit-equal to the kernel brute force")
        for kname, n in launches.items():
            total[kname] += n
        recs[label] = rec
        y = torch.as_tensor(ds.y_test, device=dev)
        print("wide path: " + json.dumps({
            "case": label, "store": store, "N": index.n, "L": L, "w": w,
            "wb": min(w, L - 1), "slots_a_lane": k4_slots(L, w), "v": V,
            "k": K, "Q": len(ds.x_test), "verify_chunk": VERIFY_CHUNK,
            "build_index_s": t1 - t0, "classify_s": t2 - t1,
            "nn_search_warm_s": t4 - t3,
            "nn_search_warm_block_form_s": t6 - t5,
            # the seeds' DTW launch, then one a round
            "rounds_warm": warm["dtw_band_slots"] - 1,
            "mean_n_dtw": res.n_dtw.float().mean().item(),
            "pruning_power": res.pruning_power().mean().item(),
            "lb_over_dtw_at_nn_median": lb_over_dtw_at_nn(torch, index,
                                                          ds.x_test, res, w),
            "accuracy": (pred.long() == y.long()).float().mean().item(),
            "launches": {k: v for k, v in launches.items() if v},
            "launches_warm": {k: v for k, v in warm.items() if v},
            "guards": guard.summary(),
            "brute_force_queries": nq, "brute_force_s": t8 - t7,
            "largest_round_pairs": rec.args[0].shape[0]}))
        if profiles is not None and label != "wide-a":
            profiles.append((ds, index, cfg, f"{label} path"))
        del index, res, res2, res3, pred
    return total, recs


def dense_case(torch, dev, label: str, ds, cfg, staged_cfg, build_kw: dict,
               profiles: list | None):
    """One case of the dense path: ``build_index`` -> ``classify`` -> a
    warm ``nn_search`` with guards on under the unstaged ``cfg``, counts
    set to 0 before the build and read after ``classify`` (and again for
    the warm search alone), K2's tier call recorded; then, outside the
    windows, the staged search ``staged_cfg`` on the same index and the
    kernel brute force on ``DENSE_BRUTE_Q`` queries.  Checks: the full
    form launched in the warm search and the bands form not, ids and
    distances equal to the staged search's and to the brute force's, no
    guard trip, ``degraded`` 0.  Prints one ``dense path:`` line; returns
    the window, the recorder of K2 and the warm result."""
    from repro_torch.kernels import _build, ops
    from repro_torch.search import brute_force, build_index, classify, \
        nn_search

    w = cfg.cascade.w
    rec = Recorder(ops, "lb_enhanced_cuda")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.synchronize()
        _build.reset_counts()
        t0 = time.perf_counter()
        index = build_index(ds.x_train, w, ds.y_train, device=dev,
                            **build_kw)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        pred, res = classify(index, ds.x_test, cfg)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        launches = _build.counts()
        rec.restore()
        _build.reset_counts()
        t3 = time.perf_counter()
        res2, guard = nn_search(index, ds.x_test, cfg, with_guards=True)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        warm = _build.counts()
    check_no_guard_trip(label, caught, guard)
    check(not rec.kwargs.get("bands_only") and rec.args[1].shape[0]
          == index.n, f"{label}: the dense tier did not run the full form "
          "over the whole store")
    check(warm["lb_enhanced_full"] > 0 and launches["lb_enhanced_full"] > 0,
          f"{label}: K2's full form was not launched")
    check(warm["lb_enhanced"] == 0, f"{label}: the warm unstaged search "
          f"launched the bands form {warm['lb_enhanced']} times")
    check(torch.equal(res2.idx, res.idx) and torch.equal(res2.dists,
                                                         res.dists),
          f"{label}: a repeated nn_search gave another result")
    check(torch.isfinite(res.dists).all().item(), f"{label}: non-finite "
          "distances")
    # the staged search's first call on an index also sizes its survivor
    # budget; the second is its warm time
    st = nn_search(index, ds.x_test, staged_cfg)
    torch.cuda.synchronize()
    t5 = time.perf_counter()
    st2 = nn_search(index, ds.x_test, staged_cfg)
    torch.cuda.synchronize()
    t6 = time.perf_counter()
    check(torch.equal(st.idx, res.idx) and torch.equal(st.dists, res.dists)
          and torch.equal(st2.idx, st.idx), f"{label}: ids or distances "
          "differ from the staged search")
    nq = DENSE_BRUTE_Q
    t7 = time.perf_counter()
    bd, bi = brute_force(index, ds.x_test[:nq], w, k=K)
    torch.cuda.synchronize()
    t8 = time.perf_counter()
    check(torch.equal(bi, res.idx[:nq]),
          f"{label}: ids differ from the kernel brute force")
    check(torch.equal(bd, res.dists[:nq]),
          f"{label}: distances not bit-equal to the kernel brute force")
    y = torch.as_tensor(ds.y_test, device=dev)
    print("dense path: " + json.dumps({
        "case": label, "N": index.n, "L": ds.length, "w": w, "v": V, "k": K,
        "Q": len(ds.x_test), "verify_chunk": cfg.verify_chunk,
        "use_sketch": cfg.cascade.use_sketch,
        "live_fraction": None if index.live is None
        else index.live.float().mean().item(),
        "build_index_s": t1 - t0, "classify_s": t2 - t1,
        "nn_search_warm_s": t4 - t3, "staged_nn_search_warm_s": t6 - t5,
        "mean_n_dtw": res.n_dtw.float().mean().item(),
        "staged_mean_n_dtw": st.n_dtw.float().mean().item(),
        "pruning_power": res.pruning_power().mean().item(),
        "accuracy": (pred.long() == y.long()).float().mean().item(),
        "lb_enhanced_full_launches": launches["lb_enhanced_full"],
        "lb_enhanced_launches": launches["lb_enhanced"],
        "launches": {k: v for k, v in launches.items() if v},
        "launches_warm": {k: v for k, v in warm.items() if v},
        "guards": guard.summary(),
        "brute_force_queries": nq, "brute_force_s": t8 - t7}))
    if profiles is not None and label == "dense-a":
        profiles.append((ds, index, cfg, f"{label} path"))
    return launches, rec, res


def run_dense_path(torch, dev, stores: dict, sk_cfg,
                   profiles: list | None):
    """The dense path: the unstaged search (``CascadeConfig(staged=False)``,
    ``dense_plan``: every pair scored by K2's full form) on the main store
    at w = 51 (dense-a) and w = L (dense-b), and on the sketch store under
    its build-time mask with the sketch tier (dense-c; the mask comes from
    the staged calibration ``sk_cfg``, against which it is also searched),
    each case in its own count window (``dense_case``).  Returns the summed
    window, the recorders of K2's tier calls by case and dense-a's
    result."""
    from repro_torch.kernels import _build
    from repro_torch.search import CascadeConfig, EngineConfig

    total = dict.fromkeys(_build.COUNTS, 0)
    recs, res_a = {}, None
    for label, store, frac in DENSE:
        ds = stores[store]
        w = int(frac * ds.length)
        sketch = store == "sketch"
        cfg = EngineConfig(cascade=CascadeConfig(
            w=w, v=V, staged=False, use_sketch=sketch),
            verify_chunk=VERIFY_CHUNK, k=K)
        staged = sk_cfg if sketch else EngineConfig(
            cascade=CascadeConfig(w=w, v=V), verify_chunk=VERIFY_CHUNK, k=K)
        build_kw = dict(sketch=16, calibrate=sk_cfg, mask=True) if sketch \
            else {}
        launches, rec, res = dense_case(torch, dev, label, ds, cfg, staged,
                                        build_kw, profiles)
        for kname, n in launches.items():
            total[kname] += n
        recs[label] = rec
        if label == "dense-a":
            res_a = res
    return total, recs, res_a


def run_dense_dist(torch, dev, ds, want):
    """dense-dist: the main store at w = 51 through
    ``make_distributed_search`` on the one-rank NCCL mesh with the
    unstaged cascade (the dense plan), counts set to 0 before the build
    and read after the step.  Checks: ids and distances equal to dense-a's
    ``nn_search`` (``want``), the merged guard vector clean, the full
    form launched and the bands form not.  Prints its ``dense path:``
    line; returns the window."""
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.search import (CascadeConfig, EngineConfig, GuardReport,
                                    build_index, make_distributed_search,
                                    shard_index)

    w = int(0.1 * ds.length)
    cfg = EngineConfig(cascade=CascadeConfig(w=w, v=V, staged=False),
                       verify_chunk=VERIFY_CHUNK, k=K)
    mesh = make_host_mesh((1, 1), ("data", "model"))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.synchronize()
        _build.reset_counts()
        t0 = time.perf_counter()
        sidx = shard_index(mesh, build_index(ds.x_train, w, ds.y_train,
                                             device=dev))
        step = make_distributed_search(mesh, cfg, with_guards=True)
        leaves = (sidx.series, sidx.labels, sidx.upper, sidx.lower,
                  sidx.kim, sidx.kim_ok)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        d, i, n, gv = step(*leaves, ds.x_test)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        launches = _build.counts()
        t3 = time.perf_counter()
        d2, i2, n2, _ = step(*leaves, ds.x_test)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
    guard = GuardReport.from_vector(gv)
    check_no_guard_trip("dense-dist", caught, guard)
    check(launches["lb_enhanced_full"] > 0 and launches["lb_enhanced"] == 0,
          f"dense-dist: K2 launches {launches['lb_enhanced_full']} full, "
          f"{launches['lb_enhanced']} bands")
    check(torch.equal(d2, d) and torch.equal(i2, i) and torch.equal(n2, n),
          "dense-dist: the warm step gave another result")
    check(torch.equal(i, want.idx) and torch.equal(d, want.dists),
          "dense-dist: ids or distances differ from dense-a's nn_search")
    print("dense path: " + json.dumps({
        "case": "dense-dist", "N": ds.x_train.shape[0], "L": ds.length,
        "w": w, "v": V, "k": K, "Q": len(ds.x_test),
        "mesh": "(1, 1) data x model, NCCL", "build_s": t1 - t0,
        "step_cold_s": t2 - t1, "step_warm_s": t4 - t3,
        "mean_n_dtw": n.float().mean().item(),
        "dense_a_mean_n_dtw": want.n_dtw.float().mean().item(),
        "lb_enhanced_full_launches": launches["lb_enhanced_full"],
        "lb_enhanced_launches": launches["lb_enhanced"],
        "launches": {k: v for k, v in launches.items() if v},
        "guards": guard.summary()}))
    return launches


def start_paper_data(tmp: Path):
    """Start ``make_dataset(**PAPER)`` in a background process writing its
    arrays under ``tmp``: the generator loops in Python over 2^20 series
    (minutes of host time), so it runs while the earlier paths use the
    card.  Returns the process."""
    import os

    code = (
        "import json, sys, time\n"
        "import numpy as np\n"
        "from repro_torch.data import make_dataset\n"
        "t0 = time.perf_counter()\n"
        "ds = make_dataset(**json.loads(sys.argv[2]))\n"
        "sec = time.perf_counter() - t0\n"
        "for f in ('x_train', 'y_train', 'x_test', 'y_test'):\n"
        "    np.save(f'{sys.argv[1]}/{f}.npy', getattr(ds, f))\n"
        "print(json.dumps({'make_dataset_s': sec}))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    return subprocess.Popen([sys.executable, "-c", code, str(tmp),
                             json.dumps(PAPER)], env=env,
                            stdout=subprocess.PIPE, text=True)


def paper_data(proc, tmp: Path):
    """Wait for ``start_paper_data``'s process; returns the dataset, the
    generator's seconds and the seconds this process waited for it."""
    import numpy as np

    from repro_torch.data import Dataset

    t0 = time.perf_counter()
    out, _ = proc.communicate(timeout=900)
    waited = time.perf_counter() - t0
    check(proc.returncode == 0, f"the paper path's data process failed "
          f"(exit {proc.returncode})")
    arrays = {f: np.load(tmp / f"{f}.npy") for f in
              ("x_train", "y_train", "x_test", "y_test")}
    sec = json.loads(out.strip().splitlines()[-1])["make_dataset_s"]
    return Dataset(**arrays), sec, waited


def init_world(torch):
    """A one-rank NCCL world (the distributed paths' mesh is (1, 1))."""
    import socket

    import torch.distributed as dist

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)


def run_paper_path(torch, dev, data):
    """The paper's own cell (``configs/paper_dtw.py``) on one card:
    ``build_index`` -> ``make_distributed_search`` on a one-rank NCCL
    ``("data", "model")`` mesh -> the step over every query in blocks of
    ``PAPER_BLOCK``, counts set to 0 before the build and read after the
    step; then a warm repeat, the single-device ``nn_search`` over the same
    blocks and the kernel brute force on ``PAPER_BRUTE_Q`` strided
    queries.  Checks: ids and distances equal to ``nn_search`` for every
    query and to the brute force on its sample, no guard trip, ``degraded``
    0, only K1-K4 launched (K4 in its warp form).  Prints the ``paper
    path:`` line; returns the launch window and the recorders."""
    from repro_torch.configs.paper_dtw import PAPER_SEARCH as pc
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.dtw_band import k4_form
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.search import (CascadeConfig, EngineConfig, GuardReport,
                                    brute_force, build_index,
                                    make_distributed_search, nn_search,
                                    shard_index)

    ds, data_s, waited_s = data
    N, L, Q, w = pc.n_store, pc.length, pc.n_queries, pc.w
    check(ds.x_train.shape == (N, L) and ds.x_test.shape == (Q, L),
          f"paper path: the store is {ds.x_train.shape}, the queries "
          f"{ds.x_test.shape}")
    check(k4_form(L, w) == "warp", f"k4_form({L}, {w}) is not the warp form")
    cfg = EngineConfig(cascade=CascadeConfig(
        w=w, v=pc.v, candidate_chunk=pc.candidate_chunk),
        verify_chunk=pc.verify_chunk, k=pc.k)
    mesh = make_host_mesh((1, 1), ("data", "model"))
    recs = {n: Recorder(ops, n) for n in
            ("envelope_cuda", "lb_enhanced_cuda",
             "lb_enhanced_pairwise_cuda", "dtw_band_cuda")}
    torch.cuda.reset_peak_memory_stats()

    def blocks(fn, q):
        return [fn(q[s:s + PAPER_BLOCK]) for s in range(0, Q, PAPER_BLOCK)]

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.synchronize()
        _build.reset_counts()
        t0 = time.perf_counter()
        index = build_index(ds.x_train, w, ds.y_train, device=dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        sidx = shard_index(mesh, index)
        step = make_distributed_search(mesh, cfg, with_guards=True)
        leaves = (sidx.series, sidx.labels, sidx.upper, sidx.lower,
                  sidx.kim, sidx.kim_ok)
        q = torch.as_tensor(ds.x_test, device=dev)

        def run_step():
            outs = blocks(lambda qb: step(*leaves, qb), q)
            guard = GuardReport.from_vector(outs[0][3])
            for o in outs[1:]:
                guard = guard.merge(GuardReport.from_vector(o[3]))
            return tuple(torch.cat([o[j] for o in outs]) for j in range(3)) \
                + (guard,)

        d, i, n, guard = run_step()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        launches = _build.counts()
        for r in recs.values():
            r.restore()
        t3 = time.perf_counter()
        d2, i2, n2, guard2 = run_step()
        torch.cuda.synchronize()
        t4 = time.perf_counter()
    peak = torch.cuda.max_memory_allocated()
    check_no_guard_trip("paper path", caught, guard)
    check_no_guard_trip("paper path (warm)", [], guard2)
    check(torch.equal(d2, d) and torch.equal(i2, i) and torch.equal(n2, n),
          "paper path: the warm step gave another result")
    for kname, cnt in launches.items():
        want = kname in ("envelope", "lb_enhanced", "lb_enhanced_pairwise",
                         "dtw_band")
        check((cnt > 0) == want, f"paper path: {kname} launched {cnt} "
              "times (only K1-K4 run there, K4 in its warp form)")
    check(torch.isfinite(d).all().item(), "paper path: non-finite distances")
    # the single-device engine over the same blocks
    torch.cuda.reset_peak_memory_stats()
    t5 = time.perf_counter()
    ref_res = blocks(lambda qb: nn_search(index, qb, cfg), q)
    torch.cuda.synchronize()
    t6 = time.perf_counter()
    nn_peak = torch.cuda.max_memory_allocated()
    sd = torch.cat([r.dists for r in ref_res])
    si = torch.cat([r.idx for r in ref_res])
    sn = torch.cat([r.n_dtw for r in ref_res])
    check(torch.equal(i, si), "paper path: ids differ from single-device "
          "nn_search")
    check(torch.equal(d, sd), "paper path: distances not bit-equal to "
          "single-device nn_search")
    sel = torch.arange(0, Q, Q // PAPER_BRUTE_Q, device=dev)
    t7 = time.perf_counter()
    bd, bi = brute_force(index, q[sel], w, k=pc.k, chunk=4096)
    torch.cuda.synchronize()
    t8 = time.perf_counter()
    check(torch.equal(bi, i[sel]), "paper path: ids differ from the kernel "
          "brute force")
    check(torch.equal(bd, d[sel]), "paper path: distances not bit-equal to "
          "the kernel brute force")
    y = torch.as_tensor(ds.y_test, device=dev)
    pred = index.labels[i[:, 0].long()]
    print("paper path: " + json.dumps({
        "config": pc.name, "N": N, "L": L, "Q": Q, "w": w, "v": pc.v,
        "k": pc.k, "candidate_chunk": pc.candidate_chunk,
        "verify_chunk": pc.verify_chunk, "mesh": "(1, 1) data x model, NCCL",
        "query_block": PAPER_BLOCK, "make_dataset_host_s": data_s,
        "make_dataset_wait_s": waited_s, "build_index_s": t1 - t0,
        "step_cold_s": t2 - t1, "step_warm_s": t4 - t3,
        "mean_n_dtw": n.float().mean().item(),
        "pruning_power": 1.0 - n.float().mean().item() / N,
        "nn_search_s": t6 - t5,
        "nn_search_mean_n_dtw": sn.float().mean().item(),
        "accuracy": (pred.long() == y.long()).float().mean().item(),
        "max_memory_allocated_bytes": peak,
        "nn_search_max_memory_allocated_bytes": nn_peak,
        "launches": {k: v for k, v in launches.items() if v},
        "guards": guard.summary(),
        "brute_force_queries": PAPER_BRUTE_Q, "brute_force_s": t8 - t7,
        "expected_verify": pc.expected_verify}))
    del index, sidx, leaves, q, ref_res, step
    return launches, recs


def profile_paper_path(torch, dev, ds) -> None:
    """``--profile``: the paper path's warm step on one block of
    ``PAPER_PROFILE_Q`` queries, on the store indexed again.  It runs last:
    a block of the paper path is hundreds of thousands of profiler events,
    whose ``key_averages`` take minutes on the host, and later profiler
    sessions in the process saw no device time after one such trace."""
    from repro_torch.configs.paper_dtw import PAPER_SEARCH as pc
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.search import (CascadeConfig, EngineConfig,
                                    build_index, make_distributed_search,
                                    shard_index)

    cfg = EngineConfig(cascade=CascadeConfig(
        w=pc.w, v=pc.v, candidate_chunk=pc.candidate_chunk),
        verify_chunk=pc.verify_chunk, k=pc.k)
    mesh = make_host_mesh((1, 1), ("data", "model"))
    sidx = shard_index(mesh, build_index(ds.x_train, pc.w, ds.y_train,
                                         device=dev))
    step = make_distributed_search(mesh, cfg, with_guards=True)
    qb = torch.as_tensor(ds.x_test[:PAPER_PROFILE_Q], device=dev)
    profile_call(torch, lambda: step(sidx.series, sidx.labels, sidx.upper,
                                     sidx.lower, sidx.kim, sidx.kim_ok, qb),
                 f"paper path, warm step of one {PAPER_PROFILE_Q}-query block")


def run_dist_sketch_path(torch, sk_ds, sk_index, sk_cfg):
    """The distributed sketch path: the sketch path's store (built with
    ``sketch=16, calibrate=, mask=True``) through
    ``calibrate_distributed_plan`` -> ``make_distributed_search(
    with_sketch=True, plan=decision.plan, with_guards=True)`` on the
    one-rank NCCL mesh, counts set to 0 before the calibration and read
    after the step.  Checks: ids and distances equal to the sketch path's
    single-device ``nn_search``, the merged guard vector clean with
    ``conserve_checked > 0``, K7 launched.  Prints the ``dist sketch
    path:`` line; returns the launch window."""
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.search import (GuardReport, calibrate_distributed_plan,
                                    make_distributed_search, nn_search,
                                    shard_index)

    mesh = make_host_mesh((1, 1), ("data", "model"))
    sidx = shard_index(mesh, sk_index)
    leaves = (sidx.series, sidx.labels, sidx.upper, sidx.lower, sidx.kim,
              sidx.kim_ok)
    sketch = (sidx.sk_lo, sidx.sk_hi, sidx.sk_scale, sidx.live)
    q = sk_ds.x_test
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.synchronize()
        _build.reset_counts()
        t0 = time.perf_counter()
        decision = calibrate_distributed_plan(mesh, sk_cfg, *leaves, q,
                                              *sketch)
        step = make_distributed_search(mesh, sk_cfg, with_sketch=True,
                                       plan=decision.plan, with_guards=True)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        d, i, n, gv = step(*leaves, q, *sketch)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        launches = _build.counts()
        t3 = time.perf_counter()
        d2, i2, n2, _ = step(*leaves, q, *sketch)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
    guard = GuardReport.from_vector(gv)
    check_no_guard_trip("dist sketch path", caught, guard)
    check(guard.values()["conserve_checked"] > 0, "dist sketch path: the "
          "echo check counted nothing")
    check(launches["sketch_bound"] > 0, "dist sketch path: K7 was not "
          "launched")
    check(torch.equal(d2, d) and torch.equal(i2, i) and torch.equal(n2, n),
          "dist sketch path: the warm step gave another result")
    res = nn_search(sk_index, q, sk_cfg)
    check(torch.equal(i, res.idx), "dist sketch path: ids differ from the "
          "sketch path's single-device search")
    check(torch.equal(d, res.dists), "dist sketch path: distances not "
          "bit-equal to the sketch path's single-device search")
    print("dist sketch path: " + json.dumps({
        "N": sk_index.n, "L": sk_index.length, "Q": len(q),
        "w": sk_cfg.cascade.w, "sketch_S": sk_index.sk_lo.shape[1],
        "live_fraction": sk_index.live.float().mean().item(),
        "mesh": "(1, 1) data x model, NCCL", "plan": decision.summary(),
        "calibrate_s": t1 - t0, "step_cold_s": t2 - t1,
        "step_warm_s": t4 - t3, "mean_n_dtw": n.float().mean().item(),
        "nn_search_mean_n_dtw": res.n_dtw.float().mean().item(),
        "launches": {k: v for k, v in launches.items() if v},
        "guards": guard.summary()}))
    return launches


def run_examples(torch) -> None:
    """Each ``examples_torch/`` script once at its defaults (on the card;
    ``train_lm.py`` for 20 steps) in a subprocess: it must exit 0 and
    print its verdict as ``True``.  Prints one ``examples:`` line."""
    import os

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    got = {}
    for script, verdict in EXAMPLES.items():
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable,
                              str(ROOT / "examples_torch" / script),
                              *EXAMPLE_ARGS.get(script, [])],
                             env=env, capture_output=True, text=True,
                             timeout=600)
        sec = time.perf_counter() - t0
        check(out.returncode == 0, f"examples_torch/{script} failed (exit "
              f"{out.returncode}): {out.stderr[-2000:]}")
        lines = out.stdout.splitlines()
        check(f"{verdict}: True" in lines, f"examples_torch/{script} did "
              f"not report '{verdict}: True': {out.stdout[-2000:]}")
        got[script] = {"s": sec, "last_lines": lines[-4:]}
    print("examples: " + json.dumps(got))


def paper_kernel_keys(torch, recs) -> dict:
    """K1-K4 at the paper path's inputs against their plain versions
    (K1 the whole store, K2 the bands tier's one launch over it, in
    column blocks for the plain version, and K2's full form over the same
    block and store; K3 and K4 their largest calls, K4 with its cutoffs):
    ``paper_path_*`` keys for each record."""
    import torch.nn.functional as F

    from repro_torch.core.lower_bounds import _n_bands
    from repro_torch.kernels import ref
    from repro_torch.kernels.dtw_band import dtw_band_cuda
    from repro_torch.kernels.envelope import envelope_cuda
    from repro_torch.kernels.lb_enhanced import lb_enhanced_cuda
    from repro_torch.kernels.lb_enhanced_pairwise import (
        lb_enhanced_pairwise_cuda)

    keys = {}
    b, w = recs["envelope_cuda"].args
    N, L = b.shape
    err = compare("envelope (paper path)", envelope_cuda(b, w),
                  ref.envelope_ref(b, w), exact=True)
    # the library time: max_pool1d of [x, -x] over the window, as at the
    # main path's store
    stacked = torch.stack([b, -b])
    keys["envelope"] = dict(
        paper_path_shape=f"N={N} L={L} w={w}", paper_path_max_abs_err=err,
        paper_path_ms=time_ms(lambda: envelope_cuda(b, w), 5),
        paper_path_plain_ms=time_ms(lambda: ref.envelope_ref(b, w), 2,
                                    warmup=1),
        paper_path_bound_ms=bound(12.0 * N * L, 6.0 * N * L)[0],
        paper_path_library_ms=time_ms(lambda: F.max_pool1d(
            stacked, 2 * w + 1, stride=1, padding=w), 3, warmup=1))
    del stacked

    args = recs["lb_enhanced_cuda"].args
    kw = recs["lb_enhanced_cuda"].kwargs
    q, c, u, lo, w2, v = args
    check(kw.get("bands_only") is True and c.shape[0] == N,
          "paper path: the bands tier did not run one launch over the store")
    Q, C = q.shape[0], c.shape[0]
    got = lb_enhanced_cuda(*args, **kw)
    blk = 65536

    def plain():
        return torch.cat([ref.lb_enhanced_ref(
            q, c[s:s + blk], u[s:s + blk], lo[s:s + blk], w2, v,
            bands_only=True) for s in range(0, C, blk)], dim=1)

    err = compare("lb_enhanced bands (paper path)", got, plain(), exact=True)
    nb = _n_bands(L, w2, v)
    keys["lb_enhanced"] = dict(
        paper_path_shape=f"Q={Q} C={C} L={L} w={w2} v={v} bands_only (a "
                         "query block's tier call)",
        paper_path_max_abs_err=err,
        paper_path_ms=time_ms(lambda: lb_enhanced_cuda(*args, **kw), 10),
        paper_path_plain_ms=time_ms(plain, 1, warmup=0),
        paper_path_bound_ms=bound(4.0 * Q * C + 8.0 * nb * (Q + C),
                                  float(band_ops(nb)) * Q * C)[0])

    # K2's full form on the same block and store (the dense tier the
    # paper path would run unstaged), CUDA events; the plain version over
    # the first 512 candidates only (it materialises (Q, C, L))
    err = compare("lb_enhanced_full (paper path, 512 candidates)",
                  lb_enhanced_cuda(q, c, u, lo, w2, v)[:, :512],
                  ref.lb_enhanced_ref(q, c[:512], u[:512], lo[:512], w2, v),
                  exact=False)
    props = torch.cuda.get_device_properties(q.device)
    keys["lb_enhanced_full"] = dict(
        paper_path_shape=f"Q={Q} C={C} L={L} w={w2} v={v} (a query block "
                         "against the paper store)",
        paper_path_max_abs_err=err,
        paper_path_ms=time_ms(lambda: lb_enhanced_cuda(q, c, u, lo, w2, v),
                              5),
        paper_path_plain_512_candidates_ms=time_ms(
            lambda: ref.lb_enhanced_ref(q, c[:512], u[:512], lo[:512], w2,
                                        v), 2, warmup=1),
        paper_path_bound_ms=bound(
            4.0 * (Q * L + 3 * C * L) + 4.0 * Q * C,
            float(band_ops(nb) + 5 * (L - 2 * nb) + 1) * Q * C)[0],
        paper_path_issue_floor_ms=4.0 * Q * C * (L - 2 * nb) / (
            props.multi_processor_count * 128 * max_sm_clock_hz()) * 1e3)

    args = recs["lb_enhanced_pairwise_cuda"].args
    kw = recs["lb_enhanced_pairwise_cuda"].kwargs
    q, c, u, lo, w3, v = args
    P = q.shape[0]
    err = compare("lb_enhanced_pairwise (paper path)",
                  lb_enhanced_pairwise_cuda(*args, **kw),
                  ref.lb_enhanced_pairwise_ref(*args, **kw), exact=False)
    live = kw.get("live")
    n_live = P if live is None else int(live.sum().item())
    nb = _n_bands(L, w3, v)
    keys["lb_enhanced_pairwise"] = dict(
        paper_path_shape=f"P={P} L={L} w={w3} v={v} live={n_live}",
        paper_path_max_abs_err=err,
        paper_path_ms=time_ms(lambda: lb_enhanced_pairwise_cuda(*args, **kw),
                              20),
        paper_path_plain_ms=time_ms(
            lambda: ref.lb_enhanced_pairwise_ref(*args, **kw), 3),
        # live pairs only: a dead tile is skipped
        paper_path_bound_ms=bound(
            12.0 * n_live * (L - 2 * nb) + 16.0 * nb * n_live + 4.0 * P,
            6.0 * n_live * (L - 2 * nb) + float(band_ops(nb)) * n_live)[0])

    a, bb, w4, cut = recs["dtw_band_cuda"].args
    P = a.shape[0]
    want, plain_ms = timed(lambda: ref.dtw_band_ref(a, bb, w4, cut))
    err = compare("dtw_band (paper path, with cutoffs)",
                  dtw_band_cuda(a, bb, w4, cut), want, exact=True)
    err_nc = compare("dtw_band (paper path, no cutoff)",
                     dtw_band_cuda(a, bb, w4), ref.dtw_band_ref(a, bb, w4),
                     exact=True)
    cells = band_cells(L, w4) * P
    ms = time_ms(lambda: dtw_band_cuda(a, bb, w4), 10)
    keys["dtw_band"] = dict(
        paper_path_shape=f"P={P} L={L} w={w4} (the largest round), no "
                         "cutoff",
        paper_path_max_abs_err=max(err, err_nc), paper_path_ms=ms,
        paper_path_cells_per_s=cells / (ms * 1e-3),
        paper_path_with_cutoffs_ms=time_ms(
            lambda: dtw_band_cuda(a, bb, w4, cut), 10),
        paper_path_plain_with_cutoffs_ms=plain_ms,
        paper_path_bound_ms=bound(8.0 * P * L + 8.0 * P, 5.0 * cells)[0])
    return keys


def guard_phase(torch, ds, main_index, main_cfg, dev) -> None:
    """A corrupted DTW route (``faults.corrupt_dtw(scale=0.05)``) on 4
    queries of the main-path store.

    First on the main path's own index and config (w = 51): the shrunk
    seed DTW becomes every later pair's cutoff, those pairs abandon and
    return +inf, which admissibility cannot compare, so the seeds are its
    only samples, and it trips only where a seed's bound exceeds 5 % of
    its true DTW.  The phase prints that run's guard report and, as the
    reading that explains it, the ratio LB_ENHANCED / DTW at the pairs it
    returned (the seeds, when it does not trip) and over all 4 x N pairs.
    A trip there must degrade and stay exact; no trip is the guards'
    blind spot, which the JAX engine shares (tests/test_torch_guards.py).


    Then on the same store indexed at w = 0, where the bound equals the
    DTW (squared Euclidean distance) and any shrink shows: the guard must
    warn, trip admissibility, degrade once and return the brute-force
    neighbours."""
    from repro_torch.kernels import ops
    from repro_torch.search import (CascadeConfig, EngineConfig,
                                    GuardWarning, brute_force, build_index,
                                    nn_search)
    from repro_torch.testing import faults

    scale = 0.05
    q = ds.x_test[:4]
    qt = torch.as_tensor(q, dtype=torch.float32, device=dev)
    readings = {}
    for label, index, cfg in (
            ("main_index", main_index, main_cfg),
            ("w0", build_index(ds.x_train, 0, ds.y_train, device=dev),
             EngineConfig(cascade=CascadeConfig(w=0, v=V),
                          verify_chunk=VERIFY_CHUNK, k=K))):
        w = cfg.cascade.w
        bd, bi = brute_force(index, q, w, k=K)
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            with faults.corrupt_dtw(scale=scale):
                got, guard = nn_search(index, q, cfg, with_guards=True)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        n_warn = sum(issubclass(c.category, GuardWarning) for c in caught)
        tripped = "admiss_viol" in guard.tripped()
        # LB_ENHANCED^V (the tightest tier) over the true DTW, all pairs
        N = index.n
        lbm = ops.lb_enhanced_op(qt, index.series, index.upper, index.lower,
                                 w, V)
        dtw = ops.dtw_band_op(qt.repeat_interleave(N, dim=0),
                              index.series.repeat(len(q), 1), w
                              ).reshape(len(q), N)
        ratio = lbm / dtw
        at_ret = ratio.gather(1, got.idx.long())
        reading = {
            "w": w, "warnings": n_warn, "tripped": list(guard.tripped()),
            "summary": guard.summary(), "seconds": t1 - t0,
            "n_dtw": got.n_dtw.tolist(),
            "lb_over_dtw_at_returned": at_ret.flatten().tolist(),
            "lb_over_dtw_all_pairs_median": ratio.median().item(),
            "share_of_pairs_above_scale":
                (ratio > scale).float().mean().item()}
        if tripped:
            check(n_warn >= 1, f"guard phase {label}: a trip without a "
                  "GuardWarning")
            check(guard.values()["degraded"] == 1.0,
                  f"guard phase {label}: degraded != 1")
            check(torch.equal(got.idx, bi) and torch.equal(got.dists, bd),
                  f"guard phase {label}: the degraded batch is not the "
                  "brute-force result")
        else:
            check(n_warn == 0 and guard.values()["degraded"] == 0.0,
                  f"guard phase {label}: degraded without a trip")
            reading["dists_over_brute_force"] = (got.dists / bd
                                                 ).flatten().tolist()
        readings[label] = reading
    check("admiss_viol" in readings["w0"]["tripped"],
          f"guard phase: admissibility did not trip at w = 0 "
          f"({readings['w0']['summary']})")
    print("guard phase: " + json.dumps({"queries": len(q), "scale": scale,
                                        **readings}))


def check_search(torch, ds, index, cfg, res):
    from repro_torch.search import brute_force

    w = cfg.cascade.w
    N = index.n
    check(res.dists.shape == (len(ds.x_test), K), "dists shape")
    check(torch.isfinite(res.dists).all().item(), "non-finite distances")
    check(((res.idx >= 0) & (res.idx < N)).all().item(), "ids out of range")
    q64 = ds.x_test[:64]
    t0 = time.perf_counter()
    bd, bi = brute_force(index, q64, w, k=K)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    check(torch.equal(bi, res.idx[:64]),
          "neighbour ids differ from the kernel brute force")
    check(torch.equal(bd, res.dists[:64]),
          "distances not bit-equal to the kernel brute force")
    pd, pi = brute_force(index, ds.x_test[:8], w, k=K, use_kernels=False,
                         chunk=N)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    check(torch.equal(pi, res.idx[:8]),
          "neighbour ids differ from the plain-DTW brute force")
    check(torch.equal(pd, res.dists[:8]),
          "distances not bit-equal to the plain-DTW brute force")
    print(f"search check: ids and distances equal to brute force "
          f"(kernel, 64 queries, {t1 - t0:.3f} s; plain DTW, 8 queries, "
          f"{t2 - t1:.3f} s)")


def profile_call(torch, fn, label: str, top: int = 12) -> None:
    """``--profile``: one warm call of ``fn`` under ``torch.profiler``;
    prints the wall time, the summed device time of every kernel (the
    device's busy time: one stream, so launches do not overlap) and the
    kernels that took most of it.  Only device-side entries count: an
    ``aten::`` op's device time is its kernels' again, and "Command
    Buffer Full" marks a stalled launch queue, not device work."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    prime_profiler()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILER_PAD_S)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0)
        if (us > 0 and getattr(e, "device_type", None) == DeviceType.CUDA
                and e.key != "Command Buffer Full"):
            rows.append((e.key[:60], e.count, us / 1e3))
    rows.sort(key=lambda r: -r[2])
    busy = sum(r[2] for r in rows) / 1e3
    print(f"profile ({label}, profiled): " + json.dumps({
        "wall_s": wall, "device_busy_s": busy,
        "idle_share": 1.0 - busy / wall,
        "top_kernels_name_count_ms": rows[:top],
        "port_kernels_name_count_ms": [
            r for r in rows if any(k in r[0] for k in PORT_KERNELS)]}))


def profile_search(torch, ds, index, cfg, label: str) -> None:
    """``--profile``: one warm ``nn_search`` of a search path."""
    from repro_torch.search import nn_search

    profile_call(torch, lambda: nn_search(index, ds.x_test, cfg),
                 f"{label}, warm nn_search")


def lm_request_line(name: str, req: dict) -> None:
    import torch

    req["memory_allocated_after"] = torch.cuda.memory_allocated()
    print(f"lm request {name}: " + json.dumps(req))


def lm_weights(torch, dev, arch):
    """A configuration (by name, at full width and depth, or an
    ``ArchConfig``), f32 weights drawn on the card from ``LM_SEED`` and
    their bf16 compute copy, made once, and the generator (which then
    draws the prompts)."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import LM

    cfg = ARCHS[arch] if isinstance(arch, str) else arch
    gen = torch.Generator(device=dev).manual_seed(LM_SEED)
    t0 = time.perf_counter()
    params = LM(cfg).init(gen, device=dev)
    cparams = LM(cfg).compute_params(params)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in torch.utils._pytree.tree_leaves(params))
    print(f"lm weights {cfg.name}: " + json.dumps({
        "n_layers": cfg.n_layers, "params": n,
        "config_n_params": cfg.n_params(), "f32_bytes": 4 * n,
        "init_and_cast_s": time.perf_counter() - t0,
        "memory_allocated": torch.cuda.memory_allocated()}))
    return cfg, params, cparams, gen


def lm_models(torch, cfg, dtype) -> dict:
    """The kernel route and the plain route, computing (and caching) in
    ``dtype``."""
    from repro_torch.models import LM

    kw = dict(compute_dtype=dtype, cache_dtype=dtype)
    return {"kernel": LM(cfg, attn_impl="kernel", ssm_impl="kernel", **kw),
            "plain": LM(cfg, **kw)}


def lm_prefill(torch, model, cparams, batch, max_len=None):
    """One ``LM.prefill`` of ``batch`` (an input dict, or a token tensor)
    with the launch counts set to 0 just before and read just after;
    returns (logits, caches, seconds, counts, peak bytes)."""
    from repro_torch.kernels import _build

    if not isinstance(batch, dict):
        batch = {"tokens": batch}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_counts()
    t0 = time.perf_counter()
    logits, caches, _ = model.prefill(cparams, batch, max_len=max_len)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    check(torch.isfinite(logits).all().item(), "non-finite prefill logits")
    return (logits, caches, secs, _build.counts(),
            torch.cuda.max_memory_allocated())


def lm_greedy(torch, model, cparams, prompt, n_new: int, vocab: int):
    """``greedy_decode`` with the counts set to 0 just before and read
    just after; checks the tokens.  Its prefill is timed on its own just
    before, as ``greedy_decode`` runs it (a ``DecodeSession`` with a cache
    of S + ``n_new``), and the steps' seconds are the rest of
    ``greedy_decode``'s.  That session then takes one step with the peak
    reset after its prefill: ``step_max_memory_allocated`` is the peak of
    one decode step, what the dry-run's decode cell predicts (the whole
    request's peak is its prefill's).  Returns (tokens, timings, counts,
    peak bytes)."""
    from repro_torch.kernels import _build
    from repro_torch.serve import DecodeSession, greedy_decode

    sess = DecodeSession(model, cparams, max_len=prompt.shape[1] + n_new)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits = sess.prefill({"tokens": prompt})
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    cache_bytes = sum(t.nbytes for c in sess.caches for t in c.values())
    tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    del logits
    torch.cuda.reset_peak_memory_stats()
    sess.step(tok)
    torch.cuda.synchronize()
    step_peak = torch.cuda.max_memory_allocated()
    del sess, tok
    torch.cuda.reset_peak_memory_stats()
    _build.reset_counts()
    t0 = time.perf_counter()
    toks = greedy_decode(model, cparams, prompt, n_new)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    counts = _build.counts()
    check(toks.shape == (prompt.shape[0], n_new), "greedy_decode shape")
    check(bool(((toks >= 0) & (toks < vocab)).all()),
          "greedy_decode: a token outside [0, vocab)")
    timings = {"greedy_decode_s": total_s, "prefill_s": prefill_s,
               "decode_s": total_s - prefill_s, "cache_bytes": cache_bytes,
               "step_max_memory_allocated": step_peak}
    return toks, timings, counts, torch.cuda.max_memory_allocated()


def lm_first_step(torch, model, cparams, prompt, kname: str,
                  n_launches: int, prefill_launches: int):
    """A ``DecodeSession`` prefill of ``prompt`` (a token tensor or an
    input dict; ``prefill_launches`` of ``kname``) and its first step (no
    launch), and a full-cache prefill of prompt + token (``n_launches``:
    the kernel once per layer of its mixer).  Returns (step logits,
    prefill logits)."""
    from repro_torch.kernels import _build
    from repro_torch.serve import DecodeSession

    batch = prompt if isinstance(prompt, dict) else {"tokens": prompt}
    S = batch["tokens"].shape[1]
    sess = DecodeSession(model, cparams, max_len=S + 1)
    _build.reset_counts()
    logits0 = sess.prefill(batch)
    torch.cuda.synchronize()
    check(_build.counts()[kname] == prefill_launches,
          f"session prefill: {kname} launched {_build.counts()[kname]} "
          f"times, expected {prefill_launches}")
    tok = torch.argmax(logits0, -1)[:, None]
    _build.reset_counts()
    step = sess.step(tok)
    torch.cuda.synchronize()
    check(sum(_build.counts().values()) == 0,
          f"a decode step launched a kernel: {_build.counts()}")
    check(torch.isfinite(step).all().item(), "non-finite step logits")
    del sess
    want, _, _, counts, _ = lm_prefill(torch, model, cparams,
                                       extend_batch(torch, batch, tok))
    check(counts[kname] == n_launches, f"full-cache prefill: {kname} "
          f"launched {counts[kname]} times, expected {n_launches}")
    return step, want


def extend_batch(torch, batch: dict, tok) -> dict:
    """``batch`` with the (B, 1) tokens ``tok`` appended, at the decode
    step's position (every M-RoPE stream at the old length)."""
    out = dict(batch)
    out["tokens"] = torch.cat([batch["tokens"],
                               tok.to(batch["tokens"].dtype)], dim=1)
    if "positions" in batch:
        p = batch["positions"]
        out["positions"] = torch.cat(
            [p, torch.full_like(p[..., :1], p.shape[-1])], dim=-1)
    return out


def n_kernel_layers(cfg, kname: str) -> int:
    """Layers whose mixer launches ``kname`` in a kernel-route prefill
    (K9's counts: attention layers; K10's: Mamba layers)."""
    mixer = "mamba" if kname.startswith("mamba") else "attn"
    return sum(cfg.layer_spec(i).mixer == mixer for i in range(cfg.n_layers))


def max_abs(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def bf16_check(name: str, cfg, err: float) -> None:
    """A bf16 difference against the model's ``LM_BF16_MAX_ABS``."""
    limit = LM_BF16_MAX_ABS[cfg.name]
    check(err <= limit, f"{name}: max abs difference {err} > {limit}")


def lm_route_checks(torch, label: str, cfg, params, cparams, batch,
                    logits16, cfg32=None, noise: bool = False) -> dict:
    """``lm_bf16_route_checks`` of the served tree ``cparams``, then
    ``lm_f32_route_check`` of the f32 weights ``params`` of ``cfg32``
    (default ``cfg``: a depth cut of the served model)."""
    out = lm_bf16_route_checks(torch, label, cfg, cparams, batch, logits16,
                               noise)
    out.update(lm_f32_route_check(torch, label, cfg32 or cfg, params, batch))
    return out


def lm_bf16_route_checks(torch, label: str, cfg, cparams, batch, logits16,
                         noise: bool = False) -> dict:
    """The kernel route's bf16 prefill logits (``logits16``) against the
    plain route's, held to ``LM_BF16_MAX_ABS``.  With ``noise``, also a
    second plain route with smaller chunks (KV chunk 512 and scan chunk 64
    against the plain route's 1024 and 256, or a quarter of the prompt
    where that is shorter): the bf16 noise of summation order that
    ``LM_BF16_MAX_ABS`` is set from.  For a model with MoE layers, the
    share of (token, layer) routings whose expert sets the two routes
    share (``RouteRecorder``) and the expert rows the kernel route's
    routing keeps (``kept_expert_rows``).  Returns the readings."""
    from repro_torch.models import LM

    moe = n_moe_layers(cfg) > 0
    m16 = lm_models(torch, cfg, torch.bfloat16)
    rec = RouteRecorder() if moe else None
    try:
        plain, _, plain_s, counts, _ = lm_prefill(torch, m16["plain"],
                                                  cparams, batch)
        check_launches(f"{label} bf16 plain route prefill", counts, {})
        out = {"plain_route_prefill_s": plain_s}
        if moe:
            plain_ids = rec.take()
            again = lm_prefill(torch, m16["kernel"], cparams, batch)[0]
            check(torch.equal(again, logits16), f"{label}: a second kernel "
                  "route prefill gave other logits")
            kernel_ids = rec.take()
            out["bf16_routing_agreement_kernel_vs_plain"] = \
                RouteRecorder.agreement(kernel_ids, plain_ids)
            out["moe_kept_expert_rows"] = kept_expert_rows(cfg, kernel_ids)
        if noise:
            S = next(iter(batch.values())).shape[1] \
                if isinstance(batch, dict) else batch.shape[1]
            chunks = dict(kv_chunk=min(512, S // 4),
                          mamba_chunk=min(64, S // 4))
            small = lm_prefill(torch, LM(cfg, compute_dtype=torch.bfloat16,
                                         cache_dtype=torch.bfloat16,
                                         **chunks), cparams, batch)[0]
            out["bf16_plain_chunk_noise_max_abs"] = max_abs(small, plain)
            out["bf16_plain_chunk_noise_chunks"] = chunks
            if moe:
                out["bf16_routing_agreement_plain_chunks"] = \
                    RouteRecorder.agreement(rec.take(), plain_ids)
            del small
    finally:
        if rec is not None:
            rec.restore()
    err16 = max_abs(logits16, plain)
    bf16_check(f"{label} bf16 prefill, kernel vs plain route", cfg, err16)
    out.update({"bf16_vs_plain_max_abs_err": err16,
                "bf16_logits_max_abs": plain.abs().max().item(),
                "bf16_argmax_equal_to_plain": bool(torch.equal(
                    logits16.argmax(-1), plain.argmax(-1)))})
    return out


def lm_f32_route_check(torch, label: str, cfg32, params, batch) -> dict:
    """The same prefill in f32 compute through both routes on ``cfg32``
    (f32 weights ``params``), held to ``LM_F32_TOL``; the kernel route
    launches K9's f32 form once an attention layer and K10 once a Mamba
    layer, the plain route nothing."""
    m32 = lm_models(torch, cfg32, torch.float32)
    k32, _, _, counts, _ = lm_prefill(torch, m32["kernel"], params, batch)
    check_launches(f"{label} f32 kernel route prefill", counts,
                   prefill_launches(cfg32, torch.float32))
    p32, _, _, counts, _ = lm_prefill(torch, m32["plain"], params, batch)
    check_launches(f"{label} f32 plain route prefill", counts, {})
    err32 = compare(f"{label} f32 prefill, kernel vs plain route", k32,
                    p32, exact=False, **LM_F32_TOL)
    return {"f32_vs_plain_max_abs_err": err32, "f32_layers": cfg32.n_layers}


def n_moe_layers(cfg) -> int:
    return sum(cfg.layer_spec(i).moe for i in range(cfg.n_layers))


def moe_capacity(cfg, n_tokens: int) -> int:
    """``models.moe``'s capacity an expert at the default factor 1.25."""
    return math.ceil(n_tokens * cfg.top_k / cfg.n_experts * 1.25)


def kept_expert_rows(cfg, ids: list) -> int:
    """The expert rows a forward must compute: over the MoE layers'
    routings ``ids`` ((T, k) expert ids each), the assignments within
    their expert's capacity."""
    rows = 0
    for x in ids:
        n = x.reshape(-1).bincount(minlength=cfg.n_experts_padded)
        rows += int(n.clamp(max=moe_capacity(cfg, x.shape[0])).sum())
    return rows


class RouteRecorder:
    """Wraps ``models.blocks.moe_apply`` to keep, for each MoE layer a
    forward runs, the experts each token is routed to (the top k of
    ``models.moe.route`` on the layer's input, the router the layer runs)
    as sorted (T, k) ids."""

    def __init__(self):
        from repro_torch.models import blocks
        from repro_torch.models.moe import route

        self.blocks, self.orig, self.ids = blocks, blocks.moe_apply, []

        def recorded(p, x, **kw):
            ids = route(x.reshape(-1, x.shape[-1]), p["router"], kw["top_k"],
                        kw["n_real"])[3]
            self.ids.append(ids.sort(dim=-1).values)
            return self.orig(p, x, **kw)

        blocks.moe_apply = recorded

    def take(self) -> list:
        ids, self.ids = self.ids, []
        return ids

    def restore(self) -> None:
        self.blocks.moe_apply = self.orig

    @staticmethod
    def agreement(a: list, b: list) -> float:
        """The share of (token, layer) pairs whose expert sets agree."""
        check(len(a) == len(b) and len(a) > 0,
              f"routings of {len(a)} and {len(b)} MoE layers")
        same = sum(int((x == y).all(-1).sum()) for x, y in zip(a, b))
        return same / sum(x.shape[0] for x in a)


def lm_step_checks(torch, label: str, cfg, params, cparams, prompt,
                   kname: str, prefill_launches: int,
                   kname32: str | None = None) -> dict:
    """The first decode step against a full-cache prefill of prompt +
    token: in bf16 held to ``LM_BF16_MAX_ABS``, in f32 compute (launching
    ``kname32``, default ``kname``) to ``LM_F32_TOL``."""
    step, want = lm_first_step(
        torch, lm_models(torch, cfg, torch.bfloat16)["kernel"], cparams,
        prompt, kname, n_kernel_layers(cfg, kname), prefill_launches)
    err16 = max_abs(step, want)
    bf16_check(f"{label} bf16 first decode step vs full-cache prefill",
               cfg, err16)
    step, want = lm_first_step(
        torch, lm_models(torch, cfg, torch.float32)["kernel"], params,
        prompt, kname32 or kname, n_kernel_layers(cfg, kname32 or kname),
        prefill_launches)
    err32 = compare(f"{label} f32 first decode step vs full-cache prefill",
                    step, want, exact=False, **LM_F32_TOL)
    return {"bf16_first_step_vs_full_prefill_max_abs_err": err16,
            "f32_first_step_vs_full_prefill_max_abs_err": err32}


def run_lm_phase(torch, dev, profile: bool, readings: dict | None = None):
    """The LM serve phase: gemma2-2b's scoring prefill and greedy decode,
    then falcon-mamba-7b's greedy decode and prefill, at full width in
    bf16, each request in its own launch-count window, with the route and
    first-step checks of ``lm_route_checks`` and ``lm_step_checks``.
    Returns the windows' counts and the recorded K9 (a local and a global
    layer) and K10 inputs; fills ``readings`` with gemma2-2b's memory
    readings for the dryrun phase."""
    from repro_torch.kernels import ops

    windows, recs = {}, {}
    readings = {} if readings is None else readings
    tol = {"f32": LM_F32_TOL, "bf16_max_abs": LM_BF16_MAX_ABS}

    # ---- gemma2-2b: prompt scoring (full cache, K9 in every layer) -----
    resident = torch.cuda.memory_allocated()
    cfg, params, cp, gen = lm_weights(torch, dev, "gemma2-2b")
    kern = lm_models(torch, cfg, torch.bfloat16)["kernel"]
    tokens = torch.randint(0, cfg.vocab, (LM_SCORE["batch"],
                                          LM_SCORE["prompt"]),
                           generator=gen, device=dev)
    rec = Recorder(ops, "flash_attention_cuda", keep=2)
    logits, caches, secs, counts, peak = lm_prefill(torch, kern, cp, tokens)
    rec.restore()
    recs["flash_attention"] = rec.calls         # layer 0 local, 1 global
    readings["gemma-score"] = {
        "peak": peak, "resident": resident,
        "cache_bytes": sum(t.nbytes for c in caches for t in c.values())}
    del rec, caches
    windows["lm_score"] = counts
    check(counts["flash_attention"] == cfg.n_layers,
          f"scoring prefill: K9 launched {counts['flash_attention']} "
          f"times, expected {cfg.n_layers}")
    check(logits.shape == (LM_SCORE["batch"], cfg.vocab), "scoring logits")
    route = lm_route_checks(torch, "gemma2-2b scoring", cfg, params, cp,
                            tokens, logits)
    lm_request_line("gemma2-2b score", prefill_line(
        cfg, {"tokens": tokens}, secs, counts, peak, route, tol,
        "LM.prefill(params, {tokens}), full cache",
        {"batch": "prefill_32k's 32 -> 2", "prompt": "32768 -> 8192"}))
    if profile:
        profile_call(torch, lambda: kern.prefill(cp, {"tokens": tokens}),
                     "gemma2-2b scoring prefill")
    del logits, tokens

    # ---- gemma2-2b: greedy decode (prefill into S + 32: no K9) ---------
    prompt = torch.randint(0, cfg.vocab, (LM_GEMMA["batch"],
                                          LM_GEMMA["prompt"]),
                           generator=gen, device=dev)
    toks, tm, counts, peak = lm_greedy(torch, kern, cp, prompt,
                                       LM_GEMMA["new"], cfg.vocab)
    windows["lm_gemma_decode"] = counts
    readings["gemma-decode"] = {"peak": tm["step_max_memory_allocated"],
                                "resident": resident,
                                "cache_bytes": tm["cache_bytes"]}
    check(counts["flash_attention"] == 0, "gemma2-2b greedy_decode "
          f"launched K9 {counts['flash_attention']} times, expected 0")
    steps = lm_step_checks(torch, "gemma2-2b", cfg, params, cp, prompt,
                           "flash_attention", 0, "flash_attention_f32")
    lm_request_line("gemma2-2b greedy_decode", {
        "model": cfg.name, "B": LM_GEMMA["batch"],
        "prompt": LM_GEMMA["prompt"], "new_tokens": LM_GEMMA["new"],
        "call": "greedy_decode", **tm,
        "prompt_tokens_per_s": prompt.numel() / tm["prefill_s"],
        "decode_tokens_per_s":
            LM_GEMMA["batch"] * (LM_GEMMA["new"] - 1) / tm["decode_s"],
        "launches": {k: v for k, v in counts.items() if v},
        "max_memory_allocated": peak, **steps, "tol": tol,
        "tokens_row0": toks[0].tolist()})
    del kern, params, cp, prompt, toks
    gc.collect()
    torch.cuda.empty_cache()

    # ---- falcon-mamba-7b: greedy decode, then LM.prefill ---------------
    cfg, params, cp, gen = lm_weights(torch, dev, "falcon-mamba-7b")
    kern = lm_models(torch, cfg, torch.bfloat16)["kernel"]
    prompt = torch.randint(0, cfg.vocab, (LM_FALCON["batch"],
                                          LM_FALCON["prompt"]),
                           generator=gen, device=dev)
    rec = Recorder(ops, "mamba_scan_cuda")
    toks, tm, counts, peak = lm_greedy(torch, kern, cp, prompt,
                                       LM_FALCON["new"], cfg.vocab)
    rec.restore()
    recs["mamba_scan"] = rec.args
    del rec
    windows["lm_falcon_decode"] = counts
    check(counts["mamba_scan"] == cfg.n_layers, "falcon greedy_decode: "
          f"K10 launched {counts['mamba_scan']} times, expected "
          f"{cfg.n_layers} (the prefill's; 0 per step)")
    decode_line = {
        "model": cfg.name, "B": LM_FALCON["batch"],
        "prompt": LM_FALCON["prompt"], "new_tokens": LM_FALCON["new"],
        "call": "greedy_decode", **tm,
        "prompt_tokens_per_s": prompt.numel() / tm["prefill_s"],
        "decode_tokens_per_s":
            LM_FALCON["batch"] * (LM_FALCON["new"] - 1) / tm["decode_s"],
        "launches": {k: v for k, v in counts.items() if v},
        "max_memory_allocated": peak, "tokens_row0": toks[0].tolist()}
    logits, caches, secs, counts, peak = lm_prefill(torch, kern, cp, prompt)
    del caches
    windows["lm_falcon_prefill"] = counts
    check(counts["mamba_scan"] == cfg.n_layers, "falcon prefill: K10 "
          f"launched {counts['mamba_scan']} times, expected {cfg.n_layers}")
    check(logits.shape == (LM_FALCON["batch"], cfg.vocab),
          "falcon prefill logits")
    route = lm_route_checks(torch, "falcon-mamba-7b", cfg, params, cp,
                            prompt, logits)
    steps = lm_step_checks(torch, "falcon-mamba-7b", cfg, params, cp,
                           prompt, "mamba_scan", cfg.n_layers)
    lm_request_line("falcon-mamba-7b greedy_decode",
                    {**decode_line, **steps, "tol": tol})
    lm_request_line("falcon-mamba-7b prefill", prefill_line(
        cfg, {"tokens": prompt}, secs, counts, peak, route, tol,
        "LM.prefill(params, {tokens}), the same prompts", {}))
    if profile:
        profile_call(torch, lambda: kern.prefill(cp, {"tokens": prompt}),
                     "falcon-mamba-7b prefill")
    del kern, params, cp, prompt, logits
    gc.collect()
    torch.cuda.empty_cache()
    return windows, recs


# ---------------------------------------------------------------------------
# LM families: MoE, hybrid, VLM and audio
# ---------------------------------------------------------------------------

def lm_served_weights(torch, dev, cfg):
    """The bf16 compute tree of ``cfg`` drawn on the card from ``LM_SEED``
    by ``LM.init(dtype=bfloat16)``, which casts each part as it is drawn:
    qwen2-moe-a2.7b's f32 tree (60.6 GB) and its bf16 copy do not fit 80
    GB together, nor does one of jamba's f32 MoE layers (38.7 GB) beside
    its other bf16 layers and that layer's bf16 copy.  Returns the tree
    and the generator (which then draws the prompts)."""
    from repro_torch.models import LM
    from repro_torch.tree import tree_leaves

    gen = torch.Generator(device=dev).manual_seed(LM_SEED)
    t0 = time.perf_counter()
    cp = LM(cfg).init(gen, device=dev, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in tree_leaves(cp))
    print(f"lm weights {cfg.name}: " + json.dumps({
        "n_layers": cfg.n_layers, "params": n,
        "config_n_params": cfg.n_params(),
        "bf16_bytes": sum(t.numel() * t.element_size()
                          for t in tree_leaves(cp)),
        "built": "LM.init(dtype=bfloat16): each part f32 drawn, then cast",
        "init_and_cast_s": time.perf_counter() - t0,
        "memory_allocated": torch.cuda.memory_allocated(),
        "max_memory_allocated": torch.cuda.max_memory_allocated()}))
    return cp, gen


def lm_f32_cut(torch, dev, cfg, n_layers: int):
    """The served model's width at ``n_layers`` layers, f32 weights drawn
    by ``LM.init`` from ``LM_SEED`` for the f32 route checks: its
    embedding and layers are the served tree's first ones in f32 (the
    same draws; the CPU tests hold ``LM.init(dtype=)`` to
    ``compute_params`` of ``LM.init``)."""
    from repro_torch.models import LM

    cut = dataclasses.replace(cfg, n_layers=n_layers)
    gen = torch.Generator(device=dev).manual_seed(LM_SEED)
    return cut, LM(cut).init(gen, device=dev)


def prefill_launches(cfg, dtype) -> dict:
    """The launches of a kernel-route prefill into a full cache: K9's form
    for ``dtype`` once an attention layer, K10 once a Mamba layer."""
    from repro_torch.kernels.flash_attention import k9_form
    from repro_torch.kernels.mamba_scan import MAX_STATE

    k9 = ("flash_attention" if k9_form(dtype, cfg.head_dim) == "bf16"
          else "flash_attention_f32")
    k10 = "mamba_scan" if cfg.ssm_state <= MAX_STATE else "mamba_scan_wide"
    out = {k9: n_kernel_layers(cfg, k9), k10: n_kernel_layers(cfg, k10)}
    return {k: v for k, v in out.items() if v}


def check_launches(label: str, counts: dict, want: dict) -> None:
    got = {k: v for k, v in counts.items() if v}
    check(got == want, f"{label}: launches {got}, expected {want}")


def grow_caches(torch, caches: list, n: int) -> list:
    """A full-cache prefill's caches with ``n`` free slots appended to
    each KV cache (an SSM state has no length)."""
    import torch.nn.functional as F

    for c in caches:
        if "k" in c:
            for key in ("k", "v"):
                c[key] = F.pad(c[key], (0, 0, 0, 0, 0, n))
    return caches


def lm_moe_step_check(torch, label: str, dname: str, cfg, params,
                      prompt) -> dict:
    """The decode-step gate of a model with MoE layers, in ``dname``
    ("bf16": the served tree, held to ``LM_BF16_MAX_ABS``; "f32": f32
    weights of a depth cut ``cfg``, held to ``LM_F32_TOL``): the kernel
    route's first decode step against the plain route's, each from its
    own full-cache prefill of ``prompt`` (the kernel route's launching K9
    in every attention layer, K10 in every Mamba layer), grown by one slot
    and fed the kernel route's greedy token.  A step's T = B tokens give
    capacity ceil(B k / n_real x 1.25) (1 for qwen2-moe-a2.7b at B = 4),
    so a step drops assignments a prefill of prompt + token keeps (JAX's
    semantics): the steps are held against each other, which have the
    same capacity.  No step launches a kernel."""
    from repro_torch.kernels import _build

    dtype = torch.bfloat16 if dname == "bf16" else torch.float32
    models = lm_models(torch, cfg, dtype)
    steps, tok = {}, None
    for route in ("kernel", "plain"):
        logits, caches, _, counts, _ = lm_prefill(torch, models[route],
                                                  params, prompt)
        check_launches(f"{label} {dname} {route} prefill", counts,
                       prefill_launches(cfg, dtype) if route == "kernel"
                       else {})
        if tok is None:
            tok = torch.argmax(logits, -1)[:, None]
        caches = grow_caches(torch, caches, 1)
        _build.reset_counts()
        steps[route], _ = models[route].decode_step(params, caches, tok,
                                                    prompt.shape[1])
        torch.cuda.synchronize()
        check_launches(f"{label} {dname} {route} decode step",
                       _build.counts(), {})
        check(torch.isfinite(steps[route]).all().item(),
              f"{label}: non-finite step logits")
        del logits, caches
    name = f"{label} {dname} first decode step, kernel vs plain route"
    if dname == "bf16":
        err = max_abs(steps["kernel"], steps["plain"])
        bf16_check(name, cfg, err)
        return {"bf16_first_step_kernel_vs_plain_max_abs_err": err}
    err = compare(name, steps["kernel"], steps["plain"], exact=False,
                  **LM_F32_TOL)
    return {"f32_first_step_kernel_vs_plain_max_abs_err": err,
            "f32_step_layers": cfg.n_layers}


def lm_prefill_flop(cfg, B: int, S: int, expert_rows: int) -> float | None:
    """FLOPs of a full-cache prefill of B x S tokens (None for a model
    with Mamba layers): 2 per weight each token's products read
    (attention projections, dense MLPs, shared experts, routers), 2 x 3 d
    f for each of ``expert_rows`` routed-expert rows over the MoE layers,
    4 D Hq per unmasked (query, key) pair of each attention layer, and the
    head for the last tokens."""
    d, T, dh = cfg.d_model, B * S, cfg.head_dim
    fe = cfg.d_expert or cfg.d_ff
    flop = 2.0 * B * d * cfg.vocab + 2.0 * 3 * d * fe * expert_rows
    for i in range(cfg.n_layers):
        spec = cfg.layer_spec(i)
        if spec.mixer != "attn":
            return None
        flop += 2.0 * T * d * dh * (2 * cfg.n_heads + 2 * cfg.n_kv_heads)
        flop += 4.0 * dh * cfg.n_heads * B * attn_pairs(S, S, cfg.causal,
                                                        spec.window)
        if spec.moe:
            flop += 2.0 * T * d * cfg.n_experts_padded
            flop += 2.0 * T * 3 * d * fe * cfg.n_shared_experts
        else:
            flop += 2.0 * T * (3 if cfg.act == "silu" else 2) * d * cfg.d_ff
    return flop


def prefill_line(cfg, batch, secs, counts, peak, route, tol, call,
                 reduced_: dict) -> dict:
    """An ``lm request`` line of a scoring prefill, with its FLOP bound at
    989 TFLOP/s where ``lm_prefill_flop`` gives one: for a model with MoE
    layers, the least work counts the expert rows this run's routing kept
    (``route["moe_kept_expert_rows"]``), and the dense formulation's
    FLOPs (every padded expert's whole capacity buffer, as the ``bmm``
    and JAX's ``einsum`` compute it) stand beside it."""
    x = batch.get("tokens", batch.get("frames"))
    B, S = x.shape[:2]
    line = {"model": cfg.name, "n_layers": cfg.n_layers, "B": B,
            "prompt": S, "new_tokens": 0, "call": call, "prefill_s": secs,
            "prompt_tokens_per_s": B * S / secs,
            "decode_tokens_per_s": None}
    rows = 0
    if n_moe_layers(cfg):
        rows = route["moe_kept_expert_rows"]
        dense = (n_moe_layers(cfg) * cfg.n_experts_padded
                 * moe_capacity(cfg, B * S))
        line.update({"moe_expert_rows_kept": rows,
                     "moe_expert_rows_dense": dense,
                     "prefill_dense_einsum_flop":
                         lm_prefill_flop(cfg, B, S, dense)})
    flop = lm_prefill_flop(cfg, B, S, rows)
    line.update({"prefill_flop": flop,
                 "prefill_bound_s": None if flop is None
                 else flop / PEAK_BF16,
                 "launches": {k: v for k, v in counts.items() if v},
                 "max_memory_allocated": peak, **route, "tol": tol,
                 "reduced": reduced_})
    return line


def decode_routed_experts(torch, model, cparams, prompt, toks) -> float:
    """The experts a ``greedy_decode``'s steps route to, distinct per
    step and MoE layer, summed over the layers and averaged over the
    steps: the same steps again (a ``DecodeSession`` fed ``toks``, the
    tokens ``greedy_decode`` chose) with ``RouteRecorder`` on, outside
    any timing."""
    from repro_torch.serve import DecodeSession

    n_new = toks.shape[1]
    sess = DecodeSession(model, cparams, max_len=prompt.shape[1] + n_new)
    sess.prefill({"tokens": prompt})
    rec = RouteRecorder()
    try:
        for j in range(n_new - 1):
            sess.step(toks[:, j:j + 1])
    finally:
        rec.restore()
    ids = rec.take()
    del sess
    check(len(ids) == (n_new - 1) * n_moe_layers(model.cfg),
          f"recorded {len(ids)} step routings")
    return sum(int(x.unique().numel()) for x in ids) / (n_new - 1)


def decode_bytes(cparams, cfg, B: int, kv_len: float, routed: float,
                 cache_bytes: int = 2) -> dict:
    """The bytes a decode step must move at least: every served parameter
    but the embedding table (B rows gathered; the whole table where the
    head is tied to it) and the expert stacks; ``routed`` experts' weights
    (the experts this run's steps route to, ``decode_routed_experts``);
    the KV caches' ``kv_len`` filled positions in every attention layer
    and each Mamba layer's state and conv window, read and written.
    Beside it, the dense formulation's bytes: every padded expert, as the
    step's ``bmm`` over the capacity buffers (and JAX's ``einsum``) reads
    them."""
    from repro_torch.tree import named_leaves

    total = experts = 0
    for name, t in named_leaves(cparams):
        if "embed" in name and "head" in cparams:
            continue
        nbytes = t.numel() * t.element_size()
        total += nbytes
        if name.endswith(("['moe']['wi']", "['moe']['wg']",
                          "['moe']['wo']")):
            experts += nbytes
    n_moe = n_moe_layers(cfg)
    per_expert = experts / (n_moe * cfg.n_experts_padded) if n_moe else 0
    cache = 0
    for i in range(cfg.n_layers):
        if cfg.layer_spec(i).mixer == "attn":
            cache += 2 * B * kv_len * cfg.n_kv_heads * cfg.head_dim
        else:
            cache += 2 * B * cfg.d_inner_ * (cfg.ssm_state
                                             + cfg.conv_width - 1)
    cache *= cache_bytes
    return {"decode_step_bytes": total - experts + routed * per_expert
            + cache,
            "decode_step_routed_experts": routed,
            "decode_step_cache_bytes": cache,
            "decode_step_dense_einsum_bytes": total + cache}


def decode_bound(nbytes: dict, B: int) -> dict:
    s = nbytes["decode_step_bytes"] / PEAK_BYTES
    return {"decode_step_bound_s": s, "decode_bound_tokens_per_s": B / s,
            "decode_dense_einsum_tokens_per_s":
                B * PEAK_BYTES / nbytes["decode_step_dense_einsum_bytes"]}


def lm_moe_requests(torch, dev, arch: str, label: str, windows: dict,
                    recs: dict, profile: bool) -> None:
    """moe-qwen / moe-deepseek: a 2 x 8192 full-cache scoring prefill (K9
    once an attention layer) with its route checks (f32 on a 2-layer cut),
    then ``greedy_decode`` 4 x 1024 + 32 (no kernel: the cache is S + 32)
    and the MoE decode-step gate."""
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import ops

    cfg = ARCHS[arch]
    cut = {}
    if arch in LM_DEPTH:
        cut["n_layers"] = (f"{cfg.n_layers} -> {LM_DEPTH[arch]}: "
                           + LM_DEPTH_WHY[arch])
        cfg = dataclasses.replace(cfg, n_layers=LM_DEPTH[arch])
    tol = {"f32": LM_F32_TOL, "bf16_max_abs": LM_BF16_MAX_ABS[cfg.name]}
    cp, gen = lm_served_weights(torch, dev, cfg)
    kern = lm_models(torch, cfg, torch.bfloat16)["kernel"]
    tokens = torch.randint(0, cfg.vocab, (LM_SCORE["batch"],
                                          LM_SCORE["prompt"]),
                           generator=gen, device=dev)
    rec = Recorder(ops, "flash_attention_cuda", keep=1)
    logits, caches, secs, counts, peak = lm_prefill(torch, kern, cp, tokens)
    rec.restore()
    recs[label] = rec.calls[0]
    del rec, caches
    windows[f"lm_{label}_score"] = counts
    check_launches(f"{label} scoring prefill", counts,
                   prefill_launches(cfg, torch.bfloat16))
    check(logits.shape == (LM_SCORE["batch"], cfg.vocab), "scoring logits")
    cfg32, p32 = lm_f32_cut(torch, dev, cfg, LM_F32_LAYERS)
    route = lm_route_checks(torch, f"{label} scoring", cfg, p32, cp, tokens,
                            logits, cfg32=cfg32, noise=True)
    lm_request_line(f"{label} score", prefill_line(
        cfg, {"tokens": tokens}, secs, counts, peak, route, tol,
        "LM.prefill(params, {tokens}), full cache",
        {**cut, "batch": "prefill_32k's 32 -> 2", "prompt": "32768 -> 8192",
         "f32_route_check": f"depth {cfg.n_layers} -> {LM_F32_LAYERS} at "
                            "full width (qwen2-moe-a2.7b's f32 tree, 60.6 "
                            "GB, and its bf16 copy exceed 80 GB)"}))
    if profile:
        profile_call(torch, lambda: kern.prefill(cp, {"tokens": tokens}),
                     f"{cfg.name} scoring prefill", top=20)
    del logits, tokens

    d = LM_MOE_DECODE
    prompt = torch.randint(0, cfg.vocab, (d["batch"], d["prompt"]),
                           generator=gen, device=dev)
    toks, tm, counts, peak = lm_greedy(torch, kern, cp, prompt, d["new"],
                                       cfg.vocab)
    windows[f"lm_{label}_decode"] = counts
    check_launches(f"{label} greedy_decode", counts, {})
    steps = lm_moe_step_check(torch, label, "bf16", cfg, cp, prompt)
    steps.update(lm_moe_step_check(torch, label, "f32", cfg32, p32, prompt))
    del p32
    nbytes = decode_bytes(cp, cfg, d["batch"], d["prompt"] + d["new"] / 2,
                          decode_routed_experts(torch, kern, cp, prompt,
                                                toks))
    lm_request_line(f"{label} greedy_decode", {
        "model": cfg.name, "n_layers": cfg.n_layers, "B": d["batch"],
        "prompt": d["prompt"], "new_tokens": d["new"],
        "call": "greedy_decode", **tm,
        "prompt_tokens_per_s": prompt.numel() / tm["prefill_s"],
        "decode_tokens_per_s": d["batch"] * (d["new"] - 1) / tm["decode_s"],
        **nbytes, **decode_bound(nbytes, d["batch"]),
        "launches": {k: v for k, v in counts.items() if v},
        "max_memory_allocated": peak, **steps, "tol": tol,
        "tokens_row0": toks[0].tolist(), "reduced": cut})
    if profile:
        _, caches, _ = kern.prefill(cp, {"tokens": prompt})
        caches = grow_caches(torch, caches, 1)
        tok = toks[:, :1]
        profile_call(torch, lambda: kern.decode_step(cp, caches, tok,
                                                     d["prompt"]),
                     f"{cfg.name} decode step (B = {d['batch']})", top=20)
        del caches
    del kern, cp, prompt, toks
    gc.collect()
    torch.cuda.empty_cache()


def vlm_batch(torch, gen, cfg, dev, B: int, S: int, patches: int,
              grid: int) -> dict:
    """Tokens, ``patches`` patch embeddings over the first positions (the
    vision frontend is a stub, as in the JAX package: random embeddings
    at the token embeddings' scale) and the (B, 3, S) M-RoPE streams: h
    and w the patch's row and column in a ``grid`` x ``grid`` image, and
    for text h = w = t.  t is every token's sequence index: K9 masks by
    row index and the plain route by the t stream (as the JAX package's
    two routes do), so the routes compute one function only when t is the
    row index."""
    t = torch.arange(S, device=dev)
    h, w = t.clone(), t.clone()
    idx = torch.arange(patches, device=dev)
    h[:patches], w[:patches] = idx // grid, idx % grid
    return {
        "tokens": torch.randint(0, cfg.vocab, (B, S), generator=gen,
                                device=dev),
        "vision_embeds": 0.02 * torch.randn(B, patches, cfg.d_model,
                                            generator=gen, device=dev),
        "positions": torch.stack([t, h, w]).expand(B, 3, S)}


def run_lm_families(torch, dev, profile: bool):
    """The LM requests of the MoE, hybrid, VLM and audio families, each in
    its own launch-count windows: moe-qwen (qwen2-moe-a2.7b unmodified),
    moe-deepseek (deepseek-moe-16b at 4 layers), hybrid-jamba
    (jamba-1.5-large-398b at full width and 5 layers), audio-hubert
    (hubert-xlarge unmodified) and vlm-qwen2vl (qwen2-vl-72b at 2
    layers).  Returns the windows and the recorded K9 inputs (layer 0 of
    qwen2-moe-a2.7b's and of hubert-xlarge's prefills)."""
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import ops
    from repro_torch.serve import DecodeSession

    windows, recs = {}, {}
    for arch, label in (("qwen2-moe-a2.7b", "moe-qwen"),
                        ("deepseek-moe-16b", "moe-deepseek")):
        lm_moe_requests(torch, dev, arch, label, windows, recs, profile)

    # ---- hybrid-jamba: full width, layers 0-4; greedy_decode, prefill ---
    arch = "jamba-1.5-large-398b"
    cfg = dataclasses.replace(ARCHS[arch], n_layers=LM_DEPTH[arch])
    tol = {"f32": LM_F32_TOL, "bf16_max_abs": LM_BF16_MAX_ABS[cfg.name]}
    cut = {"n_layers": f"72 -> {cfg.n_layers}: " + LM_DEPTH_WHY[arch],
           "f32_route_check": f"depth {cfg.n_layers} -> {LM_F32_LAYERS} "
                              "(Mamba + MLP, Mamba + MoE) at full width, "
                              "drawn after the served tree is freed (48.7 "
                              "GB in f32)"}
    cp, gen = lm_served_weights(torch, dev, cfg)
    kern = lm_models(torch, cfg, torch.bfloat16)["kernel"]
    j = LM_JAMBA
    prompt = torch.randint(0, cfg.vocab, (j["batch"], j["prompt"]),
                           generator=gen, device=dev)
    toks, tm, counts, peak = lm_greedy(torch, kern, cp, prompt, j["new"],
                                       cfg.vocab)
    windows["lm_hybrid-jamba_decode"] = counts
    decode_counts = {k: v for k, v in counts.items() if v}
    # the prefill into S + 16 runs the plain attention; K10 a Mamba layer
    check_launches("hybrid-jamba greedy_decode", counts,
                   {"mamba_scan": n_kernel_layers(cfg, "mamba_scan")})
    nbytes = decode_bytes(cp, cfg, j["batch"], j["prompt"] + j["new"] / 2,
                          decode_routed_experts(torch, kern, cp, prompt,
                                                toks))
    logits, caches, secs, counts, ppeak = lm_prefill(torch, kern, cp, prompt)
    del caches
    windows["lm_hybrid-jamba_prefill"] = counts
    check_launches("hybrid-jamba full-cache prefill", counts,
                   prefill_launches(cfg, torch.bfloat16))
    route = lm_bf16_route_checks(torch, "hybrid-jamba", cfg, cp,
                                 {"tokens": prompt}, logits, noise=True)
    steps = lm_moe_step_check(torch, "hybrid-jamba", "bf16", cfg, cp, prompt)
    del kern, cp, logits
    gc.collect()
    torch.cuda.empty_cache()
    cfg32, p32 = lm_f32_cut(torch, dev, cfg, LM_F32_LAYERS)
    route.update(lm_f32_route_check(torch, "hybrid-jamba", cfg32, p32,
                                    {"tokens": prompt}))
    steps.update(lm_moe_step_check(torch, "hybrid-jamba", "f32", cfg32, p32,
                                   prompt))
    del p32
    lm_request_line("hybrid-jamba greedy_decode", {
        "model": cfg.name, "n_layers": cfg.n_layers, "B": j["batch"],
        "prompt": j["prompt"], "new_tokens": j["new"],
        "call": "greedy_decode", **tm,
        "prompt_tokens_per_s": prompt.numel() / tm["prefill_s"],
        "decode_tokens_per_s": j["batch"] * (j["new"] - 1) / tm["decode_s"],
        **nbytes, **decode_bound(nbytes, j["batch"]),
        "launches": decode_counts, "max_memory_allocated": peak, **steps,
        "tol": tol, "tokens_row0": toks[0].tolist(), "reduced": cut})
    lm_request_line("hybrid-jamba prefill", prefill_line(
        cfg, {"tokens": prompt}, secs, counts, ppeak, route, tol,
        "LM.prefill(params, {tokens}), full cache, the same prompts", cut))
    del prompt, toks
    gc.collect()
    torch.cuda.empty_cache()

    # ---- audio-hubert: unmodified, 2 x 8192 frames, non-causal ---------
    cfg, params, cp, gen = lm_weights(torch, dev, ARCHS["hubert-xlarge"])
    tol = {"f32": LM_F32_TOL, "bf16_max_abs": LM_BF16_MAX_ABS[cfg.name]}
    kern = lm_models(torch, cfg, torch.bfloat16)["kernel"]
    a = LM_AUDIO
    batch = {"frames": torch.randn(a["batch"], a["frames"], cfg.d_model,
                                   generator=gen, device=dev)}
    rec = Recorder(ops, "flash_attention_cuda", keep=1)
    logits, caches, secs, counts, peak = lm_prefill(torch, kern, cp, batch)
    rec.restore()
    recs["audio-hubert"] = rec.calls[0]
    del rec, caches
    windows["lm_audio-hubert"] = counts
    check_launches("audio-hubert prefill", counts,
                   prefill_launches(cfg, torch.bfloat16))
    check(logits.shape == (a["batch"], cfg.vocab), "hubert logits")
    route = lm_route_checks(torch, "audio-hubert", cfg, params, cp, batch,
                            logits, noise=True)
    try:
        kern.decode_step(cp, [], torch.zeros(1, 1, dtype=torch.long,
                                             device=dev), 0)
        no_decode = False
    except ValueError:
        no_decode = True
    check(no_decode, "hubert-xlarge: decode_step did not refuse an "
          "encoder-only model")
    lm_request_line("audio-hubert prefill", prefill_line(
        cfg, batch, secs, counts, peak, route, tol,
        "LM.prefill(params, {frames}), full cache, non-causal",
        {"batch": "2 sequences", "frames": "8192 a sequence (the repo's "
         "prefill_32k cut as for the text models)"}))
    if profile:
        profile_call(torch, lambda: kern.prefill(cp, batch),
                     "hubert-xlarge prefill")
    del kern, params, cp, batch, logits
    gc.collect()
    torch.cuda.empty_cache()

    # ---- vlm-qwen2vl: 2 layers, vision prefix, M-RoPE ------------------
    v = LM_VLM
    cfg = dataclasses.replace(ARCHS["qwen2-vl-72b"],
                              n_layers=LM_DEPTH["qwen2-vl-72b"])
    cut = {"n_layers": f"80 -> {cfg.n_layers}: "
                       + LM_DEPTH_WHY["qwen2-vl-72b"],
           "batch": "prefill_32k's 32 -> 2", "prompt": "32768 -> 8192"}
    cfg, params, cp, gen = lm_weights(torch, dev, cfg)
    tol = {"f32": LM_F32_TOL, "bf16_max_abs": LM_BF16_MAX_ABS[cfg.name]}
    kern = lm_models(torch, cfg, torch.bfloat16)["kernel"]
    batch = vlm_batch(torch, gen, cfg, dev, v["batch"], v["prompt"],
                      v["patches"], v["grid"])
    logits, caches, secs, counts, peak = lm_prefill(torch, kern, cp, batch)
    del caches
    windows["lm_vlm-qwen2vl_prefill"] = counts
    check_launches("vlm-qwen2vl prefill", counts,
                   prefill_launches(cfg, torch.bfloat16))
    route = lm_route_checks(torch, "vlm-qwen2vl", cfg, params, cp, batch,
                            logits, noise=True)
    lm_request_line("vlm-qwen2vl prefill", prefill_line(
        cfg, batch, secs, counts, peak, route, tol,
        "LM.prefill(params, {tokens, vision_embeds, positions}), full "
        "cache", cut))
    # 32 DecodeSession steps from a prefill into S + 32 (no K9: not a
    # full cache), each at M-RoPE positions (B, 3, 1) = the cache index
    from repro_torch.kernels import _build

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_counts()
    t0 = time.perf_counter()
    sess = DecodeSession(kern, cp, max_len=v["prompt"] + v["steps"])
    out = sess.prefill(batch)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    toks = []
    for _ in range(v["steps"]):
        toks.append(torch.argmax(out, -1)[:, None])
        out = sess.step(toks[-1])
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = _build.counts()
    windows["lm_vlm-qwen2vl_decode"] = counts
    check_launches("vlm-qwen2vl DecodeSession", counts, {})
    check(torch.isfinite(out).all().item(), "vlm-qwen2vl: non-finite step")
    toks = torch.cat(toks, dim=1)
    check(bool(((toks >= 0) & (toks < cfg.vocab)).all()),
          "vlm-qwen2vl: a token outside [0, vocab)")
    peak = torch.cuda.max_memory_allocated()
    del sess, out
    steps = lm_step_checks(torch, "vlm-qwen2vl", cfg, params, cp, batch,
                           "flash_attention", 0, "flash_attention_f32")
    lm_request_line("vlm-qwen2vl DecodeSession", {
        "model": cfg.name, "n_layers": cfg.n_layers, "B": v["batch"],
        "prompt": v["prompt"], "new_tokens": v["steps"],
        "call": f"DecodeSession(max_len=S + {v['steps']}).prefill, then "
                f"{v['steps']} steps",
        "prefill_s": t1 - t0, "decode_s": t2 - t1,
        "prompt_tokens_per_s": v["batch"] * v["prompt"] / (t1 - t0),
        "decode_tokens_per_s": v["batch"] * v["steps"] / (t2 - t1),
        "launches": {}, "max_memory_allocated": peak, **steps, "tol": tol,
        "tokens_row0": toks[0].tolist(), "reduced": cut})
    del kern, params, cp, batch, logits, toks
    gc.collect()
    torch.cuda.empty_cache()
    return windows, recs


def train_flop_per_token(cfg, seq: int) -> float:
    """Model FLOPs a token of one forward and backward, without remat's
    recompute: 3 x (2 per weight the token's products read --
    ``cfg.n_active_params()`` (a MoE layer's routed top-k experts, not all
    of them), less the input embedding of an untied model -- and 4 D Hq
    per unmasked (query, key) pair of each attention layer, the mean over
    a sequence of ``seq`` under its causal and window masks)."""
    mats = cfg.n_active_params() - (0 if cfg.tie_embeddings
                                    else cfg.vocab * cfg.d_model)
    pairs = sum(attn_pairs(seq, seq, cfg.causal, cfg.layer_spec(i).window)
                for i in range(cfg.n_layers)
                if cfg.layer_spec(i).mixer == "attn")
    return 3.0 * (2.0 * mats + 4.0 * cfg.head_dim * cfg.n_heads * pairs
                  / seq)


def train_route_check(torch, label, cfg, dtype, params, batch, kname,
                      n_layers):
    """Step 1's loss and gradients on the kernel route against the plain
    route on the same parameters and batch; the kernel route launches
    ``kname`` twice a layer (the forward and remat's recompute).  Returns
    the readings and the kernel route's counts."""
    from repro_torch.kernels import _build
    from repro_torch.models import LM
    from repro_torch.train.trainer import value_and_grad
    from repro_torch.tree import named_leaves, tree_leaves

    kw = dict(compute_dtype=dtype)
    plain = LM(cfg, **kw)
    kern = LM(cfg, attn_impl="kernel", ssm_impl="kernel", **kw)
    _build.reset_counts()
    (lp, _), gp = value_and_grad(plain, params, batch)
    check(sum(_build.counts().values()) == 0,
          f"{label}: the plain route launched {_build.counts()}")
    gp = tree_leaves(gp)
    _build.reset_counts()
    (lk, _), gk = value_and_grad(kern, params, batch)
    torch.cuda.synchronize()
    counts = _build.counts()
    check(counts[kname] == 2 * n_layers, f"{label}: route check launched "
          f"{kname} {counts[kname]} times, expected {2 * n_layers}")
    gk = tree_leaves(gk)
    rel = {}
    for (name, _), a, b in zip(named_leaves(params), gk, gp):
        check(bool(torch.isfinite(a).all()), f"{label}: non-finite grads")
        rel[name] = (
            torch.linalg.vector_norm(a - b)
            / torch.linalg.vector_norm(b).clamp(min=1e-30)).item()
    nk = torch.sqrt(sum(torch.sum(g * g) for g in gk)).item()
    np_ = torch.sqrt(sum(torch.sum(g * g) for g in gp)).item()
    out = {"loss_kernel": lk.item(), "loss_plain": lp.item(),
           "loss_rel_err": abs(lk.item() - lp.item()) / abs(lp.item()),
           "grad_norm_kernel": nk, "grad_norm_plain": np_,
           "grad_norm_rel_err": abs(nk - np_) / np_,
           "leaf_rel_l2_max": max(rel.values()),
           "leaf_rel_l2": rel}
    check(math.isfinite(out["loss_kernel"])
          and math.isfinite(out["loss_plain"]),
          f"{label}: a non-finite step-1 loss")
    if n_moe_layers(cfg):
        # the routing's gathers have accumulating (index_put_) backwards,
        # whose sums need not repeat bit for bit from run to run: how far
        # the kernel route drifts from itself, held to the route check's
        # tolerance
        del gp
        (lk2, _), gk2 = value_and_grad(kern, params, batch)
        gk2 = tree_leaves(gk2)
        nk2 = torch.sqrt(sum(torch.sum(g * g) for g in gk2)).item()
        out.update(
            drift_loss_rel=abs(lk2.item() - lk.item()) / abs(lk.item()),
            drift_grad_norm_rel=abs(nk2 - nk) / nk,
            drift_leaf_rel_l2_max=max(
                (torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b).clamp(min=1e-30)).item()
                for a, b in zip(gk2, gk)),
            drift_bit_equal=all(torch.equal(a, b) for a, b in zip(gk2, gk)))
        del gk2
        check(out["drift_loss_rel"] <= TRAIN_BF16_TOL["loss_rtol"]
              and out["drift_grad_norm_rel"]
              <= TRAIN_BF16_TOL["grad_norm_rtol"],
              f"{label}: two runs of the kernel route drift beyond "
              f"{TRAIN_BF16_TOL}: {out['drift_loss_rel']}, "
              f"{out['drift_grad_norm_rel']}")
    if dtype == torch.float32:
        check(out["leaf_rel_l2_max"] <= TRAIN_F32_LEAF_REL_L2,
              f"{label}: a leaf's gradient rel. L2 error "
              f"{out['leaf_rel_l2_max']} > {TRAIN_F32_LEAF_REL_L2}")
    else:
        check(out["loss_rel_err"] <= TRAIN_BF16_TOL["loss_rtol"],
              f"{label}: step-1 loss kernel {lk.item()} vs plain "
              f"{lp.item()} beyond rtol {TRAIN_BF16_TOL['loss_rtol']}")
        check(out["grad_norm_rel_err"] <= TRAIN_BF16_TOL["grad_norm_rtol"],
              f"{label}: gradient norm kernel {nk} vs plain {np_} beyond "
              f"rtol {TRAIN_BF16_TOL['grad_norm_rtol']}")
    return out, counts


def train_step_split(torch, model, state, batch, opt, label: str) -> None:
    """``--profile``: one more warm step in its two halves, each
    synchronised -- the loss and gradients, then the optimizer (the
    global-norm clip and AdamW's passes); prints a ``train split`` line."""
    from repro_torch.train import opt_update
    from repro_torch.train.trainer import reference_view, value_and_grad

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, grads = value_and_grad(model, state.params, batch)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    opt_update(reference_view(model.cfg, state.params),
               reference_view(model.cfg, grads), state.opt, opt, state.step)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    print(f"train split ({label}): " + json.dumps(
        {"value_and_grad_s": t1 - t0, "opt_update_s": t2 - t1}))


def run_train_path(torch, dev, profile: bool, readings: dict | None = None,
                   labels: tuple | None = None,
                   sizing: dict | None = None):
    """The train path: each case of ``TRAIN_CASES`` (of ``labels``, when
    given) from seeded weights on the card -- the step-1 route check
    (``train_route_check``, on parameters drawn before the optimizer
    state, then freed: the state is drawn again from the same seed), then
    its AdamW steps, each synchronised, in the train launch-count window,
    where K9 (train-gemma, train-moe) or K10 (train-falcon) must launch
    exactly twice a layer a step and nothing else may launch.  A ``sized``
    case takes its depth and batch from the dry-run (``sizing``, from
    ``start_sizing``), and its predicted peak and state bytes are held
    against the card's.  Prints one
    ``train path:`` line a case (and a ``shapes:`` line a sized case);
    returns the window's counts and each stepped case's warm step seconds,
    and fills ``readings`` with each stepped case's state bytes, peak and
    what was resident before its state."""
    from repro_torch.tree import tensors
    from repro_torch.configs import ARCHS
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels import _build
    from repro_torch.models import LM
    from repro_torch.train import OptConfig, init_state, make_train_step
    from repro_torch.tree import tree_leaves

    window = dict.fromkeys(_build.counts(), 0)
    warm_by_case = {}
    for case in TRAIN_CASES:
        if labels is not None and case["label"] not in labels:
            continue
        cfg = ARCHS[case["arch"]]
        if case["n_layers"]:
            cfg = dataclasses.replace(cfg, n_layers=case["n_layers"])
        batch_size = case["batch"]
        sized = None
        if case.get("sized"):
            (sized,) = sizing_result(torch, sizing, case["label"]).values()
            if not sized["fits"]:
                continue
            cfg, batch_size = sized["cfg"], sized["shape"].global_batch
        dtype = getattr(torch, case["dtype"])
        kname = ("mamba_scan" if cfg.family == "ssm" else
                 "flash_attention" if dtype == torch.bfloat16 else
                 "flash_attention_f32")
        nl = cfg.n_layers
        opt = OptConfig(**TRAIN_OPT)
        model = LM(cfg, compute_dtype=dtype, attn_impl="kernel",
                   ssm_impl="kernel")
        resident = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        params = model.init(torch.Generator(device=dev).manual_seed(LM_SEED),
                            device=dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        pipe = TokenPipeline(cfg.vocab, batch_size, case["seq"], seed=0)
        batches = [pipe.next_batch() for _ in range(max(case["steps"], 1))]
        line = {"model": cfg.name, "n_layers": nl, "compute": case["dtype"],
                "B": batch_size, "S": case["seq"],
                "params": sum(t.numel() for t in tree_leaves(params)),
                "init_s": init_s}
        route, rcounts = train_route_check(
            torch, case["label"], cfg, dtype, params, batches[0], kname, nl)
        if not case["steps"]:
            # train-gemma-f32: its one step's gradients are the window's
            for k, v in rcounts.items():
                window[k] += v
            line.update(route=route, launches={k: v for k, v in
                                               rcounts.items() if v})
            print(f"train path {case['label']}: " + json.dumps(line))
            del params
            gc.collect()
            torch.cuda.empty_cache()
            continue
        del params
        gc.collect()
        torch.cuda.empty_cache()
        state = init_state(model, torch.Generator(device=dev).manual_seed(
            LM_SEED), opt)
        step = make_train_step(model, opt)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_counts()
        losses, walls = [], []
        for b in batches:
            t0 = time.perf_counter()
            state, m = step(state, b)
            loss = m["loss"].item()
            walls.append(time.perf_counter() - t0)
            losses.append(loss)
        counts = _build.counts()
        peak = torch.cuda.max_memory_allocated()
        want = {k: 0 for k in counts}
        want[kname] = 2 * nl * case["steps"]
        check(counts == want, f"{case['label']}: launches "
              f"{ {k: v for k, v in counts.items() if v} }, expected "
              f"{kname} = 2 x {nl} layers x {case['steps']} steps only")
        check(all(map(math.isfinite, losses)),
              f"{case['label']}: a non-finite loss {losses}")
        for k, v in counts.items():
            window[k] += v
        warm = statistics.mean(walls[1:])
        warm_by_case[case["label"]] = warm
        state_bytes = sum(t.nbytes for t in tensors((state.params,
                                                     state.opt)))
        if readings is not None:
            readings[case["label"]] = {
                "peak": peak, "resident": resident, "warm_step_s": warm,
                "state_bytes": state_bytes}
        tokens = batch_size * case["seq"]
        line.update(
            losses=losses, step_walls_s=walls, warm_step_s=warm,
            tokens_per_s=tokens / warm, max_memory_allocated=peak,
            launches={k: v for k, v in counts.items() if v}, route=route,
            opt=TRAIN_OPT)
        if cfg.family != "ssm":
            flop = train_flop_per_token(cfg, case["seq"]) * tokens
            line.update(model_flop_per_step=flop,
                        mfu_bf16=flop / warm / PEAK_BF16,
                        bound_s=flop / PEAK_BF16,
                        bound_with_remat_s=flop * 4 / 3 / PEAK_BF16)
        print(f"train path {case['label']}: " + json.dumps(line))
        if sized is not None:
            check(state_bytes == sized["predicted_state_bytes"],
                  f"{case['label']}: state {state_bytes} B, predicted "
                  f"{sized['predicted_state_bytes']}")
            shapes_line(f"{cfg.name} {case['sized']} ({case['label']})",
                        sized, card_line(), warm_step_s=warm,
                        tokens_per_s=tokens / warm,
                        mfu_bf16=line.get("mfu_bf16"),
                        max_memory_allocated=peak, resident=resident,
                        state_bytes=state_bytes,
                        predicted_state_bytes=sized["predicted_state_bytes"],
                        **shapes_gate(case["label"], sized["predicted_peak"],
                                      peak - resident),
                        launches=line["launches"], losses=losses)
        if profile:
            profile_call(torch, lambda: step(state, batches[-1])[1][
                "loss"].item(), f"{case['label']} train step", top=30)
            train_step_split(torch, model, state, batches[-1], opt,
                             case["label"])
        del state, step, model
        gc.collect()
        torch.cuda.empty_cache()
    return window, warm_by_case


# ---------------------------------------------------------------------------
# 8a1. the dryrun phase
# ---------------------------------------------------------------------------

# The dry-run (launch.dryrun) predicts, on the host and on the meta device,
# what a step holds on each rank; here its functions run for three
# requests the card has just served, over a one-rank fake world, and are
# held against the card.  State and cache bytes must be equal exactly; the
# predicted peak must not under-report the card's (the dry-run proves
# fit), read as max_memory_allocated less what was resident on the card
# before the request's weights were drawn; for the decode case the card's
# reading is the peak of one step after the prefill (lm_greedy), the work
# the dry-run's decode cell traces.
DRYRUN_PEAK_MIN = 0.95
DRYRUN_LIMIT_S = 60.0


def run_dryrun_phase(torch, readings: dict) -> None:
    """The ``dryrun`` phase: ``launch.dryrun``'s memory dict for
    train-gemma (gemma2-2b full width, bf16, remat, AdamW, the plain
    routes, as K9's autograd Function recomputes its backward through
    them), the gemma2-2b 2 x 8192 scoring prefill (traced with the
    ``"bypass"`` attention stand-in where the card runs K9, which keeps no
    scores) and the gemma2-2b decode request's step (4 x (1024 + 32)
    caches), each on a (1, 1) mesh; then train-gemma's roofline
    (``cost_analysis.roofline``) beside its measured warm step.  One
    ``dryrun:`` line a case."""
    from repro_torch.configs import ARCHS
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed.sharding import AxisRules
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh

    t0 = time.perf_counter()
    card = card_line()
    cfg = ARCHS["gemma2-2b"]
    tcase = TRAIN_CASES[0]
    cases = {
        "train-gemma": (ShapeConfig("train-gemma", tcase["seq"],
                                    tcase["batch"], "train"), {}),
        "gemma-score": (ShapeConfig("gemma-score", LM_SCORE["prompt"],
                                    LM_SCORE["batch"], "prefill"),
                        {"attn_bypass": True}),
        "gemma-decode": (ShapeConfig(
            "gemma-decode", LM_GEMMA["prompt"] + LM_GEMMA["new"],
            LM_GEMMA["batch"], "decode"), {}),
    }
    lines = {}
    with dryrun.fake_world(1):
        mesh = make_host_mesh((1, 1), ("data", "model"), device_type="meta")
        rules = AxisRules.for_mesh(mesh)
        for label, (shape, kw) in cases.items():
            got = readings[label]
            mem = dryrun.peak_memory(cfg, shape, mesh, rules, **kw)
            cell = dryrun.build_cell(cfg, shape, mesh, rules, **kw)
            card_peak = got["peak"] - got["resident"]
            line = {"card": card, "case": label, "shape": [
                shape.global_batch, shape.seq_len, shape.kind],
                "predicted": {k: mem[k] for k in (
                    "argument_size_in_bytes", "output_size_in_bytes",
                    "temp_size_in_bytes", "peak_bytes")},
                "trace_s": mem["trace_s"], "depth": mem["depth"],
                "card_max_memory_allocated": got["peak"],
                "card_reading": ("one decode step after the prefill"
                                 if shape.kind == "decode" else
                                 "the whole request"),
                "card_resident_before": got["resident"],
                "card_request_peak": card_peak,
                "peak_ratio": mem["peak_bytes"] / card_peak}
            if shape.kind == "train":
                state = cell.args[0]
                pred = dryrun.local_bytes((state.params, state.opt))
                line.update(predicted_state_bytes=pred,
                            card_state_bytes=got["state_bytes"])
                check(pred == got["state_bytes"], f"dryrun {label}: "
                      f"predicted state {pred} B, the card's {got['state_bytes']}")
                rf, _ = dryrun.cell_roofline(cfg, shape, mesh, rules, 1)
                warm = got["warm_step_s"]
                line.update(roofline=rf, warm_step_s=warm,
                            measured_roofline_fraction=(
                                rf["speed_of_light_s"] / warm))
            else:
                caches = (cell.args[1] if shape.kind == "decode" else
                          cell.run()[1])
                pred = dryrun.local_bytes(caches)
                line.update(predicted_cache_bytes=pred,
                            card_cache_bytes=got["cache_bytes"])
                check(pred == got["cache_bytes"], f"dryrun {label}: "
                      f"predicted caches {pred} B, the card's "
                      f"{got['cache_bytes']}")
            check(mem["peak_bytes"] >= DRYRUN_PEAK_MIN * card_peak,
                  f"dryrun {label}: predicted peak {mem['peak_bytes']} "
                  f"B under-reports the card's {card_peak} B")
            lines[label] = line
    secs = time.perf_counter() - t0
    for line in lines.values():
        line["phase_s"] = secs
        print("dryrun: " + json.dumps(line))
    check(secs <= DRYRUN_LIMIT_S, f"dryrun phase took {secs:.1f} s, over "
          f"its {DRYRUN_LIMIT_S} s")


# ---------------------------------------------------------------------------
# 8a1b. the shapes phase
# ---------------------------------------------------------------------------

# The repo's shapes (configs/base.py SHAPES) at their own sequence lengths
# on one card, each sized by the dry-run before it runs: the largest batch
# (at most the shape's own) whose predicted peak, plus what is resident on
# the card, stays within SHAPES_MEM_SHARE of the card's memory
# (torch.cuda.mem_get_info's total).  The dry-run read the card's peaks
# 0.973-0.996 of what they were (PERF.md); the rest of the share leaves
# room for that, the CUDA context and the allocator's rounding.  Widths are
# never cut; the sequence only where long_500k's prefill does not fit at
# batch 1 (the largest power of two that does); the depth only for
# train-moe (TRAIN_CASES).  The served weights are drawn on the card from
# LM_SEED in bf16 at rest (LM.init(dtype=...)): every cell is bounded by
# its batch, and an f32 copy (gemma2-2b 10.5 GB, falcon-mamba-7b 29.2 GB)
# would take its room.
SHAPES_MEM_SHARE = 0.9
SHAPES_LIMIT_S = 150.0
# DecodeSession steps of a decode cell (the dry-run's decode cell is one
# step against caches of the shape's length)
SHAPES_DECODE_STEPS = 4
# channels of K10's plain checks: the last ones, whose offsets t C + c
# reach 2^32 - 1 at S = 524288, C = 8192
SHAPES_K10_SLICE = 64
# label: (arch, shape, the dry-run's stand-ins where the card runs a kernel)
SHAPE_CELLS = {
    "gemma2-2b prefill_32k": ("gemma2-2b", "prefill_32k",
                              {"attn_bypass": True}),
    "gemma2-2b decode_32k": ("gemma2-2b", "decode_32k", {}),
    "falcon-mamba-7b prefill_32k": ("falcon-mamba-7b", "prefill_32k",
                                    {"ssm_bypass": True}),
    "falcon-mamba-7b decode_32k": ("falcon-mamba-7b", "decode_32k", {}),
    "falcon-mamba-7b long_500k": ("falcon-mamba-7b", "long_500k",
                                  {"ssm_bypass": True}),
}
# decode cells the card reaches by a prefill of the shape's length (sized
# as that prefill; the dry-run's cell, one step after it, is the
# "<label> decode" cell at the prefill's batch)
SHAPES_PREFILLED = ("falcon-mamba-7b long_500k",)


def shapes_budget(torch) -> dict:
    """The sizing budget now: ``SHAPES_MEM_SHARE`` of the card's memory
    less what is allocated on it."""
    total = torch.cuda.mem_get_info()[1]
    resident = torch.cuda.memory_allocated()
    return {"card_total": total, "resident": resident,
            "share": SHAPES_MEM_SHARE,
            "budget": SHAPES_MEM_SHARE * total - resident}


def sizing_line(label: str, sz: dict, budget: dict) -> None:
    line = {"cell": label, "arch": sz["cfg"].name, "fits": sz["fits"],
            "B": sz["shape"].global_batch if sz["fits"] else 0,
            "S": sz["shape"].seq_len, "n_layers": sz["cfg"].n_layers,
            "cut": sz["cut"], "predicted_peak": sz["predicted_peak"],
            **budget, "traces": sz["traces"], "sizing_s": sz["sizing_s"],
            # the peaks are allocated bytes; a batch sized here fits only
            # under the allocator this run has (see ``main``)
            "alloc_conf": os.environ.get("PYTORCH_CUDA_ALLOC_CONF")}
    for key in ("predicted_cache_bytes", "predicted_state_bytes"):
        if key in sz:
            line[key] = sz[key]
    print("shapes sizing: " + json.dumps(line))
    if not sz["fits"]:
        print(f"shapes: {label} does not fit one card at batch 1: predicted "
              f"peak {sz['predicted_peak']} B > budget {budget['budget']} B; "
              "skipped")


def size_task(label: str, budget: float) -> dict:
    """One sizing task, in a worker process of ``start_sizing`` (host only:
    its own one-rank fake world and (1, 1) meta mesh).  ``label`` is a
    sized train case (``dryrun.fit_cell(vary="depth")`` on the plain
    routes, as K9's autograd Function recomputes its backward through
    them, with the predicted state bytes at the pick) or a cell of
    ``SHAPE_CELLS`` (``dryrun.fit_cell`` with the served tree in bf16; a
    decode cell with its predicted cache bytes).  A cell of
    ``SHAPES_PREFILLED`` is sized as the prefill the card runs to reach it
    (``vary="seq"``), and its own cell (one step against caches of its
    length) predicted at the prefill's batch.  Returns
    ``{label: fit_cell's dict}`` for each cell it sized."""
    import torch

    from repro_torch.configs import ARCHS
    from repro_torch.configs.base import SHAPES, ShapeConfig
    from repro_torch.distributed.sharding import AxisRules
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh

    torch.set_num_threads(1)
    out = {}
    with dryrun.fake_world(1):
        mesh = make_host_mesh((1, 1), ("data", "model"), device_type="meta")
        rules = AxisRules.for_mesh(mesh)
        case = {c["label"]: c for c in TRAIN_CASES}.get(label)
        if case is not None:
            cfg, shape = ARCHS[case["arch"]], SHAPES[case["sized"]]
            check(dryrun.opt_config_for(cfg).name == "adamw",
                  f"{label}: the dry-run picks "
                  f"{dryrun.opt_config_for(cfg).name}, the train path runs "
                  "AdamW")
            check(shape.seq_len == case["seq"], f"{label}: S {case['seq']} "
                  f"is not {case['sized']}'s {shape.seq_len}")
            sz = dryrun.fit_cell(cfg, shape, budget, mesh, rules,
                                 vary="depth")
            if sz["fits"]:
                state = dryrun.build_cell(sz["cfg"], sz["shape"], mesh,
                                          rules).args[0]
                sz["predicted_state_bytes"] = dryrun.local_bytes(
                    (state.params, state.opt))
            return {f"{cfg.name} {case['sized']} ({label})": sz}
        arch, sname, stand_in = SHAPE_CELLS[label]
        cfg, shape = ARCHS[arch], SHAPES[sname]
        kw = {"params_dtype": torch.bfloat16}

        def cache_bytes(shape) -> int:
            return dryrun.local_bytes(dryrun.build_cell(
                cfg, shape, mesh, rules, **kw).args[1])

        if label not in SHAPES_PREFILLED:
            sz = dryrun.fit_cell(cfg, shape, budget, mesh, rules,
                                 **stand_in, **kw)
            if sz["fits"] and shape.kind == "decode":
                sz["predicted_cache_bytes"] = cache_bytes(sz["shape"])
            return {label: sz}
        sz = dryrun.fit_cell(cfg, ShapeConfig(sname, shape.seq_len,
                                              shape.global_batch, "prefill"),
                             budget, mesh, rules, vary="seq", **stand_in,
                             **kw)
        out[label] = sz
        dshape = dataclasses.replace(shape,
                                     global_batch=sz["shape"].global_batch)
        t0 = time.perf_counter()
        mem = dryrun.peak_memory(cfg, dshape, mesh, rules, **kw)
        out[f"{label} decode"] = {
            "fits": sz["fits"], "cfg": cfg, "shape": dshape,
            "predicted_peak": mem["peak_bytes"],
            "cut": {"B": f"{shape.global_batch} -> {dshape.global_batch} "
                         "(the prefill's batch, which the step continues)"},
            "predicted_cache_bytes": cache_bytes(dshape),
            "traces": [{"n_layers": cfg.n_layers, "B": dshape.global_batch,
                        "S": dshape.seq_len, "peak": mem["peak_bytes"]}],
            "sizing_s": time.perf_counter() - t0}
    return out


# the sized train cases, then the shapes phase's cells: one worker each
SIZING_TASKS = tuple(c["label"] for c in TRAIN_CASES if c.get("sized")) \
    + tuple(SHAPE_CELLS)
SIZING_WAIT_S = 600.0


def start_sizing(torch) -> dict:
    """Start ``size_task`` for every one of ``SIZING_TASKS`` in a pool of
    spawned processes (host work on the meta device, run beside the card's
    phases), against the budget now: call it where what is resident is
    what the sized cells will find (the smoke calls it after the search
    paths' kernel phases, when only their stores remain)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    budget = shapes_budget(torch)
    pool = ProcessPoolExecutor(
        max_workers=len(SIZING_TASKS),
        mp_context=multiprocessing.get_context("spawn"))
    return {"pool": pool, "budget": budget, "t0": time.perf_counter(),
            "futures": {label: pool.submit(size_task, label,
                                           budget["budget"])
                        for label in SIZING_TASKS}}


def sizing_result(torch, sizing: dict, label: str) -> dict:
    """The cells ``label``'s sizing task sized, each printed as a
    ``shapes sizing:`` line; each one that fits must still fit beside
    what is resident now."""
    got = sizing["futures"][label].result(timeout=SIZING_WAIT_S)
    budget = dict(sizing["budget"],
                  resident_now=torch.cuda.memory_allocated(),
                  waited_s=time.perf_counter() - sizing["t0"])
    for name, sz in got.items():
        sizing_line(name, sz, budget)
        if sz["fits"]:
            check(sz["predicted_peak"] + budget["resident_now"]
                  <= budget["share"] * budget["card_total"],
                  f"shapes {name}: predicted peak {sz['predicted_peak']} B "
                  f"and {budget['resident_now']} B resident now exceed "
                  f"{budget['share']} of the card")
    return got


def shapes_gate(label: str, predicted: int, card: int) -> dict:
    """The dry-run's predicted peak against the card's (its
    ``max_memory_allocated`` less what was resident before the cell's
    weights): at least ``DRYRUN_PEAK_MIN`` of it."""
    check(predicted >= DRYRUN_PEAK_MIN * card, f"shapes {label}: predicted "
          f"peak {predicted} B under-reports the card's {card} B")
    return {"predicted_peak": predicted, "card_peak": card,
            "peak_ratio": predicted / card}


def shapes_line(label: str, sz: dict, card: str, **fields) -> None:
    sh = sz["shape"]
    print("shapes: " + json.dumps({
        "card": card, "cell": label, "arch": sz["cfg"].name,
        "shape": sh.name, "B": sh.global_batch, "S": sh.seq_len,
        "n_layers": sz["cfg"].n_layers, "cut": sz["cut"], **fields}))


class ScanSlice:
    """Wraps ``kernels.ops.mamba_scan_cuda``: puts CUDA events around each
    call, and keeps copies of the last ``n`` channels of its first call's
    inputs and outputs.  The channels of a selective scan are independent,
    so the plain version on that slice is the kernel's output there."""

    def __init__(self, ops_module, n: int):
        self.ops, self.n = ops_module, n
        self.orig = ops_module.mamba_scan_cuda
        self.args = self.out = None
        self.events = []
        ops_module.mamba_scan_cuda = self

    def __call__(self, delta, u, A, Bm, Cm, h0):
        import torch

        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        y, hT = self.orig(delta, u, A, Bm, Cm, h0)
        ev[1].record()
        self.events.append(ev)
        if self.args is None:
            sl = slice(delta.shape[2] - self.n, None)
            self.args = (delta[..., sl].clone(), u[..., sl].clone(),
                         A[sl].clone(), Bm.clone(), Cm.clone(),
                         h0[:, sl].clone())
            self.out = (y[..., sl].clone(), hT[:, sl].clone())
        return y, hT

    def ms(self) -> list:
        import torch

        torch.cuda.synchronize()
        return [s.elapsed_time(e) for s, e in self.events]

    def restore(self):
        self.ops.mamba_scan_cuda = self.orig


def k9_bound(q, k, causal: bool, window) -> tuple[float, str]:
    """K9's least milliseconds: 4 D operations per unmasked (query head,
    key) pair at the bf16 tensor-core peak, against q, k, v and o once."""
    B9, Sq9, Hq9, D9 = q.shape
    pairs = attn_pairs(Sq9, k.shape[1], causal, window)
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    return bound(nbytes, 4.0 * B9 * Hq9 * D9 * pairs, PEAK_BF16)


def k9_at_length(torch, calls: list, path_ms: list, B: int) -> dict:
    """K9 on the recorded inputs of one sequence of a local and a global
    layer (``calls``: a ``Recorder``'s) against its plain version (bf16
    tolerance and relative RMS), timed beside the plain version, its bound
    and, for the global layer, SDPA; ``path_ms``: the path's per-launch
    times at batch ``B``, in layer order (local first)."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    out = {}
    for i, (q, k, v, causal, window, cap) in enumerate(calls):
        kind = "local" if window else "global"
        S = q.shape[1]
        want, plain_ms = timed(lambda: ref.flash_attention_ref(
            q, k, v, causal, window, cap))
        r = k9_compare(f"flash_attention (shapes, {kind} layer, S={S})",
                       flash_attention_cuda(q, k, v, causal, window, cap),
                       want)
        del want
        # SDPA has no window argument; its masked form would take an S x S
        # mask (1 GB at S = 32768), so only the global layer has a
        # yardstick, without the cap (SDPA has none)
        library_ms = None if window else time_ms(
            lambda: F.scaled_dot_product_attention(
                *(x.transpose(1, 2) for x in (q, k, v)), is_causal=True,
                enable_gqa=True), 3, warmup=1)
        bms, by = k9_bound(q, k, causal, window)
        layer = path_ms[i::2]
        out[f"{kind}_s{S}"] = dict(
            shape=f"B=1 S={S} Hq={q.shape[2]} Hkv={k.shape[2]} "
                  f"D={q.shape[3]} {q.dtype} causal window={window} "
                  f"cap={cap}",
            max_abs_err=r["max_abs_err"], rel_rms_err=r["rel_rms_err"],
            ms=time_ms(lambda: flash_attention_cuda(q, k, v, causal, window,
                                                    cap), 5),
            plain_ms=plain_ms, bound_ms=bms, bound_by=by,
            library_ms=library_ms,
            library_call=None if window else (
                "F.scaled_dot_product_attention(is_causal=True, "
                "enable_gqa=True) at the same inputs without the cap"),
            path_B=B, path_launches=len(layer),
            path_ms_per_launch=statistics.mean(layer),
            path_ms_per_sequence=statistics.mean(layer) / B)
    return out


def shapes_gemma(torch, dev, sized: dict, window: dict, out: dict,
                 card: str, profile: bool) -> None:
    """gemma2-2b's ``prefill_32k`` (``LM.prefill`` of B x 32768 into a
    full cache: K9 in all 26 layers, 13 global, 13 local) and
    ``decode_32k`` (``DecodeSession`` steps against 32768-slot caches
    filled from the seed) at their sized batches."""
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import ops
    from repro_torch.models import LM

    pre = sized["gemma2-2b prefill_32k"]
    dec = sized["gemma2-2b decode_32k"]
    if not (pre["fits"] or dec["fits"]):
        return
    cfg = ARCHS["gemma2-2b"]
    resident = torch.cuda.memory_allocated()
    gen = torch.Generator(device=dev).manual_seed(LM_SEED)
    params = LM(cfg).init(gen, device=dev, dtype=torch.bfloat16)
    models = lm_models(torch, cfg, torch.bfloat16)
    if pre["fits"]:
        label = "gemma2-2b prefill_32k"
        B, S = pre["shape"].global_batch, pre["shape"].seq_len
        tokens = torch.randint(0, cfg.vocab, (B, S), generator=gen,
                               device=dev)
        timer = LaunchTimer(ops, "flash_attention_cuda")
        try:
            logits, caches, secs, counts, peak = lm_prefill(
                torch, models["kernel"], params, tokens)
        finally:
            timer.restore()
        layer_ms = [s.elapsed_time(e) for s, e in timer.events]
        check_launches(label, counts, {"flash_attention": cfg.n_layers})
        for k, v in counts.items():
            window[k] += v
        del caches
        gate = shapes_gate(label, pre["predicted_peak"], peak - resident)
        # the route check and K9's inputs on the first sequence
        rec = Recorder(ops, "flash_attention_cuda", keep=2)
        try:
            one_k = models["kernel"].prefill(params,
                                             {"tokens": tokens[:1]})[0]
        finally:
            rec.restore()
        one_p = models["plain"].prefill(params, {"tokens": tokens[:1]})[0]
        route_err = max_abs(one_k, one_p)
        bf16_check(f"{label} kernel vs plain route (B = 1)", cfg, route_err)
        k9 = k9_at_length(torch, rec.calls, layer_ms, B)
        del rec, one_p
        out.setdefault("flash_attention", {}).update(k9)
        shapes_line(label, pre, card, wall_s=secs,
                    prompt_tokens_per_s=B * S / secs,
                    max_memory_allocated=peak, resident=resident, **gate,
                    launches={k: v for k, v in counts.items() if v},
                    route_b1_max_abs=route_err,
                    batch_row0_vs_b1_max_abs=max_abs(logits[:1], one_k),
                    tol={"bf16_max_abs": LM_BF16_MAX_ABS[cfg.name]},
                    k9={k: {"ms": r["ms"], "bound_ms": r["bound_ms"],
                            "path_ms_per_sequence":
                                r["path_ms_per_sequence"]}
                        for k, r in k9.items()})
        del logits, one_k
        if profile:
            profile_call(torch, lambda: models["kernel"].prefill(
                params, {"tokens": tokens}), f"shapes {label}", top=20)
        del tokens
    if dec["fits"]:
        shapes_decode(torch, dev, "gemma2-2b decode_32k", dec,
                      models["kernel"], params, gen, resident, card)
    del params, models
    gc.collect()
    torch.cuda.empty_cache()


def shapes_decode(torch, dev, label: str, dsz: dict, model, params, gen,
                  resident: int, card: str) -> None:
    """A decode cell at its sized batch: ``SHAPES_DECODE_STEPS``
    ``DecodeSession.step``s against caches of the shape's length drawn
    from the seed (normal; a prefill into them would run the plain
    attention, whose chunked scores would not fit beside them at this
    batch), the last steps' slots at the end of the cache.  Checks: finite
    logits, no kernel launched, the caches' bytes equal to the prediction
    and the predicted step peak against the card's (the peak is reset
    before each step, so it is the last one's)."""
    from repro_torch.kernels import _build
    from repro_torch.serve import DecodeSession

    B, S = dsz["shape"].global_batch, dsz["shape"].seq_len
    sess = DecodeSession(model, params, max_len=S)
    sess.caches = model.init_caches(B, S, dev)
    for c in sess.caches:
        for t in c.values():
            t.normal_(generator=gen)
    sess.index = S - SHAPES_DECODE_STEPS
    cache_bytes = sum(t.nbytes for c in sess.caches for t in c.values())
    check(cache_bytes == dsz["predicted_cache_bytes"],
          f"shapes {label}: caches {cache_bytes} B, predicted "
          f"{dsz['predicted_cache_bytes']}")
    tok = torch.randint(0, model.cfg.vocab, (B, 1), generator=gen,
                        device=dev)
    walls = []
    _build.reset_counts()
    for _ in range(SHAPES_DECODE_STEPS):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        logits = sess.step(tok)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        check(torch.isfinite(logits).all().item(),
              f"shapes {label}: non-finite step logits")
        tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    peak = torch.cuda.max_memory_allocated()
    check_launches(label, _build.counts(), {})
    gate = shapes_gate(label, dsz["predicted_peak"], peak - resident)
    del sess, logits, tok
    shapes_line(label, dsz, card, step_walls_s=walls,
                decode_tokens_per_s=B / statistics.mean(walls[1:]),
                cache_bytes=cache_bytes,
                predicted_cache_bytes=dsz["predicted_cache_bytes"],
                step_max_memory_allocated=peak, resident=resident, **gate,
                caches="drawn from the seed (normal), the last "
                f"{SHAPES_DECODE_STEPS} slots written by the steps")


def falcon_steps(torch, model, params, caches, logits, index: int,
                 n: int) -> tuple[list, int]:
    """``n`` decode steps after a prefill (argmax tokens), each timed and
    its logits checked; the peak is reset before each, so the returned
    peak is the last step's.  Returns (walls, peak)."""
    from repro_torch.kernels import _build

    tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    walls = []
    _build.reset_counts()
    for i in range(n):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        step, caches = model.decode_step(params, caches, tok, index + i)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        check(torch.isfinite(step).all().item(),
              "shapes: non-finite decode-step logits")
        tok = torch.argmax(step, -1)[:, None].to(torch.int32)
    check_launches("shapes decode steps", _build.counts(), {})
    return walls, torch.cuda.max_memory_allocated()


def shapes_falcon(torch, dev, sized: dict, window: dict, out: dict,
                  card: str) -> None:
    """falcon-mamba-7b's ``prefill_32k`` (K10 in all 64 layers, then one
    decode step to show the prefill's state continues), ``decode_32k``
    (``shapes_decode``: the step holds only the SSM state, drawn from the
    seed at its sized batch) and ``long_500k``: a prefill at the sized
    length and decode steps, then K10 alone at the shape's own
    (1, 524288, 8192, 16)."""
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels.mamba_scan import mamba_scan_cuda
    from repro_torch.models import LM

    cfg = ARCHS["falcon-mamba-7b"]
    resident = torch.cuda.memory_allocated()
    gen = torch.Generator(device=dev).manual_seed(LM_SEED)
    params = LM(cfg).init(gen, device=dev, dtype=torch.bfloat16)
    models = lm_models(torch, cfg, torch.bfloat16)
    for label in ("falcon-mamba-7b prefill_32k", "falcon-mamba-7b long_500k"):
        sz = sized[label]
        if not sz["fits"]:
            continue
        B, S = sz["shape"].global_batch, sz["shape"].seq_len
        tokens = torch.randint(0, cfg.vocab, (B, S), generator=gen,
                               device=dev)
        k10 = ScanSlice(ops, SHAPES_K10_SLICE)
        try:
            logits, caches, secs, counts, peak = lm_prefill(
                torch, models["kernel"], params, tokens)
        finally:
            k10.restore()
        check_launches(label, counts, {"mamba_scan": cfg.n_layers})
        for k, v in counts.items():
            window[k] += v
        gate = shapes_gate(label, sz["predicted_peak"], peak - resident)
        launch_ms = k10.ms()
        fields = dict(wall_s=secs, prompt_tokens_per_s=B * S / secs,
                      max_memory_allocated=peak, resident=resident, **gate,
                      launches={k: v for k, v in counts.items() if v},
                      k10_path_ms_per_launch=statistics.mean(launch_ms))
        if label in SHAPES_PREFILLED:
            # the shape's own cell: decode steps after the prefill
            dlabel = f"{label} decode"
            dsz = sized[dlabel]
            cache_bytes = sum(t.nbytes for c in caches for t in c.values())
            check(cache_bytes == dsz["predicted_cache_bytes"],
                  f"shapes {dlabel}: caches {cache_bytes} B, predicted "
                  f"{dsz['predicted_cache_bytes']}")
            walls, step_peak = falcon_steps(torch, models["kernel"], params,
                                            caches, logits, S,
                                            SHAPES_DECODE_STEPS)
            dgate = shapes_gate(dlabel, dsz["predicted_peak"],
                                step_peak - resident)
            dline = dict(step_walls_s=walls,
                         step_max_memory_allocated=step_peak,
                         resident=resident, cache_bytes=cache_bytes, **dgate,
                         predicted_cache_bytes=dsz["predicted_cache_bytes"])
        else:
            # continuity only: one step from the prefill's state
            walls, _ = falcon_steps(torch, models["kernel"], params, caches,
                                    logits, S, 1)
            fields["step_after_prefill_wall_s"] = walls[0]
            # the route check on a depth cut at batch 1, and K10 on
            # layer 0's channel slice, bit-equal to the plain version
            cut = dataclasses.replace(cfg, n_layers=LM_F32_LAYERS)
            pcut = dict(params, layers=params["layers"][:LM_F32_LAYERS])
            mcut = lm_models(torch, cut, torch.bfloat16)
            one = {"tokens": tokens[:1]}
            _build.reset_counts()
            got_cut = mcut["kernel"].prefill(pcut, one)[0]
            check_launches(f"{label} depth cut", _build.counts(),
                           {"mamba_scan": LM_F32_LAYERS})
            route_err = max_abs(got_cut, mcut["plain"].prefill(pcut, one)[0])
            del got_cut
            bf16_check(f"{label} kernel vs plain route ({LM_F32_LAYERS} "
                       "layers, B = 1)", cfg, route_err)
            want, plain_ms = timed(lambda: ref.mamba_scan_ref(*k10.args))
            err = compare(f"mamba_scan (shapes, {label} layer 0, last "
                          f"{SHAPES_K10_SLICE} channels)", k10.out, want,
                          exact=True)
            del want, mcut, pcut
            C, N = cfg.d_inner_, cfg.ssm_state
            bms, by = scan_bound(B, S, C, N)
            out.setdefault("mamba_scan", {})[f"s{S}"] = dict(
                shape=f"B={B} S={S} C={C} N={N} f32 (each layer of the "
                      f"{label} cell)",
                ms=statistics.mean(launch_ms), launches_a_cell=len(launch_ms),
                bound_ms=bms, bound_by=by,
                max_abs_err=err, plain_ms=plain_ms,
                plain_shape=f"B={B} S={S} C={SHAPES_K10_SLICE} (layer 0's "
                            f"last channels) N={N}",
                library_ms=None)
            fields.update(route_depth_cut_max_abs=route_err,
                          route_depth_cut_layers=LM_F32_LAYERS,
                          k10_slice_max_abs_err=err)
        del caches, logits, k10, tokens
        shapes_line(label, sz, card, **fields)
        if label in SHAPES_PREFILLED:
            shapes_line(dlabel, dsz, card, **dline)
    dec = sized["falcon-mamba-7b decode_32k"]
    if dec["fits"]:
        shapes_decode(torch, dev, "falcon-mamba-7b decode_32k", dec,
                      models["kernel"], params, gen, resident, card)
    del params, models
    gc.collect()
    torch.cuda.empty_cache()
    # K10 alone at long_500k's own length, on inputs drawn on the card
    from repro_torch.configs.base import SHAPES

    Bl, Sl = SHAPES["long_500k"].global_batch, SHAPES["long_500k"].seq_len
    C, N = cfg.d_inner_, cfg.ssm_state
    delta = torch.rand(Bl, Sl, C, generator=gen, device=dev).mul_(0.1)
    u = torch.randn(Bl, Sl, C, generator=gen, device=dev)
    A = torch.rand(C, N, generator=gen, device=dev).mul_(-3.0)
    Bm = torch.randn(Bl, Sl, N, generator=gen, device=dev)
    Cm = torch.randn(Bl, Sl, N, generator=gen, device=dev)
    h0 = torch.randn(Bl, C, N, generator=gen, device=dev)
    args = (delta, u, A, Bm, Cm, h0)
    _build.reset_counts()
    got, first_ms = timed(lambda: mamba_scan_cuda(*args))
    counts = _build.counts()
    check_launches(f"mamba_scan at S={Sl}", counts, {"mamba_scan": 1})
    for k, v in counts.items():
        window[k] += v
    sl = slice(C - SHAPES_K10_SLICE, None)
    sargs = (delta[..., sl].contiguous(), u[..., sl].contiguous(),
             A[sl].contiguous(), Bm, Cm, h0[:, sl].contiguous())
    want, plain_ms = timed(lambda: ref.mamba_scan_ref(*sargs))
    err = compare(f"mamba_scan S={Sl} (last {SHAPES_K10_SLICE} channels)",
                  (got[0][..., sl], got[1][:, sl]), want, exact=True)
    del got, want, sargs
    ms = time_ms(lambda: mamba_scan_cuda(*args), 2, warmup=0)
    del args, delta, u, A, Bm, Cm, h0
    gc.collect()
    torch.cuda.empty_cache()
    bms, by = scan_bound(Bl, Sl, C, N)
    out.setdefault("mamba_scan", {})[f"s{Sl}"] = dict(
        shape=f"B={Bl} S={Sl} C={C} N={N} f32 (long_500k's length, inputs "
              "drawn on the card)",
        ms=ms, first_call_ms=first_ms, bound_ms=bms, bound_by=by,
        max_abs_err=err, plain_ms=plain_ms,
        plain_shape=f"B={Bl} S={Sl} C={SHAPES_K10_SLICE} (the last "
                    f"channels) N={N}",
        library_ms=None)
    print("shapes: " + json.dumps({
        "card": card, "cell": "falcon-mamba-7b long_500k K10",
        **out["mamba_scan"][f"s{Sl}"]}))


def scan_bound(B: int, S: int, C: int, N: int) -> tuple[float, str]:
    """K10's least milliseconds: its inputs and outputs once (delta, u,
    B and C rows, y; A, h0, hT) against 7 FP32 operations per (b, t, c,
    n)."""
    return bound(4.0 * (B * S * (2 * C + 2 * N) + B * S * C + C * N
                        + 2 * B * C * N), 7.0 * B * S * C * N + B * S * C)


def run_shapes_phase(torch, dev, profile: bool, sizing: dict):
    """The ``shapes`` phase: each cell of ``SHAPE_CELLS`` that fits, at
    the batch (and length) its sizing task found (``sizing``, from
    ``start_sizing``; ``shapes_gemma``, ``shapes_falcon``), in one
    launch-count window.  Returns the window's counts and the K9 / K10
    readings at the shapes' lengths (the ``shapes`` key of their
    records)."""
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    card = card_line()
    sized = {}
    for label in SHAPE_CELLS:
        sized.update(sizing_result(torch, sizing, label))
    window = dict.fromkeys(_build.counts(), 0)
    out = {}
    shapes_gemma(torch, dev, sized, window, out, card, profile)
    shapes_falcon(torch, dev, sized, window, out, card)
    secs = time.perf_counter() - t0
    print("shapes phase: " + json.dumps({
        "card": card, "phase_s": secs, "limit_s": SHAPES_LIMIT_S,
        "launches": {k: v for k, v in window.items() if v}}))
    check(secs <= SHAPES_LIMIT_S, f"shapes phase took {secs:.1f} s, over "
          f"its {SHAPES_LIMIT_S} s")
    return window, out


# ---------------------------------------------------------------------------
# 8a2. the sharded LM phase
# ---------------------------------------------------------------------------

# Per-rank emulation at full width in one process: each model rank's local
# shard of a layer's K9 / K10 / MoE call, concatenated or summed as the
# collective would, against the unsharded call.  NCCL refuses two ranks on
# one card, so the collectives are emulated here; tests/test_torch_sharded_lm.py
# runs them for real over gloo.
SHARDED_K9 = (
    # label, B, S, Hq, Hkv, D, cap; tp over the heads (gemma2-2b's kv = 4
    # does not divide tp = 8: wk / wv replicated, each rank reads the kv
    # head of its q head)
    ("gemma2-2b global layer", 2, 8192, 8, 4, 256, 50.0, (2, 4, 8)),
    ("qwen2-moe-a2.7b layer", 2, 8192, 16, 16, 128, None, (2, 4, 8)),
)
SHARDED_K10 = dict(label="falcon-mamba-7b layer", B=4, S=2048, C=8192, N=16,
                   tps=(2, 4, 8, 16))
SHARDED_MOE = dict(arch="qwen2-moe-a2.7b", tokens=2 * 8192, tps=(2, 4, 8))
# the sharded LM on the one-rank (1, 1) mesh: gemma2-2b at full width,
# LM_SCORE's scoring prefill and one train step's gradients at
# SHARDED_TRAIN_LAYERS layers (bf16, remat, B = 1, S = 8192)
SHARDED_TRAIN_LAYERS = 2
# the launcher: launch.train as train-gemma runs it, then its restart check
LAUNCH_FULL = ["--arch", "gemma2-2b", "--preset", "full", "--batch", "1",
               "--seq", "8192", "--steps", "3", "--device", "cuda",
               "--log-every", "1"]
LAUNCH_RESUME = ["--arch", "gemma2-2b", "--preset", "reduced", "--batch",
                 "2", "--seq", "64", "--device", "cuda", "--log-every",
                 "100"]
LAUNCH_RESUME_RTOL = 1e-5      # tests/test_system.py:70-78


def sharded_k9(torch, dev, gen, label, B, S, Hq, Hkv, D, cap, tps) -> dict:
    """K9 on each rank's local heads against the unsharded call."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.models.attention import _kv_for_heads

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(dev, torch.bfloat16)

    q, k, v = randn(B, S, Hq, D), randn(B, S, Hkv, D), randn(B, S, Hkv, D)
    want = flash_attention_cuda(q, k, v, True, None, cap)
    out = {"shape": f"B={B} S={S} Hq={Hq} Hkv={Hkv} D={D} bf16 causal "
                    f"cap={cap}",
           "unsharded_ms": time_ms(
               lambda: flash_attention_cuda(q, k, v, True, None, cap), 5),
           "tp": {}}
    for tp in tps:
        hl = Hq // tp

        def shard(r):
            qr = q[:, :, r * hl:(r + 1) * hl].contiguous()
            if Hkv % tp == 0:
                kl = Hkv // tp
                return (qr, k[:, :, r * kl:(r + 1) * kl].contiguous(),
                        v[:, :, r * kl:(r + 1) * kl].contiguous())
            return (qr, _kv_for_heads(k, hl, Hq, Hkv, r).contiguous(),
                    _kv_for_heads(v, hl, Hq, Hkv, r).contiguous())

        got = torch.cat([flash_attention_cuda(*shard(r), True, None, cap)
                         for r in range(tp)], dim=2)
        rec = {"kv": "split" if Hkv % tp == 0 else
               "replicated (kv does not divide tp); each rank reads kv "
               "head h // (Hq / Hkv) of its q heads",
               "bit_equal": bool(torch.equal(got, want)),
               "max_abs_err": (got.float() - want.float()).abs().max().item()}
        if not rec["bit_equal"]:
            k9_compare(f"sharded K9 {label} tp={tp}", got, want)
            rec["why"] = "K9's blocks of one head read other heads' tiles"
        del got
        q0, k0, v0 = shard(0)
        pairs = attn_pairs(S, S, True, None)
        rec["bound_ms"], rec["bound_by"] = bound(
            (2 * q0.numel() + 2 * k0.numel()) * 2,
            4.0 * B * hl * D * pairs, PEAK_BF16)
        rec["ms"] = time_ms(
            lambda: flash_attention_cuda(q0, k0, v0, True, None, cap), 5)
        rec["plain_ms"] = time_ms(
            lambda: ref.flash_attention_ref(q0, k0, v0, True, None, cap), 1,
            warmup=1)
        rec["library_ms"] = time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q0.transpose(1, 2), k0.transpose(1, 2), v0.transpose(1, 2),
                is_causal=True, enable_gqa=True), 5)
        rec["library_call"] = ("F.scaled_dot_product_attention(is_causal="
                               "True, enable_gqa=True), no cap")
        rec["local_shape"] = f"Hq={hl} Hkv={k0.shape[2]}"
        out["tp"][tp] = rec
        del q0, k0, v0
    return out


def sharded_k10(torch, dev, gen, label, B, S, C, N, tps) -> dict:
    """K10 on each rank's channel slice against the unsharded call."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.mamba_scan import mamba_scan_cuda

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(dev)

    args = (torch.rand(B, S, C, generator=gen).to(dev) * 0.1, randn(B, S, C),
            -torch.rand(C, N, generator=gen).to(dev) * 3, randn(B, S, N),
            randn(B, S, N), randn(B, C, N))
    wy, wh = mamba_scan_cuda(*args)
    out = {"shape": f"B={B} S={S} C={C} N={N} f32",
           "unsharded_ms": time_ms(lambda: mamba_scan_cuda(*args), 5),
           "tp": {}}
    d, u, A, Bm, Cm, h0 = args
    for tp in tps:
        cl = C // tp

        def shard(r):
            sl = slice(r * cl, (r + 1) * cl)
            return (d[..., sl].contiguous(), u[..., sl].contiguous(),
                    A[sl].contiguous(), Bm, Cm, h0[:, sl].contiguous())

        parts = [mamba_scan_cuda(*shard(r)) for r in range(tp)]
        gy = torch.cat([p[0] for p in parts], dim=2)
        gh = torch.cat([p[1] for p in parts], dim=1)
        del parts
        rec = {"bit_equal": bool(torch.equal(gy, wy) and torch.equal(gh, wh)),
               "max_abs_err": max((gy - wy).abs().max().item(),
                                  (gh - wh).abs().max().item())}
        check(rec["bit_equal"], f"sharded K10 {label} tp={tp}: the channel "
              "slices are not bit-equal to the unsharded scan")
        del gy, gh
        a0 = shard(0)
        rec["bound_ms"], rec["bound_by"] = bound(
            4.0 * (B * S * (2 * cl + 2 * N) + B * S * cl + cl * N
                   + 2 * B * cl * N), 7.0 * B * S * cl * N + B * S * cl)
        rec["ms"] = time_ms(lambda: mamba_scan_cuda(*a0), 10)
        _, rec["plain_ms"] = timed(lambda: ref.mamba_scan_ref(*a0))
        rec["library_ms"] = None
        rec["local_shape"] = f"C={cl}"
        out["tp"][tp] = rec
        del a0
    return out


def sharded_moe(torch, dev, gen, arch, tokens, tps) -> dict:
    """Each model rank's routed experts (``E_padded / tp`` from ``e0``)
    on one layer of ``arch`` at full width in bf16, summed in rank order,
    against the one-device routed output."""
    from repro_torch.configs import ARCHS
    from repro_torch.models.moe import _routed, moe_init

    cfg = ARCHS[arch]
    E = cfg.n_experts_padded
    gdev = torch.Generator(device=dev).manual_seed(
        int(torch.randint(1 << 30, (1,), generator=gen)))
    p = {k: v.to(torch.bfloat16) for k, v in moe_init(
        gdev, dev, cfg.d_model, cfg.d_expert or cfg.d_ff, E, 0,
        cfg.act).items()}
    xt = torch.randn(tokens, cfg.d_model, generator=gdev,
                     device=dev).to(torch.bfloat16)
    opts = dict(top_k=cfg.top_k, n_real=cfg.n_experts, capacity_factor=1.25,
                act=cfg.act, with_aux=False)
    want, _ = _routed(xt, p["router"], p["wi"], p["wg"], p["wo"], **opts)
    out = {"shape": f"T={tokens} d={cfg.d_model} f={cfg.d_expert} "
                    f"E={E} ({cfg.n_experts} real) top_k={cfg.top_k} bf16",
           "unsharded_ms": time_ms(lambda: _routed(
               xt, p["router"], p["wi"], p["wg"], p["wo"], **opts), 3),
           "tp": {}}
    for tp in tps:
        el = E // tp
        y = None
        for r in range(tp):
            sl = slice(r * el, (r + 1) * el)
            yr, _ = _routed(xt, p["router"], p["wi"][sl], p["wg"][sl],
                            p["wo"][sl], e0=r * el, **opts)
            y = yr if y is None else y + yr
        rec = {"bit_equal": bool(torch.equal(y, want)),
               "max_abs_err": (y.float() - want.float()).abs().max().item()}
        if not rec["bit_equal"]:
            # top-k > 2: a token's k terms split across ranks are summed
            # per rank, then across ranks, another association of the same
            # bf16 terms than the one device's running sum
            k9_compare(f"sharded MoE {arch} tp={tp}", y, want)
            rec["why"] = (f"top_k = {cfg.top_k}: a token's terms on one "
                          "rank are summed before the ranks' sums, another "
                          "association of the same bf16 terms; held to "
                          f"{K9_TOL['bfloat16']} and a relative RMS error "
                          f"of {K9_BF16_REL_RMS}")
        rec["rank0_ms"] = time_ms(lambda: _routed(
            xt, p["router"], p["wi"][:el], p["wg"][:el], p["wo"][:el],
            e0=0, **opts), 3)
        out["tp"][tp] = rec
        del y
    del p, xt, want
    return out


def run_sharded_lm(torch, dev, train_warm: dict):
    """The ``sharded lm`` phase (after ``init_world``): the per-rank
    emulations, the sharded LM on the one-rank (1, 1) NCCL mesh against
    the unsharded LM, and the launcher ``launch.train`` with its restart
    check.  Returns (the path window's launch counts, the emulation
    records)."""
    from repro_torch.configs import ARCHS, get_arch
    from repro_torch.distributed.sharding import (AxisRules, full,
                                                  param_shardings)
    from repro_torch.kernels import _build
    from repro_torch.launch import train as launcher
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import LM
    from repro_torch.train.trainer import value_and_grad
    from repro_torch.tree import named_leaves

    t0 = time.perf_counter()
    gen = torch.Generator(device="cpu").manual_seed(25)
    recs = {"flash_attention": {c[0]: sharded_k9(torch, dev, gen, *c)
                                for c in SHARDED_K9},
            "mamba_scan": {SHARDED_K10["label"]: sharded_k10(
                torch, dev, gen, **SHARDED_K10)},
            "moe": sharded_moe(torch, dev, gen, **SHARDED_MOE)}
    gc.collect()
    torch.cuda.empty_cache()
    emul_s = time.perf_counter() - t0
    print("sharded lm emulation: " + json.dumps(recs))

    window = dict.fromkeys(_build.counts(), 0)

    def count(counts):
        for k, v in counts.items():
            window[k] += v

    # the sharded LM on the one-rank mesh against the unsharded LM
    t1 = time.perf_counter()
    mesh = make_host_mesh((1, 1), ("data", "model"), device_type="cuda")
    cfg = ARCHS["gemma2-2b"]
    g = torch.Generator(device=dev).manual_seed(LM_SEED)
    params = LM(cfg).init(g, device=dev)
    toks = torch.randint(0, cfg.vocab, (LM_SCORE["batch"],
                                        LM_SCORE["prompt"]),
                         generator=g, device=dev)
    line = {"mesh": [1, 1], "model": cfg.name, "score": LM_SCORE}
    logits = {}
    for route, model, tree in (
            ("unsharded", LM(cfg, attn_impl="kernel"), params),
            ("mesh", LM(cfg, mesh=mesh, attn_impl="kernel"),
             param_shardings(cfg, mesh, AxisRules(), params,
                             distribute_leaves=True))):
        torch.cuda.synchronize()
        _build.reset_counts()
        ts = time.perf_counter()
        lg, caches, _ = model.prefill(model.compute_params(tree),
                                      {"tokens": toks})
        lg = full(lg)
        torch.cuda.synchronize()
        line[f"{route}_prefill_s"] = time.perf_counter() - ts
        counts = _build.counts()
        line[f"{route}_prefill_launches"] = {k: v for k, v in counts.items()
                                             if v}
        count(counts)
        logits[route] = lg
        del caches, tree
    check(line["mesh_prefill_launches"] == line["unsharded_prefill_launches"]
          == {"flash_attention": cfg.n_layers},
          f"sharded lm: prefill launches {line['mesh_prefill_launches']} vs "
          f"{line['unsharded_prefill_launches']}")
    check(torch.equal(logits["mesh"], logits["unsharded"]),
          "sharded lm: the (1, 1) mesh's prefill logits are not bit-equal "
          "to the unsharded LM's (max abs "
          f"{(logits['mesh'] - logits['unsharded']).abs().max().item()})")
    line["prefill_bit_equal"] = True
    del params, logits
    gc.collect()
    torch.cuda.empty_cache()

    cfg2 = dataclasses.replace(cfg, n_layers=SHARDED_TRAIN_LAYERS)
    g = torch.Generator(device=dev).manual_seed(LM_SEED)
    params = LM(cfg2).init(g, device=dev)
    tb = torch.randint(0, cfg2.vocab, (1, 8192), generator=g, device=dev)
    batch = {"tokens": tb, "labels": torch.roll(tb, -1, 1)}
    grads = {}
    for route, model, tree in (
            ("unsharded", LM(cfg2, attn_impl="kernel"), params),
            ("mesh", LM(cfg2, mesh=mesh, attn_impl="kernel"),
             param_shardings(cfg2, mesh, AxisRules(), params,
                             distribute_leaves=True))):
        _build.reset_counts()
        (loss, _), gr = value_and_grad(model, tree, batch)
        torch.cuda.synchronize()
        counts = _build.counts()
        line[f"{route}_step_launches"] = {k: v for k, v in counts.items()
                                          if v}
        count(counts)
        grads[route] = (loss, [full(t) for _, t in named_leaves(gr)])
        del gr, tree
    (lu, gu), (lm, gm) = grads["unsharded"], grads["mesh"]
    check(line["mesh_step_launches"] == line["unsharded_step_launches"]
          == {"flash_attention": 2 * SHARDED_TRAIN_LAYERS},
          f"sharded lm: step launches {line['mesh_step_launches']}")
    diff = [(a - b).abs().max().item() for a, b in zip(gm, gu)]
    check(torch.equal(lm, lu) and max(diff) == 0.0,
          f"sharded lm: the mesh's step is not bit-equal (loss {lm.item()} "
          f"vs {lu.item()}, largest gradient difference {max(diff)})")
    line.update(step_layers=SHARDED_TRAIN_LAYERS, step_loss=lu.item(),
                step_bit_equal=True, mesh_s=time.perf_counter() - t1)
    del params, grads, gu, gm, batch
    gc.collect()
    torch.cuda.empty_cache()
    print("sharded lm mesh: " + json.dumps(line))

    # the launcher, as train-gemma runs, and its restart check
    t2 = time.perf_counter()
    _build.reset_counts()
    run = launcher.main(LAUNCH_FULL)
    counts = _build.counts()
    count(counts)
    n = int(LAUNCH_FULL[LAUNCH_FULL.index("--steps") + 1])
    check(counts["flash_attention"] == 2 * cfg.n_layers * n,
          f"sharded lm launcher: K9 launched {counts['flash_attention']} "
          f"times, expected 2 x {cfg.n_layers} x {n}")
    check(all(map(math.isfinite, run["losses"])),
          f"sharded lm launcher: a non-finite loss {run['losses']}")
    drv = {"argv": LAUNCH_FULL, "losses": run["losses"],
           "step_s": run["step_s"],
           "warm_step_s": statistics.mean(run["step_s"][1:]),
           "train_path_warm_step_s": train_warm.get("train-gemma"),
           "launches": {k: v for k, v in counts.items() if v},
           "s": time.perf_counter() - t2}
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        ck, lost, hb = (str(Path(tmp) / x) for x in ("ck", "lost", "hb"))
        _build.reset_counts()
        whole = launcher.main(LAUNCH_RESUME + [
            "--steps", "4", "--ckpt-every", "2", "--ckpt-dir", ck])
        # the job dies after step 2: only that checkpoint survives
        shutil.copytree(Path(ck) / "step_00000002",
                        Path(lost) / "step_00000002")
        resumed = launcher.main(LAUNCH_RESUME + [
            "--steps", "4", "--ckpt-every", "2", "--ckpt-dir", lost,
            "--heartbeat", hb])
        count(_build.counts())
        with open(hb) as f:
            beat = json.load(f)
    check(resumed["start"] == 2, f"sharded lm resume: restored step "
          f"{resumed['start']}, expected 2")
    rel = max(abs(a - b) / abs(b) for a, b in
              zip(resumed["losses"], whole["losses"][2:]))
    check(rel <= LAUNCH_RESUME_RTOL, f"sharded lm resume: losses "
          f"{resumed['losses']} vs {whole['losses'][2:]} beyond rtol "
          f"{LAUNCH_RESUME_RTOL}")
    check(beat["step"] == 3, f"sharded lm resume: heartbeat step "
          f"{beat['step']}, expected 3 (the last of 0-3)")
    drv["resume"] = {"argv": LAUNCH_RESUME, "whole_losses": whole["losses"],
                     "resumed_losses": resumed["losses"], "max_rel": rel,
                     "bit_equal": resumed["losses"] == whole["losses"][2:],
                     "heartbeat_step": beat["step"]}
    drv["sharded_lm_phase_s"] = time.perf_counter() - t0
    drv["emulation_s"] = emul_s
    print("sharded lm launcher: " + json.dumps(drv))
    return window, recs


def k9_tol(x) -> dict:
    """K9's tolerance for inputs of ``x``'s type."""
    return K9_TOL[str(x.dtype).removeprefix("torch.")]


def k9_compare(name: str, got, want) -> dict:
    """K9 against its plain version: ``compare`` within ``K9_TOL``, and in
    bf16 the relative RMS error within ``K9_BF16_REL_RMS``.  Returns the
    largest difference, the plain output's RMS and mean magnitude and the
    relative RMS error."""
    err = compare(name, got, want, exact=False, **k9_tol(want))
    g, w = got.float(), want.float()
    rms = w.square().mean().sqrt().item()
    rel = (g - w).square().mean().sqrt().item() / max(rms, 1e-30)
    if str(want.dtype) == "torch.bfloat16":
        check(rel <= K9_BF16_REL_RMS,
              f"{name}: relative RMS error {rel} > {K9_BF16_REL_RMS}")
    return dict(max_abs_err=err, ref_rms=rms,
                ref_mean_abs=w.abs().mean().item(), rel_rms_err=rel)


def attn_pairs(Sq: int, Skv: int, causal: bool, window: int | None) -> int:
    """Unmasked (query, key) pairs of one head under implicit positions:
    key j < Skv, j <= i if causal, i - j < window if windowed."""
    n = 0
    for i in range(Sq):
        lo = max(0, i - window + 1) if window is not None else 0
        hi = min(Skv - 1, i) if causal else Skv - 1
        n += max(0, hi - lo + 1)
    return n


def band_cells(L: int, w: int) -> int:
    wb = min(L if w >= L else w, L - 1)
    return L * (2 * wb + 1) - wb * (wb + 1)


def bound(bytes_: float, ops_: float,
          peak_ops: float = PEAK_FP32) -> tuple[float, str]:
    """The least milliseconds for ``bytes_`` moved at the HBM rate and
    ``ops_`` at ``peak_ops`` (default the FP32 non-tensor rate)."""
    tb, to = bytes_ / PEAK_BYTES * 1e3, ops_ / peak_ops * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def band_ops(nb: int) -> int:
    """Least FP32 operations of the elastic bands per pair.  Band ``bi``
    of each end has 2 bi + 1 distinct arm cells: one subtract each, 2 bi
    mins of the |differences| (|.| is free on the card, an operand
    modifier) and one multiply to square the least; each end sums its nb
    minima (nb - 1 adds) and one add joins the ends:
    4 nb^2 + 2 nb - 1 in all (71 at nb = 4)."""
    return 4 * nb * nb + 2 * nb - 1


def kernel_phases(torch, dev, recs, windows, sk_index, sk_queries,
                  main_idx, main_queries, long_recs, wide_recs, dn_recs,
                  ptxas):
    """Each kernel against its plain version at the paths' inputs (timed)
    and over a small sweep.  Returns the ``kernels`` records; a kernel's
    ``{main,sketch,long,wide}_path_launches`` are its counts in each
    path's window (``windows``; the wide path's sums its three cases';
    ``main`` adds the paper and dist windows after those paths run),
    ``launches`` their sum (one count per form).
    ``ptxas`` (``ptxas_report``) adds the redesigned kernels' registers
    and spills to their records."""
    import torch.nn.functional as F

    from repro_torch.core.lower_bounds import _n_bands
    from repro_torch.kernels import ref
    from repro_torch.kernels.dtw_band import (K4_FORMS, K4_WARP_MAX_WB,
                                              K5_BLOCK_FLOATS, K5_FORMS,
                                              K5_MAX_CLUSTER, K5_ROWS_MAX_L,
                                              STREAM_BLOCKS_PER_SM,
                                              dtw_band_cuda, dtw_band_route,
                                              k4_form, k4_slots,
                                              k5_cluster_size, k5_form,
                                              slots_warps)
    from repro_torch.kernels.envelope import envelope_cuda
    from repro_torch.kernels.lb_enhanced import lb_enhanced_cuda
    from repro_torch.kernels.lb_enhanced_pairwise import (
        lb_enhanced_pairwise_cuda)
    from repro_torch.kernels.lb_keogh import lb_keogh_cuda
    from repro_torch.kernels.sketch import sketch_bound_cuda

    def path_launches(kname: str) -> dict:
        # each path's own reset-and-read window, and their sum
        per = {f"{path}_path_launches": counts[kname]
               for path, counts in windows.items()}
        return dict(launches=sum(per.values()), **per)

    gen = torch.Generator(device="cpu").manual_seed(11)

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(dev)

    def long_lb(name, fn, rfn):
        """A bound kernel at its long-path input (L = 17984, w = L) in
        both forms against its plain version: bands-only bit-equal, the
        full form within rtol 1e-5.  Returns the record's long-path keys
        (the time is of the form the path ran)."""
        rec = long_recs[f"{name}_cuda"]
        args = rec.args
        kw = {k: v for k, v in rec.kwargs.items() if k != "bands_only"}
        errs = {}
        for bo, form in ((True, "bands_only"), (False, "full_form")):
            errs[f"long_path_{form}_max_abs_err"] = compare(
                f"{name} (long path, {form})", fn(*args, **kw, bands_only=bo),
                rfn(*args, **kw, bands_only=bo), exact=bo)
        return args, dict(
            long_path_ms=time_ms(lambda: fn(*args, **rec.kwargs), 5),
            long_path_bands_only=bool(rec.kwargs.get("bands_only")),
            **errs)

    out = []

    # ---- K1 envelope ------------------------------------------------------
    b, w = recs["envelope_cuda"].args
    N, L = b.shape
    err = compare("envelope", envelope_cuda(b, w), ref.envelope_ref(b, w),
                  exact=True)
    for n, Ls, ws in [(5, 33, 0), (7, 33, 1), (3, 67, 16), (4, 64, 64),
                      (2, 16384, 51), (3, 1001, 999), (1, 1, 0)]:
        x = randn(n, Ls)
        compare(f"envelope sweep {(n, Ls, ws)}", envelope_cuda(x, ws),
                ref.envelope_ref(x, ws), exact=True)
    # any window at long series: L = 65536 with w = L / 100 and w = L
    x = randn(4, 65536)
    for ws in (655, 65536):
        compare(f"envelope L=65536 w={ws}", envelope_cuda(x, ws),
                ref.envelope_ref(x, ws), exact=True)
    bl, wl = long_recs["envelope_cuda"].args
    err_long = compare("envelope (long path)", envelope_cuda(bl, wl),
                       ref.envelope_ref(bl, wl), exact=True)
    stacked = torch.stack([b, -b])
    # max_pool1d pads by at most half its window; w = L - 1 gives the
    # same envelopes as w = L (both windows cover the whole series)
    wp = min(wl, bl.shape[1] - 1)
    stacked_l = torch.stack([bl, -bl])
    bms, by = bound(12.0 * N * L, 6.0 * N * L)
    out.append(dict(
        name="envelope", route="cuda", source="src/repro_torch/csrc/envelope.cu",
        replaces="src/repro/kernels/envelope.py:72",
        **path_launches("envelope"), max_abs_err=max(err, err_long),
        ms=time_ms(lambda: envelope_cuda(b, w), 20),
        plain_ms=time_ms(lambda: ref.envelope_ref(b, w), 5),
        bound_ms=bms, bound_by=by,
        library_ms=time_ms(lambda: F.max_pool1d(
            stacked, 2 * w + 1, stride=1, padding=w), 20),
        shape=f"N={N} L={L} w={w}",
        long_path_shape=f"N={bl.shape[0]} L={bl.shape[1]} w={wl}",
        long_path_ms=time_ms(lambda: envelope_cuda(bl, wl), 5),
        long_path_bound_ms=bound(12.0 * bl.numel(), 6.0 * bl.numel())[0],
        long_path_plain_ms=time_ms(lambda: ref.envelope_ref(bl, wl), 3,
                                   warmup=1),
        long_path_library_ms=time_ms(lambda: F.max_pool1d(
            stacked_l, 2 * wp + 1, stride=1, padding=wp), 2, warmup=1)))

    # ---- K2 cross-block LB_ENHANCED (bands-only on the path) --------------
    # The path's recorded call is one launch over the whole store.  The
    # plain version's full form materialises (Q, C, L) intermediates, so
    # it is compared over chunks of 512 candidates (the bound is per pair).
    def lb_plain(q_, c_, u_, lo_, w_, v_, *, live=None, bands_only=False):
        return torch.cat([ref.lb_enhanced_ref(
            q_, c_[s:s + 512], u_[s:s + 512], lo_[s:s + 512], w_, v_,
            live=None if live is None else live[s:s + 512],
            bands_only=bands_only) for s in range(0, c_.shape[0], 512)],
            dim=1)

    def lb_chunked(q_, c_, u_, lo_, w_, v_, *, live=None, bands_only=False):
        # the earlier dispatch: one launch per 512 candidates, then a cat
        return torch.cat([lb_enhanced_cuda(
            q_, c_[s:s + 512], u_[s:s + 512], lo_[s:s + 512], w_, v_,
            live=None if live is None else live[s:s + 512],
            bands_only=bands_only) for s in range(0, c_.shape[0], 512)],
            dim=1)

    args = recs["lb_enhanced_cuda"].args
    kw = recs["lb_enhanced_cuda"].kwargs
    q, c, u, lo, w2, v = args
    check(kw.get("bands_only") is True, "the bands tier ran the full form")
    Q, L = q.shape
    C = c.shape[0]
    check(C == main_idx.n, f"the bands tier's launch took {C} candidates, "
          f"not the whole store ({main_idx.n})")
    nb = _n_bands(L, w2, v)
    err = compare("lb_enhanced bands", lb_enhanced_cuda(*args, **kw),
                  ref.lb_enhanced_ref(*args, **kw), exact=True)
    compare("lb_enhanced bands = chunked launches", lb_chunked(*args, **kw),
            lb_enhanced_cuda(*args, **kw), exact=True)
    # the sketch path's tier call: the sketch store under its live mask
    sq_ = torch.as_tensor(sk_queries, dtype=torch.float32, device=dev)
    sk_args = (sq_, sk_index.series, sk_index.upper, sk_index.lower, w2, v)
    sk_kw = dict(live=sk_index.live, bands_only=True)
    err_sk = compare("lb_enhanced bands (sketch store, live mask)",
                     lb_enhanced_cuda(*sk_args, **sk_kw),
                     ref.lb_enhanced_ref(*sk_args, **sk_kw), exact=True)
    # the earlier chunk shape: the first 512 candidates
    ch_args = (q, c[:512].contiguous(), u[:512].contiguous(),
               lo[:512].contiguous(), w2, v)
    for Qs, Cs, Ls, ws, vs in [(3, 37, 33, 8, 4), (9, 70, 64, 1, 4),
                               (5, 33, 31, 0, 4), (4, 40, 24, 24, 8),
                               (2, 65, 9, 9, 4)]:
        qs, cs = randn(Qs, Ls), randn(Cs, Ls)
        us, ls = ref.envelope_ref(cs, ws)
        live = torch.rand(Cs, generator=gen).to(dev) > 0.3
        live[:32] = False                             # an all-dead tile
        for lv in (None, live):
            compare("lb_enhanced bands sweep",
                    lb_enhanced_cuda(qs, cs, us, ls, ws, vs, live=lv,
                                     bands_only=True),
                    ref.lb_enhanced_ref(qs, cs, us, ls, ws, vs, live=lv,
                                        bands_only=True), exact=True)
    bms, by = bound(4.0 * Q * C + 8.0 * nb * (Q + C),
                    float(band_ops(nb)) * Q * C)
    Qs_, Cs_ = sq_.shape[0], sk_index.n
    sk_live = int(sk_index.live.sum().item()) if sk_index.live is not None \
        else Cs_
    (ql, cl, _, _, wl, vl), k2_long = long_lb("lb_enhanced", lb_enhanced_cuda,
                                              lb_plain)
    check(k2_long["long_path_bands_only"], "the long path's bands tier ran "
          "the full form")
    Ql, Ll = ql.shape
    Cl = cl.shape[0]
    nbl = _n_bands(Ll, wl, vl)
    out.append(dict(
        name="lb_enhanced", route="cuda",
        source="src/repro_torch/csrc/lb_enhanced.cu",
        replaces="src/repro/kernels/lb_enhanced.py:132",
        **path_launches("lb_enhanced"), max_abs_err=err,
        ms=time_ms(lambda: lb_enhanced_cuda(*args, **kw), 50),
        plain_ms=time_ms(lambda: ref.lb_enhanced_ref(*args, **kw), 5),
        bound_ms=bms, bound_by=by, library_ms=None,
        shape=f"Q={Q} C={C} L={L} w={w2} v={v} bands_only (the main path's "
              "tier call: one launch over the whole store)",
        device_ms=device_ms(lambda: lb_enhanced_cuda(*args, **kw),
                            "lb_bands_kernel"),
        chunked_tier_ms=time_ms(lambda: lb_chunked(*args, **kw), 20),
        chunked_tier_launches=-(-C // 512),
        chunk_shape=f"Q={Q} C=512 bands_only (the earlier launch)",
        chunk_shape_ms=time_ms(lambda: lb_enhanced_cuda(
            *ch_args, bands_only=True), 50),
        chunk_shape_device_ms=device_ms(lambda: lb_enhanced_cuda(
            *ch_args, bands_only=True), "lb_bands_kernel"),
        chunk_shape_bound_ms=bound(4.0 * Q * 512 + 8.0 * nb * (Q + 512),
                                   float(band_ops(nb)) * Q * 512)[0],
        sketch_store_shape=f"Q={Qs_} C={Cs_} live={sk_live} bands_only "
                           "(the sketch path's tier call)",
        sketch_store_max_abs_err=err_sk,
        sketch_store_ms=time_ms(lambda: lb_enhanced_cuda(*sk_args, **sk_kw),
                                20),
        sketch_store_device_ms=device_ms(
            lambda: lb_enhanced_cuda(*sk_args, **sk_kw), "lb_bands_kernel"),
        sketch_store_chunked_ms=time_ms(lambda: lb_chunked(*sk_args,
                                                           **sk_kw), 10),
        sketch_store_bound_ms=bound(
            4.0 * Qs_ * Cs_ + 8.0 * nb * (Qs_ + Cs_) + Cs_,
            float(band_ops(nb)) * Qs_ * sk_live)[0],
        long_path_shape=f"Q={Ql} C={Cl} L={Ll} w={wl} v={vl} bands_only",
        long_path_bound_ms=bound(4.0 * Ql * Cl + 8.0 * nbl * (Ql + Cl),
                                 float(band_ops(nbl)) * Ql * Cl)[0],
        **k2_long))

    # ---- K2 full form (the dense path's enhanced_dense tier) --------------
    # dense-a's tier call (the main store: Q = 256, C = 16384), with and
    # without a live mask; its bands part (infinite envelopes make every
    # bridge term 0) bit-equal to the bands form; K8 bit-equal to it at
    # V = 0 (one body); dense-c's call under the sketch store's mask; the
    # sweep of K2_FULL_SWEEP on real and odd envelopes (lo > u, +-inf, a
    # NaN), NaN where the plain version has NaN
    args = dn_recs["dense-a"].args
    q, c, u, lo, w2, v = args
    Q, L = q.shape
    C = c.shape[0]
    nb = _n_bands(L, w2, v)
    err = compare("lb_enhanced_full (dense-a)", lb_enhanced_cuda(*args),
                  lb_plain(*args), exact=False)
    live = torch.rand(C, generator=gen).to(dev) > 0.3
    live[:128] = False                            # two all-dead tiles
    err_live = compare("lb_enhanced_full (dense-a, live)",
                       lb_enhanced_cuda(*args, live=live),
                       lb_plain(*args, live=live), exact=False)
    inf = torch.full_like(c, float("inf"))
    compare("lb_enhanced_full's bands = the bands form (dense-a)",
            lb_enhanced_cuda(q, c, inf, -inf, w2, v),
            lb_enhanced_cuda(*args, bands_only=True), exact=True)
    del inf
    compare("lb_keogh = lb_enhanced_full at V = 0 (dense-a)",
            lb_keogh_cuda(q, u, lo), lb_enhanced_cuda(q, c, u, lo, w2, 0),
            exact=True)
    c_args, c_kw = dn_recs["dense-c"].args, dn_recs["dense-c"].kwargs
    check(c_kw.get("live") is not None, "dense-c's tier call had no mask")
    err_c = compare("lb_enhanced_full (dense-c, live mask)",
                    lb_enhanced_cuda(*c_args, **c_kw),
                    lb_plain(*c_args, **c_kw), exact=False)

    def odd_envelopes(u_, lo_):
        u_, lo_ = u_.clone(), lo_.clone()
        Cs, Ls = u_.shape
        u_[1, Ls // 2] = lo_[1, Ls // 2] - 3.0
        lo_[2, 1:Ls - 1] = u_[2, 1:Ls - 1] + 0.5
        u_[3, :] = float("inf")
        lo_[4, :Ls // 2] = float("-inf")
        lo_[Cs - 1, Ls // 3] = float("nan")
        return u_, lo_

    sweep_err = 0.0
    for Qs, Cs, Ls, ws, vs in K2_FULL_SWEEP:
        qs, cs = randn(Qs, Ls), randn(Cs, Ls)
        us, ls = ref.envelope_ref(cs, ws)
        lv = torch.rand(Cs, generator=gen).to(dev) > 0.3
        lv[:64] = False                           # an all-dead tile
        for odd in (False, True):
            uu, ll = odd_envelopes(us, ls) if odd else (us, ls)
            for lvv in (None, lv):
                got = lb_enhanced_cuda(qs, cs, uu, ll, ws, vs, live=lvv)
                want = ref.lb_enhanced_ref(qs, cs, uu, ll, ws, vs, live=lvv)
                tag = f"lb_enhanced_full sweep {(Qs, Cs, Ls, ws, vs)}" + (
                    " odd envelopes" if odd else "") + (
                    " live" if lvv is not None else "")
                check(torch.equal(torch.isnan(got), torch.isnan(want)),
                      f"{tag}: NaN positions differ from the plain version")
                ok = ~torch.isnan(want)
                sweep_err = max(sweep_err, compare(tag, got[ok], want[ok],
                                                   exact=False))
        inf = torch.full_like(cs, float("inf"))
        compare(f"lb_enhanced_full's bands {(Qs, Cs, Ls, ws, vs)}",
                lb_enhanced_cuda(qs, cs, inf, -inf, ws, vs, live=lv),
                lb_enhanced_cuda(qs, cs, us, ls, ws, vs, live=lv,
                                 bands_only=True), exact=True)
        compare(f"lb_keogh = lb_enhanced_full at V = 0 "
                f"{(Qs, Cs, Ls, ws)}", lb_keogh_cuda(qs, us, ls),
                lb_enhanced_cuda(qs, cs, us, ls, ws, 0), exact=True)
    props = torch.cuda.get_device_properties(dev)
    issue_hz = props.multi_processor_count * 128 * max_sm_clock_hz()
    Qc, Cc = c_args[0].shape[0], c_args[1].shape[0]
    c_live = int(c_kw["live"].sum().item())
    out.append(dict(
        name="lb_enhanced_full", route="cuda",
        source="src/repro_torch/csrc/lb_enhanced.cu",
        replaces="src/repro/kernels/lb_enhanced.py:132",
        **path_launches("lb_enhanced_full"),
        max_abs_err=max(err, err_live, err_c),
        ms=time_ms(lambda: lb_enhanced_cuda(*args), 20),
        plain_ms=time_ms(lambda: lb_plain(*args), 3),
        # q, c, u and lo read once, the matrix written once, against the
        # bands' operations plus K8's 5 per column of the bridge and one
        # add a pair
        **dict(zip(("bound_ms", "bound_by"), bound(
            4.0 * (Q * L + 3 * C * L) + 4.0 * Q * C,
            float(band_ops(nb) + 5 * (L - 2 * nb) + 1) * Q * C))),
        library_ms=None,
        # the bridge's 4 instructions a term at the FP32 issue rate
        issue_floor_ms=4.0 * Q * C * (L - 2 * nb) / issue_hz * 1e3,
        shape=f"Q={Q} C={C} L={L} w={w2} v={v} (dense-a's tier call: one "
              "launch over the whole store)",
        form="K8's body (kg_tile, csrc/lb_keogh.cuh) over the bridge [nb, "
             "L - nb): 128 x 64 tiles, 8 x 4 a thread, 32-column cp.async "
             "chunks, the !(lo <= u) vote; then the bands of the bands "
             "form and one __fadd_rn(bands, bridge)",
        live_max_abs_err=err_live, sweep_max_abs_err=sweep_err,
        bands_bit_equal_to_bands_form=True, k8_bit_equal_at_v0=True,
        dense_c_shape=f"Q={Qc} C={Cc} live={c_live} (dense-c's tier call)",
        dense_c_max_abs_err=err_c,
        dense_c_ms=time_ms(lambda: lb_enhanced_cuda(*c_args, **c_kw), 10),
        dense_c_bound_ms=bound(
            4.0 * (Qc * L + 3 * Cc * L) + 4.0 * Qc * Cc + Cc,
            float(band_ops(nb) + 5 * (L - 2 * nb) + 1) * Qc * c_live)[0],
        **ptxas.get("lb_enhanced_full", {})))

    # ---- K3 pairwise LB_ENHANCED ------------------------------------------
    args = recs["lb_enhanced_pairwise_cuda"].args
    kw = recs["lb_enhanced_pairwise_cuda"].kwargs
    q, c, u, lo, w3, v = args
    P, L = q.shape
    err = compare("lb_enhanced_pairwise",
                  lb_enhanced_pairwise_cuda(*args, **kw),
                  ref.lb_enhanced_pairwise_ref(*args, **kw), exact=False)
    for Ps, Ls, ws in [(9, 33, 7), (130, 47, 11), (70, 64, 64), (16, 5, 4),
                       (33, 8, 1), (40, 31, 0)]:
        qs, cs = randn(Ps, Ls), randn(Ps, Ls)
        us, ls = ref.envelope_ref(cs, ws)
        live = torch.rand(Ps, generator=gen).to(dev) > 0.3
        live[:8] = False                              # an all-dead block
        for lv in (None, live):
            compare("lb_enhanced_pairwise bands sweep",
                    lb_enhanced_pairwise_cuda(qs, cs, us, ls, ws, V,
                                              live=lv, bands_only=True),
                    ref.lb_enhanced_pairwise_ref(qs, cs, us, ls, ws, V,
                                                 live=lv, bands_only=True),
                    exact=True)
            compare("lb_enhanced_pairwise sweep",
                    lb_enhanced_pairwise_cuda(qs, cs, us, ls, ws, V,
                                              live=lv),
                    ref.lb_enhanced_pairwise_ref(qs, cs, us, ls, ws, V,
                                                 live=lv), exact=False)
    nb = _n_bands(L, w3, v)
    # the function reads q, u and lo over the bridge [nb, L - nb) and q, c
    # at the 2 nb band columns, and writes one bound per pair; each bridge
    # column costs two subtracts, two maxes, a multiply and an add
    bms, by = bound(12.0 * P * (L - 2 * nb) + 16.0 * nb * P + 4.0 * P,
                    6.0 * P * (L - 2 * nb) + float(band_ops(nb)) * P)
    (ql, _, _, _, wl, vl), k3_long = long_lb(
        "lb_enhanced_pairwise", lb_enhanced_pairwise_cuda,
        ref.lb_enhanced_pairwise_ref)
    Pl, Ll = ql.shape
    nbl = _n_bands(Ll, wl, vl)
    out.append(dict(
        name="lb_enhanced_pairwise", route="cuda",
        source="src/repro_torch/csrc/lb_enhanced_pairwise.cu",
        replaces="src/repro/kernels/lb_enhanced_pairwise.py:122",
        **path_launches("lb_enhanced_pairwise"), max_abs_err=err,
        ms=time_ms(lambda: lb_enhanced_pairwise_cuda(*args, **kw), 20),
        plain_ms=time_ms(lambda: ref.lb_enhanced_pairwise_ref(*args, **kw),
                         3),
        bound_ms=bms, bound_by=by, library_ms=None,
        shape=f"P={P} L={L} w={w3} v={v}",
        long_path_shape=f"P={Pl} L={Ll} w={wl} v={vl}",
        long_path_bound_ms=bound(
            12.0 * Pl * (Ll - 2 * nbl) + 16.0 * nbl * Pl + 4.0 * Pl,
            6.0 * Pl * (Ll - 2 * nbl) + float(band_ops(nbl)) * Pl)[0],
        **k3_long))

    # ---- K4 banded DTW, K6 its per-step form, K5 its band-streaming form
    # K4 and K6 in each of their three forms at the main path's largest DTW
    # launch (the path ran the warp form, which k4_form picks at w = 51;
    # the slots form forced runs one warp of 22 slots a lane), with the
    # round's cutoffs and without: bit-equal to the plain version and to
    # each other, and timed on the same card
    a, bb, w4, cut = recs["dtw_band_cuda"].args
    P, L = a.shape
    check(k4_form(L, w4) == "warp", f"k4_form({L}, {w4}) is not the warp "
          "form")
    plain4_cut = ref.dtw_band_ref(a, bb, w4, cut)
    plain4, plain4_ms = timed(lambda: ref.dtw_band_ref(a, bb, w4))
    plain6, plain6_ms = timed(lambda: ref.dtw_band_ref(a, bb, w4,
                                                       row_block=1))
    check(torch.equal(plain6, plain4), "the plain K6 and K4 differ")
    k4e, k4t = {}, {}
    main_forms = ("warp", "slots", "block")
    for form in main_forms:
        k4_cut = dtw_band_cuda(a, bb, w4, cut, form=form)
        k4e[form] = max(
            compare(f"dtw_band {form} (round cutoffs)", k4_cut, plain4_cut,
                    exact=True),
            compare(f"dtw_band {form}", dtw_band_cuda(a, bb, w4, form=form),
                    plain4, exact=True))
        # K6 at the same inputs: bit-equal to its plain version and to K4
        k6e = compare(f"dtw_band_step {form} (round cutoffs)",
                      dtw_band_cuda(a, bb, w4, cut, early_exit=False,
                                    form=form),
                      ref.dtw_band_ref(a, bb, w4, cut, row_block=1),
                      exact=True)
        k4e["step_" + form] = max(k6e, compare(
            f"dtw_band_step {form} = K4", dtw_band_cuda(
                a, bb, w4, early_exit=False, form=form), plain4, exact=True))
        compare(f"dtw_band_step {form} = K4 (round cutoffs)", dtw_band_cuda(
            a, bb, w4, cut, early_exit=False, form=form), k4_cut, exact=True)
    # forms in turns (warp, slots, block, block, slots, warp), the mean of
    # each pair
    for form in main_forms + main_forms[::-1]:
        for kind, kw in (("", {}), ("cut_", {"cutoff": cut}),
                         ("step_", {"early_exit": False})):
            k4t.setdefault(kind + form, []).append(time_ms(
                lambda: dtw_band_cuda(a, bb, w4, form=form, **kw), 20))
    k4t = {key: sum(v) / len(v) for key, v in k4t.items()}
    # the sweep: K4 in each form that holds the band, K5 forced in its
    # three and K6 in K4's forms, each against the plain version; wb =
    # 255 / 256 straddle the warp form's edge, and the slots form runs at
    # one warp a pair (wb <= 256) and in two (wb = 1023)
    for Ps, Ls, ws in [(37, 33, 0), (37, 33, 1), (37, 33, 8), (37, 33, 33),
                       (20, 100, 25), (5, 513, 51), (3, 1, 0), (6, 2, 5),
                       (4, 700, 700), (9, 64, 31), (9, 66, 32), (6, 300, 100),
                       (4, 600, K4_WARP_MAX_WB),
                       (4, 600, K4_WARP_MAX_WB + 1), (2, 1100, 1023)]:
        xa, xb = randn(Ps, Ls), randn(Ps, Ls)
        exact_d = ref.dtw_band_ref(xa, xb, ws)
        cut_s = exact_d * (0.5 + torch.rand(Ps, generator=gen).to(dev))
        cut_s[::5] = float("-inf")                    # invalid slots
        wbs = min(ws, max(Ls - 1, 0))
        forms = K4_FORMS if wbs <= K4_WARP_MAX_WB else K4_FORMS[1:]
        for cs, rb in ((None, None), (cut_s, None), (cut_s, 7)):
            want = ref.dtw_band_ref(xa, xb, ws, cs, row_block=rb)
            for form in forms:
                compare(f"dtw_band {form} sweep {(Ps, Ls, ws, rb)}",
                        dtw_band_cuda(xa, xb, ws, cs, row_block=rb,
                                      form=form), want, exact=True)
            for form in K5_FORMS:
                compare(f"dtw_band_stream {form} sweep {(Ps, Ls, ws, rb)}",
                        dtw_band_cuda(xa, xb, ws, cs, row_block=rb,
                                      stream=True, form=form), want,
                        exact=True)
        for form in forms:
            compare(f"dtw_band_step {form} sweep {(Ps, Ls, ws)}",
                    dtw_band_cuda(xa, xb, ws, cut_s, early_exit=False,
                                  form=form),
                    ref.dtw_band_ref(xa, xb, ws, cut_s, row_block=1),
                    exact=True)
    # the slots form's cluster of two blocks (wb = 8300 > 8191: 17 warps a
    # pair, edges and check minima through distributed shared memory), K4
    # and K6, without cutoffs and with cutoffs that kill a pair mid-sweep,
    # let one finish and refuse one (-inf): bit-equal to one plain call
    # that checks every step, K4 with row blocks of 1 (the plain version's
    # time is its anti-diagonals', not its pairs', so each of the two pairs
    # runs three times in it)
    Lc, wc_ = 8400, 8300
    check(k4_form(Lc, wc_) == "slots" and slots_warps(wc_, k4_slots(
        Lc, wc_)) == 17, "(8400, 8300) is not the slots form's cluster")
    xa, xb = randn(2, Lc).repeat(3, 1), randn(2, Lc).repeat(3, 1)
    ex = dtw_band_cuda(xa[:2], xb[:2], wc_, form="block")
    cut_c = torch.cat([torch.full((2,), float("inf"), device=dev),
                       ex * torch.tensor([0.5, 1.01], device=dev),
                       torch.tensor([float("-inf")], device=dev),
                       ex[1:] * 0.97])
    want = ref.dtw_band_ref(xa, xb, wc_, cut_c, row_block=1)
    check(torch.isfinite(want[[0, 1, 3]]).all()
          and torch.isposinf(want[[2, 4]]).all(),
          "the cluster shape's cutoffs do not kill and spare as meant")
    for early in (True, False):
        compare(f"dtw_band{'' if early else '_step'} slots cluster "
                f"(2 blocks, 17 warps) {(Lc, wc_)}", dtw_band_cuda(
                    xa, xb, wc_, cut_c, row_block=1, early_exit=early),
                want, exact=True)
    # K4's slots form, and K6's, on the wide path's largest rounds: wide-b
    # (L = 512, w = L; the row's shape) and wide-c (L = 17984, w = 0.2 L).
    # In one call and in turns (slots, block, rows, rows, block, slots):
    # the slots form, the block form forced and K5's rows form forced,
    # without cutoffs; the three bit-equal on the whole round, with the
    # round's cutoffs and without, and the slots form equal to the plain
    # version (wide-b's whole round, LONG_SAMPLE pairs of wide-c's).
    rivals = {"slots": {}, "block": {"form": "block"},
              "rows": {"stream": True, "form": "rows"}}
    wide = {}
    for label, reps in (("wide-b", 5), ("wide-c", 2)):
        wa, wb_, ww, wcut = wide_recs[label].args[:4]
        Pw, Lw = wa.shape
        check(k4_form(Lw, ww) == "slots", f"{label}'s round is not the "
              "slots form's")
        got = {f: dtw_band_cuda(wa, wb_, ww, **kw) for f, kw in rivals.items()}
        got_c = {f: dtw_band_cuda(wa, wb_, ww, wcut, **kw)
                 for f, kw in rivals.items()}
        for f in ("block", "rows"):
            compare(f"{label} round: {f} = slots", got[f], got["slots"],
                    exact=True)
            compare(f"{label} round (its cutoffs): {f} = slots", got_c[f],
                    got_c["slots"], exact=True)
        rec = dict(shape=f"P={Pw} L={Lw} w={ww} no cutoff ({label}'s largest "
                         f"round; M = {k4_slots(Lw, ww)}, G = "
                         f"{slots_warps(min(ww, Lw - 1), k4_slots(Lw, ww))})",
                   cells=band_cells(Lw, ww) * Pw,
                   bytes=8.0 * Pw * Lw + 8.0 * Pw)
        if label == "wide-b":
            plain_w, rec["plain_ms"] = timed(lambda: ref.dtw_band_ref(
                wa, wb_, ww))
            rec["err"] = max(
                compare("dtw_band_slots (wide-b round)", got["slots"],
                        plain_w, exact=True),
                compare("dtw_band_slots (wide-b round, its cutoffs)",
                        got_c["slots"], ref.dtw_band_ref(wa, wb_, ww, wcut),
                        exact=True))
            plain_w6, rec["plain6_ms"] = timed(lambda: ref.dtw_band_ref(
                wa, wb_, ww, row_block=1))
            check(torch.equal(plain_w6, plain_w), "the plain K6 and K4 "
                  "differ on wide-b's round")
            rec["err6"] = max(
                compare("dtw_band_step_slots (wide-b round)", dtw_band_cuda(
                    wa, wb_, ww, early_exit=False), plain_w, exact=True),
                compare("dtw_band_step_slots (wide-b round, its cutoffs)",
                        dtw_band_cuda(wa, wb_, ww, wcut, early_exit=False),
                        got_c["slots"], exact=True))
            rec["step_ms"] = time_ms(lambda: dtw_band_cuda(
                wa, wb_, ww, early_exit=False), reps)
            rec["cut_ms"] = time_ms(lambda: dtw_band_cuda(wa, wb_, ww, wcut),
                                    reps)
        else:
            sel = torch.linspace(0, Pw - 1, min(LONG_SAMPLE, Pw),
                                 device=dev).round().long()
            sa_, sb_ = wa[sel].contiguous(), wb_[sel].contiguous()
            sc_ = torch.as_tensor(wcut, device=dev).expand(Pw)[sel]
            plain_s, rec["sample_plain_ms"] = timed(lambda: ref.dtw_band_ref(
                sa_, sb_, ww, sc_))
            rec["err"] = compare(
                "dtw_band_slots (wide-c round pairs, cutoffs)",
                dtw_band_cuda(sa_, sb_, ww, sc_), plain_s, exact=True)
        ms = {}
        for f in ("slots", "block", "rows", "rows", "block", "slots"):
            ms.setdefault(f, []).append(time_ms(
                lambda: dtw_band_cuda(wa, wb_, ww, **rivals[f]), reps,
                warmup=1))
        rec["ms"] = {f: sum(v) / len(v) for f, v in ms.items()}
        rec["bound"] = bound(rec["bytes"], 5.0 * rec["cells"])
        wide[label] = rec
    wb_rec, wc_rec = wide["wide-b"], wide["wide-c"]
    warp_cells_per_s = band_cells(L, w4) * P / (k4t["warp"] * 1e-3)
    out.append(dict(
        name="dtw_band_slots", route="cuda",
        source="src/repro_torch/csrc/dtw_band.cu",
        replaces="src/repro/kernels/dtw_band.py:323",
        **path_launches("dtw_band_slots"),
        max_abs_err=max(wb_rec["err"], wc_rec["err"]),
        ms=wb_rec["ms"]["slots"], plain_ms=wb_rec["plain_ms"],
        bound_ms=wb_rec["bound"][0], bound_by=wb_rec["bound"][1],
        library_ms=None,
        form="slots: G warps a pair, lane 32 w + l holding band slots "
             "[(32 w + l) M, (32 w + l) M + M) in registers and its windows "
             "of a and b, warp edges through shared memory, a __syncthreads "
             "a step when G > 1",
        shape=wb_rec["shape"], round_cutoffs_ms=wb_rec["cut_ms"],
        block_ms=wb_rec["ms"]["block"], rows_ms=wb_rec["ms"]["rows"],
        cells_per_s=wb_rec["cells"] / (wb_rec["ms"]["slots"] * 1e-3),
        warp_form_main_path_cells_per_s=warp_cells_per_s,
        wide_c_shape=wc_rec["shape"],
        wide_c_ms=wc_rec["ms"]["slots"], wide_c_block_ms=wc_rec["ms"]["block"],
        wide_c_rows_ms=wc_rec["ms"]["rows"],
        wide_c_bound_ms=wc_rec["bound"][0],
        wide_c_cells_per_s=wc_rec["cells"] / (wc_rec["ms"]["slots"] * 1e-3),
        wide_c_sample_plain_ms=wc_rec["sample_plain_ms"],
        main_input_ms=k4t["slots"], main_input_warp_ms=k4t["warp"],
        main_input_err=k4e["slots"],
        **ptxas.get("dtw_band_slots", {})))
    out.append(dict(
        name="dtw_band_step_slots", route="cuda",
        source="src/repro_torch/csrc/dtw_band.cu",
        replaces="src/repro/kernels/dtw_band.py:121",
        **path_launches("dtw_band_step_slots"), max_abs_err=wb_rec["err6"],
        ms=wb_rec["step_ms"], plain_ms=wb_rec["plain6_ms"],
        **dict(zip(("bound_ms", "bound_by"),
                   bound(wb_rec["bytes"], 6.0 * wb_rec["cells"]))),
        library_ms=None, form="slots, a check and poisoning every step",
        shape=wb_rec["shape"], k4_ms=wb_rec["ms"]["slots"],
        main_input_ms=k4t["step_slots"],
        main_input_warp_ms=k4t["step_warp"],
        main_input_err=k4e["step_slots"],
        **ptxas.get("dtw_band_step_slots", {})))
    bms, by = bound(8.0 * P * L + 8.0 * P, 5.0 * band_cells(L, w4) * P)
    # K6: K4's 5 operations per band cell plus the per-step frontier test,
    # one min per cell (each cell's minimum is taken once and carried to
    # the next step's min(S_d, S_{d-1}))
    bms6, by6 = bound(8.0 * P * L + 8.0 * P, 6.0 * band_cells(L, w4) * P)
    shape4 = f"P={P} L={L} w={w4} no cutoff (the main path's K4 input)"
    forms4 = {
        "warp": "warp: one warp a pair, lane l holding band slots "
                f"[l M, l M + M) in registers (M = "
                f"{next(m for m in (2, 4, 8, 16) if 32 * m > 2 * w4)} "
                "here), one shuffle a step, no block barrier",
        "block": "block: one block a pair, the two band buffers in shared "
                 "memory, a __syncthreads a step (forced only: the slots "
                 "form's baseline)",
    }
    for form in ("warp", "block"):
        sfx = "" if form == "warp" else "_block"
        out.append(dict(
            name="dtw_band" + sfx, route="cuda",
            source="src/repro_torch/csrc/dtw_band.cu",
            replaces="src/repro/kernels/dtw_band.py:323",
            **path_launches("dtw_band" + sfx), max_abs_err=k4e[form],
            ms=k4t[form], plain_ms=plain4_ms, bound_ms=bms, bound_by=by,
            library_ms=None, form=forms4[form], shape=shape4,
            round_cutoffs_ms=k4t["cut_" + form],
            **({} if form == "warp" else dict(
                wide_b_round_ms=wb_rec["ms"]["block"],
                wide_c_round_ms=wc_rec["ms"]["block"])),
            **ptxas.get("dtw_band" + sfx, {})))
        out.append(dict(
            name="dtw_band_step" + sfx, route="cuda",
            source="src/repro_torch/csrc/dtw_band.cu",
            replaces="src/repro/kernels/dtw_band.py:121",
            **path_launches("dtw_band_step" + sfx),
            max_abs_err=k4e["step_" + form], ms=k4t["step_" + form],
            plain_ms=plain6_ms, bound_ms=bms6, bound_by=by6,
            library_ms=None, form=forms4[form], shape=shape4,
            k4_ms=k4t[form], **ptxas.get("dtw_band_step" + sfx, {})))

    # K5 in its three forms.  (a) "rows" on the long path's largest round
    # (the form the path ran) with its own cutoffs, on pairs of all its
    # rounds with their cutoffs, just over the K4/K5 crossover and at the
    # (a)/(b) edge; (b) "cluster" forced on the round and over the
    # crossover, past the edge in its own 2 blocks and in 3, 4 and 8, and
    # at L = 65536 (3 blocks) timed, in 3, 4 and 8 blocks and beside the
    # scratch form; (c) "scratch" (past what a cluster holds, so never on a
    # path here) forced on the round, over the crossover, past the edge and
    # at L = 65536.  The plain version sweeps all 2 L - 1 anti-diagonals of
    # a shape whatever its pairs and cutoffs, so a shape has one plain run
    # or two: the round's with its own cutoffs; at the edge one with
    # cutoffs from the default form's values, twice one pair's (spared: its
    # value exact) and half the other's (killed mid-sweep); at the
    # crossover the same after a run without cutoffs, whose values set the
    # cutoffs; at L = 65536 one pair's run without cutoffs.
    al, bl, wl, cutl = long_recs["dtw_band_cuda"].args[:4]
    Pl, Ll = al.shape
    check(k5_form(Ll, wl) == "rows",
          f"the long path's rounds (L={Ll}, w={wl}) are not K5's form (a)")
    k5_round_cut = dtw_band_cuda(al, bl, wl, cutl, stream=True)
    plain_round_cut, plain_round_cut_ms = timed(
        lambda: ref.dtw_band_ref(al, bl, wl, cutl))
    err5 = compare("dtw_band_stream (largest long-path round, its cutoffs)",
                   k5_round_cut, plain_round_cut, exact=True)
    sa, sb, sc = long_recs["dtw_band_cuda"].sample
    err5 = max(err5, compare(
        "dtw_band_stream (long-path round pairs, cutoffs)",
        dtw_band_cuda(sa, sb, wl, sc, stream=True),
        ref.dtw_band_ref(sa, sb, wl, sc), exact=True))

    def spare_and_kill(L: int, label: str, forms, clusters=(),
                       plain_values: bool = False) -> dict:
        """Two pairs of length L, w = L: the default form's values (with
        ``plain_values``, held against a plain run without cutoffs, whose
        values then set the cutoffs), then one plain run with cutoffs that
        spare pair 0 and kill pair 1; every form in ``forms`` (and the
        cluster form in ``clusters`` blocks) with those cutoffs bit-equal
        to it, and with none bit-equal to the default form.  Returns the
        default form's and the plain version's ms and the largest
        difference."""
        xa, xb = randn(2, L), randn(2, L)
        got, ms = timed(lambda: dtw_band_cuda(xa, xb, L, stream=True))
        vals = got
        if plain_values:
            vals = ref.dtw_band_ref(xa, xb, L)
            compare(f"dtw_band_stream {label} (no cutoff)", got, vals,
                    exact=True)
        cut = torch.stack([vals[0] * 2, vals[1] * 0.5])
        want, plain_ms = timed(lambda: ref.dtw_band_ref(xa, xb, L, cut))
        check(bool(torch.isfinite(want[0])) and bool(torch.isposinf(want[1])),
              f"dtw_band_stream {label}: the cutoffs do not spare pair 0 and "
              "kill pair 1")
        err = compare(f"dtw_band_stream {label} (spared pair)", got[:1],
                      want[:1], exact=True)
        runs = [dict(form=f) for f in forms] + [dict(cluster=n)
                                                for n in clusters]
        for kw in runs:
            name = f"dtw_band_stream {label} {kw}"
            compare(f"{name} (cutoffs)", dtw_band_cuda(
                xa, xb, L, cut, stream=True, **kw), want, exact=True)
            compare(name, dtw_band_cuda(xa, xb, L, stream=True, **kw), got,
                    exact=True)
        return {"ms": ms, "plain_ms": plain_ms, "err": err}

    Lx = 14465                                      # wb = 14464, w = L
    check(dtw_band_route(Lx, Lx) == "stream"
          and dtw_band_route(Lx - 1, Lx - 1) == "resident",
          "the K4/K5 crossover is not at wb = 14463/14464")
    err5 = max(err5, spare_and_kill(Lx, "just over the crossover",
                                    K5_FORMS, plain_values=True)["err"])
    # the (a)/(b) edge: L = 20480 is the longest series form (a) holds
    check(k5_form(K5_ROWS_MAX_L, K5_ROWS_MAX_L) == "rows"
          and k5_form(K5_ROWS_MAX_L + 1, K5_ROWS_MAX_L + 1) == "cluster",
          f"the (a)/(b) edge is not at L = {K5_ROWS_MAX_L}")
    edge_a = spare_and_kill(K5_ROWS_MAX_L, f"at the (a)/(b) edge, "
                            f"L={K5_ROWS_MAX_L} (rows)", ("rows",))
    err5 = max(err5, edge_a["err"])
    Le = K5_ROWS_MAX_L + 1
    edge_b = spare_and_kill(Le, f"past the (a)/(b) edge, L={Le} (cluster)",
                            ("cluster", "scratch"), (3, 4, K5_MAX_CLUSTER))
    err5b = max(edge_b["err"], compare(
        "dtw_band_stream_cluster (largest long-path round, forced, cutoffs)",
        dtw_band_cuda(al, bl, wl, cutl, stream=True, form="cluster"),
        plain_round_cut, exact=True))
    edge = {f"L{K5_ROWS_MAX_L}_rows_two_pairs_ms": edge_a["ms"],
            f"L{Le}_cluster_two_pairs_ms": edge_b["ms"]}
    # L = 65536, w = L: 524 KB of band state, the cluster form's 3 blocks a
    # pair, timed on two pairs in 3, 4 and 8 blocks and in the scratch
    # form, each held against the plain version on pair 0
    L65 = 65536
    check(k5_form(L65, L65) == "cluster", "L = 65536 is not K5's form (b)")
    xa, xb = randn(2, L65), randn(2, L65)
    plain65, plain65_ms = timed(lambda: ref.dtw_band_ref(xa[:1], xb[:1],
                                                         L65))
    n65 = k5_cluster_size(L65, L65)
    by_blocks = {}
    for n in (n65, 4, K5_MAX_CLUSTER):
        got_n, by_blocks[n] = timed(lambda: dtw_band_cuda(
            xa, xb, L65, stream=True, cluster=n))
        err65 = compare(f"dtw_band_stream_cluster L=65536 w=L, {n} blocks "
                        "(pair 0)", got_n[:1], plain65, exact=True)
    k5_65536_ms = by_blocks[n65]
    got65s, scratch65_ms = timed(lambda: dtw_band_cuda(
        xa, xb, L65, stream=True, form="scratch"))
    compare("dtw_band_stream_scratch L=65536 w=L (pair 0)", got65s[:1],
            plain65, exact=True)
    compare(f"dtw_band_stream_scratch L=65536 w=L against the cluster "
            f"form's {K5_MAX_CLUSTER} blocks", got65s, got_n, exact=True)
    # the widest slices form (b) takes: wb = 231423 over 8 blocks of
    # K5_BLOCK_FLOATS floats (231,424 B each).  Every cell costs > 0, so
    # with a cutoff of 0 the plain version's first row-block check (R = 64)
    # abandons both pairs: +inf, without the plain sweep's 462,847
    # anti-diagonals.
    Lw = (K5_MAX_CLUSTER * K5_BLOCK_FLOATS) // 2
    check(k5_form(Lw, Lw) == "cluster" and k5_form(Lw + 1, Lw + 1)
          == "scratch" and k5_cluster_size(Lw, Lw) == K5_MAX_CLUSTER,
          f"wb = {Lw - 1} is not form (b)'s widest band")
    wa, wbb = randn(2, Lw), randn(2, Lw)
    got_w, widest_ms = timed(lambda: dtw_band_cuda(
        wa, wbb, Lw, torch.zeros(2, device=dev), row_block=64,
        stream=True))
    check(torch.isposinf(got_w).all().item(),
          f"dtw_band_stream_cluster L={Lw}: a pair over its cutoff of 0 at "
          "the first row-block check did not abandon")
    bms, by = bound(8.0 * Pl * Ll + 8.0 * Pl, 5.0 * band_cells(Ll, wl) * Pl)
    k5_ms = time_ms(lambda: dtw_band_cuda(al, bl, wl, stream=True), 3,
                    warmup=1)
    plain_note = ("the plain version's sweep of the round with its cutoffs "
                  "(it runs every anti-diagonal, with cutoffs or without)")
    out.append(dict(
        name="dtw_band_stream", route="cuda",
        source="src/repro_torch/csrc/dtw_band_stream.cu",
        replaces="src/repro/kernels/dtw_band.py:410",
        **path_launches("dtw_band_stream"), max_abs_err=err5,
        ms=k5_ms, plain_ms=plain_round_cut_ms, plain_shape=plain_note,
        bound_ms=bms, bound_by=by, library_ms=None,
        form="(a) rows: one block of 512 threads a pair, each thread's "
             "rows in registers, K anti-diagonals a step",
        shape=f"P={Pl} L={Ll} w={wl} no cutoff (the long path's largest "
              "round)",
        round_cutoffs_ms=time_ms(
            lambda: dtw_band_cuda(al, bl, wl, cutl, stream=True), 3,
            warmup=1),
        L65536_two_pairs_ms=k5_65536_ms, **edge))
    bms_e, by_e = bound(8.0 * 2 * Le + 8.0 * 2, 5.0 * band_cells(Le, Le) * 2)
    out.append(dict(
        name="dtw_band_stream_cluster", route="cuda",
        source="src/repro_torch/csrc/dtw_band_stream.cu",
        replaces="src/repro/kernels/dtw_band.py:410",
        **path_launches("dtw_band_stream_cluster"), max_abs_err=err5b,
        ms=edge_b["ms"], plain_ms=edge_b["plain_ms"], bound_ms=bms_e,
        bound_by=by_e, library_ms=None,
        form=f"(b) cluster: {k5_cluster_size(Le, Le)} blocks a pair past "
             f"the edge, {n65} at L = {L65}, the buffer in slices, the "
             "slice edges through distributed shared memory",
        shape=f"P=2 L={Le} w={Le} no cutoff (its plain run with cutoffs "
              "that spare one pair and kill the other)",
        # the one-buffer design on the round form (a) runs (2 blocks a
        # pair there), against which form (a) was chosen
        round_ms=time_ms(lambda: dtw_band_cuda(al, bl, wl, stream=True,
                                               form="cluster"), 1, warmup=0),
        round_shape=f"P={Pl} L={Ll} w={wl} no cutoff, "
                    f"{k5_cluster_size(Ll, wl)} blocks a pair",
        L65536_two_pairs_ms_by_blocks=by_blocks,
        L65536_two_pairs_scratch_ms=scratch65_ms,
        L65536_one_pair_plain_ms=plain65_ms, L65536_max_abs_err=err65,
        widest_shape=f"P=2 L={Lw} w={Lw}, {K5_MAX_CLUSTER} blocks of "
                     f"{4 * K5_BLOCK_FLOATS} B, cutoff 0, row_block 64",
        widest_abandon_ms=widest_ms))
    err5c = compare(
        "dtw_band_stream_scratch (largest long-path round, its cutoffs)",
        dtw_band_cuda(al, bl, wl, cutl, stream=True, form="scratch"),
        plain_round_cut, exact=True)
    out.append(dict(
        name="dtw_band_stream_scratch", route="cuda",
        source="src/repro_torch/csrc/dtw_band_stream.cu",
        replaces="src/repro/kernels/dtw_band.py:410",
        **path_launches("dtw_band_stream_scratch"), max_abs_err=err5c,
        ms=time_ms(lambda: dtw_band_cuda(al, bl, wl, stream=True,
                                         form="scratch"), 1, warmup=0),
        plain_ms=plain_round_cut_ms, plain_shape=plain_note, bound_ms=bms,
        bound_by=by, library_ms=None,
        form="(c) scratch: a persistent grid, band state in device "
             "memory (forced here; a path takes it past wb = 231423)",
        shape=f"P={Pl} L={Ll} w={wl} no cutoff (the long path's largest "
              f"round; grid {STREAM_BLOCKS_PER_SM} blocks per SM)"))

    # ---- K7 sketch bound (tier -1 of the sketch path) ---------------------
    # all Q = 256 sketch-path queries against the path's sketch store
    from repro_torch.search.index import (sketch_query_means,
                                          sketch_segment_sizes)

    sk_lo, sk_hi = sk_index.sk_lo, sk_index.sk_hi
    S = sk_lo.shape[1]
    qbar = sketch_query_means(torch.as_tensor(sk_queries, device=dev), S)
    qs, wseg = ref.sketch_operands(qbar, sk_index.sk_scale,
                                   sketch_segment_sizes(sk_index.length, S,
                                                        device=dev))
    Q, S = qs.shape
    N = sk_lo.shape[0]
    err = compare("sketch_bound", sketch_bound_cuda(qs, sk_lo, sk_hi, wseg),
                  ref.sketch_bound_scaled(qs, sk_lo, sk_hi, wseg),
                  exact=True)
    for Qs, Ns, Ss in [(3, 37, 16), (33, 200, 16), (5, 129, 7), (1, 1, 1),
                       (70, 65, 40), (2, 300, 256)]:
        qx = randn(Qs, Ss) * 60
        lx = torch.randint(-127, 100, (Ns, Ss), generator=gen,
                           dtype=torch.int8).to(dev)
        hx = torch.clamp(lx.int() + torch.randint(0, 40, (Ns, Ss),
                                                  generator=gen).to(dev),
                         max=127).to(torch.int8)
        wx = torch.rand(Ss, generator=gen).to(dev) * 0.3
        compare(f"sketch_bound sweep {(Qs, Ns, Ss)}",
                sketch_bound_cuda(qx, lx, hx, wx),
                ref.sketch_bound_scaled(qx, lx, hx, wx), exact=True)
    # full query tiles and a ragged one (Q = 257), on aligned int8 storage
    # and one byte off it (the byte path)
    for Ss in (7, 16, 256):
        qx = randn(257, Ss) * 60
        lx = torch.randint(-127, 100, (65541, Ss), generator=gen,
                           dtype=torch.int8).to(dev)
        hx = torch.clamp(lx.int() + torch.randint(0, 40, (65541, Ss),
                                                  generator=gen).to(dev),
                         max=127).to(torch.int8)
        wx = torch.rand(Ss, generator=gen).to(dev) * 0.3
        want = ref.sketch_bound_scaled(qx, lx, hx, wx)
        compare(f"sketch_bound sweep (257, 65541, {Ss})",
                sketch_bound_cuda(qx, lx, hx, wx), want, exact=True)
        off = [torch.empty(lx.numel() + 1, dtype=torch.int8,
                           device=dev)[1:].view(lx.shape) for _ in range(2)]
        off[0].copy_(lx)
        off[1].copy_(hx)
        compare(f"sketch_bound sweep (257, 65541, {Ss}) unaligned",
                sketch_bound_cuda(qx, off[0], off[1], wx), want, exact=True)
    # per (q, n, j): two subtracts, two maxes, two multiplies, one add
    bms, by = bound(4.0 * Q * S + 2.0 * N * S + 4.0 * S + 4.0 * Q * N,
                    7.0 * Q * N * S)
    # the same 7 instructions, none fused, at the FP32 issue rate: 128
    # lanes an SM a clock at the card's maximum SM clock
    props = torch.cuda.get_device_properties(dev)
    issue_ms = 7.0 * Q * N * S / (props.multi_processor_count * 128
                                  * max_sm_clock_hz()) * 1e3
    out.append(dict(
        name="sketch_bound", route="cuda",
        source="src/repro_torch/csrc/sketch.cu",
        replaces="src/repro/kernels/sketch.py:68",
        **path_launches("sketch_bound"), max_abs_err=err,
        ms=time_ms(lambda: sketch_bound_cuda(qs, sk_lo, sk_hi, wseg), 50),
        plain_ms=time_ms(lambda: ref.sketch_bound_scaled(qs, sk_lo, sk_hi,
                                                         wseg), 5),
        bound_ms=bms, bound_by=by, library_ms=None,
        issue_floor_ms=issue_ms,
        device_ms=device_ms(lambda: sketch_bound_cuda(qs, sk_lo, sk_hi, wseg),
                            "sketch_bound_kernel"),
        form="full query tiles: no predicates, the chunk's 16 weights in "
             "registers, the query tile read as float4; ragged tiles "
             "predicated",
        shape=f"Q={Q} N={N} S={S}", bit_equal_to_plain=True,
        **ptxas.get("sketch_bound", {})))

    # ---- K8 LB_Keogh (no search path; main-path envelopes) ----------------
    qk = torch.as_tensor(main_queries, dtype=torch.float32, device=dev)
    uk, lk = main_idx.upper, main_idx.lower
    Q, L = qk.shape
    C = uk.shape[0]
    err = compare("lb_keogh", lb_keogh_cuda(qk, uk, lk),
                  ref.lb_keogh_ref(qk, uk, lk), exact=False)
    # ragged against the 128 x 64 output tile and the 32-column chunks,
    # full interior tiles, L = 17984
    for Qs, Cs, Ls, ws in [(3, 37, 33, 8), (9, 70, 64, 1), (33, 31, 100, 0),
                           (2, 65, 9, 9), (40, 600, 512, 51),
                           (129, 65, 33, 4), (256, 128, 512, 51),
                           (5, 70, 17984, 179)]:
        qx, cx = randn(Qs, Ls), randn(Cs, Ls)
        ux, lx = ref.envelope_ref(cx, ws)
        compare(f"lb_keogh sweep {(Qs, Cs, Ls, ws)}",
                lb_keogh_cuda(qx, ux, lx), ref.lb_keogh_ref(qx, ux, lx),
                exact=False)
    # random walks of scale ~100, then envelopes with lo > u and +-inf
    # bounds (the chunks that hold them run the reference's arithmetic)
    odd_err = 0.0
    for Qs, Cs, Ls, ws in [(130, 70, 300, 10), (7, 200, 17984, 50)]:
        qx = torch.randn(Qs, Ls, generator=gen).cumsum(1).to(dev) * 10
        cx = torch.randn(Cs, Ls, generator=gen).cumsum(1).to(dev) * 10
        ux, lx = ref.envelope_ref(cx, ws)
        compare(f"lb_keogh random walks {(Qs, Cs, Ls, ws)}",
                lb_keogh_cuda(qx, ux, lx), ref.lb_keogh_ref(qx, ux, lx),
                exact=False)
        ux[3, 5] = lx[3, 5] - 25.0
        lx[4, 7:40] = ux[4, 7:40] + 1.0
        ux[5, 100:110] = float("inf")
        lx[6, :Ls // 2] = float("-inf")
        odd_err = max(odd_err, compare(
            f"lb_keogh lo > u and +-inf envelopes {(Qs, Cs, Ls, ws)}",
            lb_keogh_cuda(qx, ux, lx), ref.lb_keogh_ref(qx, ux, lx),
            exact=False))
    # the least work a term needs, the clamp form's: a max, a min, a
    # subtract and one fused multiply-add (two operations) that squares
    # the excess into the sum, 5 operations per (q, c, i)
    bms, by = bound(4.0 * Q * L + 8.0 * C * L + 4.0 * Q * C,
                    5.0 * Q * C * L)
    # the same 4 instructions a term at the FP32 issue rate: 128 lanes an
    # SM a clock at the card's maximum SM clock; the 67 TFLOP/s peak
    # counts an FMA as two operations, so it overstates this mix
    props = torch.cuda.get_device_properties(dev)
    issue_ms = 4.0 * Q * C * L / (props.multi_processor_count * 128
                                  * max_sm_clock_hz()) * 1e3
    out.append(dict(
        name="lb_keogh", route="cuda",
        source="src/repro_torch/csrc/lb_keogh.cu",
        replaces="src/repro/kernels/lb_keogh.py:48",
        **path_launches("lb_keogh"), max_abs_err=err,
        ms=time_ms(lambda: lb_keogh_cuda(qk, uk, lk), 50),
        plain_ms=time_ms(lambda: ref.lb_keogh_ref(qk, uk, lk), 3),
        bound_ms=bms, bound_by=by, library_ms=None,
        issue_floor_ms=issue_ms,
        form="clamp form d = q - min(max(q, lo), u), fma(d, d, acc); a "
             "chunk with !(lo <= u) runs the reference's arithmetic; 128 x "
             "64 output tiles, 8 x 4 a thread, 32-column chunks by cp.async",
        odd_envelopes_max_abs_err=odd_err,
        shape=f"Q={Q} C={C} L={L} w={main_idx.w}",
        **ptxas.get("lb_keogh", {})))
    return out


def lm_kernel_phases(torch, dev, windows, lm_recs, ptxas):
    """K9 and K10 against their plain versions at the LM phase's recorded
    inputs (timed) and over their sweeps; K9 also at the shapes its
    wrapper repairs (g > 64, bf16 head dims not a multiple of 8, bf16
    storage not 16-byte aligned).  Returns their ``kernels`` records;
    ``launches`` sums the LM requests' windows."""
    import torch.nn.functional as F

    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.flash_attention import (MAX_HEAD_DIM,
                                                     flash_attention_cuda)
    from repro_torch.kernels.mamba_scan import MAX_STATE, mamba_scan_cuda

    def path_launches(kname: str) -> dict:
        per = {f"{path}_path_launches": counts[kname]
               for path, counts in windows.items()}
        return dict(launches=sum(per.values()), **per)

    gen = torch.Generator(device="cpu").manual_seed(12)

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(dev)

    out = []

    # ---- K9 flash attention (gemma2-2b's scoring prefill) -----------------

    (ql, kl, vl, cl, wl9, capl), (qg, kg, vg, cg, wg9, capg) = \
        lm_recs["flash_attention"]
    check(wl9 is not None and wg9 is None,
          "the recorded K9 calls are not a local and a global layer")
    glob = k9_compare("flash_attention (path, global layer)",
                      flash_attention_cuda(qg, kg, vg, cg, wg9, capg),
                      ref.flash_attention_ref(qg, kg, vg, cg, wg9, capg))
    loc = k9_compare("flash_attention (path, local layer)",
                     flash_attention_cuda(ql, kl, vl, cl, wl9, capl),
                     ref.flash_attention_ref(ql, kl, vl, cl, wl9, capl))
    nocap = k9_compare("flash_attention (path, global layer, no cap)",
                       flash_attention_cuda(qg, kg, vg, cg, wg9, None),
                       ref.flash_attention_ref(qg, kg, vg, cg, wg9, None))
    # the sweep in its own type, and every shape in bf16 (the tensor-core
    # form)
    err_sweep = {"float32": 0.0, "bfloat16": 0.0}
    rel_sweep = 0.0
    for (Bs, Sq, Skv, Hq, Hkv, D, causal, win, cap, dt) in FLASH_SWEEP:
        q32 = randn(Bs, Sq, Hq, D)
        k32, v32 = randn(Bs, Skv, Hkv, D), randn(Bs, Skv, Hkv, D)
        for dts in sorted({dt, "bfloat16"}):
            qs, ks, vs = (x.to(getattr(torch, dts)) for x in (q32, k32, v32))
            r = k9_compare(
                f"flash_attention sweep {(Bs, Sq, Skv, Hq, Hkv, D)} {dts}",
                flash_attention_cuda(qs, ks, vs, causal, win, cap),
                ref.flash_attention_ref(qs, ks, vs, causal, win, cap))
            err_sweep[dts] = max(err_sweep[dts], r["max_abs_err"])
            if dts == "bfloat16":
                rel_sweep = max(rel_sweep, r["rel_rms_err"])
    # what the wrapper repairs: g = 96 (two launches of 48 heads of each
    # group, f32 and bf16), bf16 D = 100 (padded to 104), bf16 storage
    # 2 bytes past alignment (an aligned copy)
    repaired = {}
    for label, (Hq, Hkv, D, dts, skew) in {
            "g96_f32": (192, 2, 64, "float32", False),
            "g96_bf16": (192, 2, 64, "bfloat16", False),
            "d100_bf16": (8, 4, 100, "bfloat16", False),
            "unaligned_bf16": (8, 4, 128, "bfloat16", True)}.items():
        xs = []
        for H in (Hq, Hkv, Hkv):
            n = 2 * 77 * H * D
            flat = randn(n + 1).to(getattr(torch, dts))
            xs.append((flat[1:] if skew else flat[:n]).view(2, 77, H, D))
        check(all(bool(x.data_ptr() % 16) == skew for x in xs),
              f"K9 repaired shape {label}: alignment not as intended")
        _build.reset_counts()
        got9 = flash_attention_cuda(*xs, True, 32, 50.0)
        name9 = "flash_attention_f32" if dts == "float32" else \
            "flash_attention"
        check(_build.counts()[name9] == (2 if Hq // Hkv > 64 else 1),
              f"K9 repaired shape {label}: {_build.counts()[name9]} "
              f"launches of {name9}")
        r = k9_compare(f"flash_attention repaired {label}", got9,
                       ref.flash_attention_ref(*xs, True, 32, 50.0))
        repaired[label] = r["max_abs_err"] if dts == "float32" else \
            r["rel_rms_err"]

    bms, by = k9_bound(qg, kg, cg, wg9)
    qt, kt, vt = (x.transpose(1, 2) for x in (qg, kg, vg))
    # SDPA's yardstick for the local layer: a boolean mask of the causal
    # wedge and the window (SDPA has no window argument, and no cap)
    qlt, klt, vlt = (x.transpose(1, 2) for x in (ql, kl, vl))
    pos = torch.arange(ql.shape[1], device=dev)
    dpos = pos[:, None] - pos[None, :]
    local_mask = (dpos >= 0) & (dpos < wl9)
    local_library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qlt, klt, vlt, attn_mask=local_mask, enable_gqa=True), 5)
    del local_mask
    out.append(dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:119",
        **path_launches("flash_attention"),
        max_abs_err=max(glob["max_abs_err"], loc["max_abs_err"]),
        ms=time_ms(lambda: flash_attention_cuda(qg, kg, vg, cg, wg9, capg),
                   5),
        plain_ms=time_ms(lambda: ref.flash_attention_ref(qg, kg, vg, cg,
                                                         wg9, capg), 3,
                         warmup=1),
        bound_ms=bms, bound_by=by,
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), 5),
        shape=f"B={qg.shape[0]} S={qg.shape[1]} Hq={qg.shape[2]} "
              f"Hkv={kg.shape[2]} D={qg.shape[3]} {qg.dtype} causal "
              f"cap={capg} (a global layer)",
        bound_peak="bf16 dense tensor 989 TFLOP/s, HBM 3.35 TB/s",
        library_call="F.scaled_dot_product_attention(is_causal=True, "
                     "enable_gqa=True) at the same inputs without the cap "
                     "(SDPA has no soft cap)",
        nocap_ms=time_ms(lambda: flash_attention_cuda(qg, kg, vg, cg, wg9,
                                                      None), 5),
        ref_rms=glob["ref_rms"], ref_mean_abs=glob["ref_mean_abs"],
        rel_rms_err=glob["rel_rms_err"],
        nocap_max_abs_err=nocap["max_abs_err"],
        nocap_rel_rms_err=nocap["rel_rms_err"],
        local_layer_shape=f"window={wl9} cap={capl}",
        local_layer_max_abs_err=loc["max_abs_err"],
        local_layer_ref_rms=loc["ref_rms"],
        local_layer_ref_mean_abs=loc["ref_mean_abs"],
        local_layer_rel_rms_err=loc["rel_rms_err"],
        local_layer_ms=time_ms(
            lambda: flash_attention_cuda(ql, kl, vl, cl, wl9, capl), 5),
        local_layer_bound_ms=k9_bound(ql, kl, cl, wl9)[0],
        local_layer_library_ms=local_library_ms,
        local_layer_library_call="F.scaled_dot_product_attention("
                                 "attn_mask=causal & window, enable_gqa="
                                 "True) at the same inputs without the cap",
        sweep_max_abs_err_bf16=err_sweep["bfloat16"],
        sweep_max_rel_rms_err_bf16=rel_sweep,
        form="bf16: tensor cores (wgmma), K/V by TMA", tol=K9_TOL,
        bf16_rel_rms_tol=K9_BF16_REL_RMS,
        repaired_shapes_err={k: v for k, v in repaired.items()
                             if k.endswith("bf16")},
        repaired_shapes_err_kind="bf16: relative RMS error"))
    # K9's f32 form (CUDA cores) at the global layer's inputs in f32: the
    # f32 checks of the LM phase run it
    qf, kf, vf = (x.float() for x in (qg, kg, vg))
    err32 = k9_compare("flash_attention_f32 (global layer inputs in f32)",
                       flash_attention_cuda(qf, kf, vf, cg, wg9, capg),
                       ref.flash_attention_ref(qf, kf, vf, cg, wg9,
                                               capg))["max_abs_err"]
    B9, Sq9, Hq9, D9 = qf.shape
    bms32, by32 = bound((2 * qf.numel() + 2 * kf.numel()) * 4,
                        4.0 * B9 * Hq9 * D9 * attn_pairs(Sq9, kf.shape[1],
                                                         cg, wg9))
    qft, kft, vft = (x.transpose(1, 2) for x in (qf, kf, vf))
    out.append(dict(
        name="flash_attention_f32", route="cuda",
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:119",
        **path_launches("flash_attention_f32"),
        max_abs_err=max(err32, err_sweep["float32"]),
        ms=time_ms(lambda: flash_attention_cuda(qf, kf, vf, cg, wg9, capg),
                   5, warmup=1),
        plain_ms=time_ms(lambda: ref.flash_attention_ref(qf, kf, vf, cg,
                                                         wg9, capg), 2,
                         warmup=1),
        bound_ms=bms32, bound_by=by32,
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qft, kft, vft, is_causal=True, enable_gqa=True), 5, warmup=1),
        library_call="F.scaled_dot_product_attention(is_causal=True, "
                     "enable_gqa=True) at the same f32 inputs without the "
                     "cap (SDPA has no soft cap)",
        nocap_ms=time_ms(lambda: flash_attention_cuda(qf, kf, vf, cg, wg9,
                                                      None), 5, warmup=1),
        form="f32 arithmetic on CUDA cores: one cluster of ceil(D / 128) "
             "blocks split along D (2 at D = 256), each row's softmax on "
             "its owning block", repaired_g96_max_abs_err=repaired["g96_f32"],
        shape=f"the global layer's inputs in f32, cap={capg}",
        bound_peak="FP32 non-tensor 67 TFLOP/s, HBM 3.35 TB/s",
        **ptxas.get("flash_attention_f32", {})))
    del qft, kft, vft
    del qf, kf, vf

    # ---- K9 at the MoE and audio requests' layers ------------------------
    # qwen2-moe-a2.7b's attention (MHA, D = 128, causal, no cap) and
    # hubert-xlarge's (MHA, D = 80, non-causal), layer 0 of each scoring
    # prefill, in bf16, beside SDPA on the same inputs
    def k9_row(label, args, what):
        q9, k9_, v9, c9, w9, cap9 = args
        r = k9_compare(f"flash_attention ({label})",
                       flash_attention_cuda(*args), ref.flash_attention_ref(
                           *args))
        bms9, by9 = k9_bound(q9, k9_, c9, w9)
        qt9, kt9, vt9 = (x.transpose(1, 2) for x in (q9, k9_, v9))
        return dict(
            name=f"flash_attention_{label}", route="cuda",
            source="src/repro_torch/csrc/flash_attention.cu",
            replaces="src/repro/kernels/flash_attention.py:119",
            count="flash_attention", **path_launches("flash_attention"),
            max_abs_err=r["max_abs_err"],
            ms=time_ms(lambda: flash_attention_cuda(*args), 5),
            plain_ms=time_ms(lambda: ref.flash_attention_ref(*args), 3,
                             warmup=1),
            bound_ms=bms9, bound_by=by9,
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                qt9, kt9, vt9, is_causal=c9), 5),
            library_call=f"F.scaled_dot_product_attention(is_causal={c9}) "
                         "at the same inputs",
            ref_rms=r["ref_rms"], rel_rms_err=r["rel_rms_err"],
            shape=f"B={q9.shape[0]} S={q9.shape[1]} Hq={q9.shape[2]} "
                  f"Hkv={k9_.shape[2]} D={q9.shape[3]} {q9.dtype} "
                  f"{'causal' if c9 else 'non-causal'} window={w9} "
                  f"cap={cap9} ({what})",
            form="bf16: tensor cores (wgmma), K/V by TMA",
            bound_peak="bf16 dense tensor 989 TFLOP/s, HBM 3.35 TB/s",
            tol=K9_TOL, bf16_rel_rms_tol=K9_BF16_REL_RMS)

    out.append(k9_row("moe_qwen", lm_recs["moe-qwen"],
                      "qwen2-moe-a2.7b layer 0, scoring prefill"))
    out.append(k9_row("hubert", lm_recs["audio-hubert"],
                      "hubert-xlarge layer 0, prefill of 2 x 8192 frames"))

    # ---- K9's f32-arithmetic form past D = 256 (f32 or bf16 inputs) ------
    # No configuration reaches D > 256 (gemma2-2b's d_head 256 is the
    # largest): a causal prefill of gemma2-2b's geometry otherwise (B = 1,
    # Hq = 8, Hkv = 4) at S = 2048 with D = 320 and 512 in both types with
    # the cap, and in f32 without it, the function SDPA also computes, at
    # D = 512 (S = 2048) and D = 1100 and 2048 (S = 1024)
    def f32_run(xs, causal, win, cap, label):
        """One call, which must be one launch of the f32-arithmetic form,
        and its check against the plain version."""
        _build.reset_counts()
        got9 = flash_attention_cuda(*xs, causal, win, cap)
        got_counts = {k: v for k, v in _build.counts().items() if v}
        check(got_counts == {"flash_attention_f32": 1},
              f"K9 {label}: launches {got_counts}, expected one of "
              "flash_attention_f32")
        return k9_compare(f"flash_attention_f32 {label}", got9,
                          ref.flash_attention_ref(*xs, causal, win, cap))

    wide_err = {}
    wide_ms = {}
    for Dw in (320, 512):
        xw = [randn(1, 2048, H, Dw) for H in (8, 4, 4)]
        for dts in ("float32", "bfloat16"):
            xs = [x.to(getattr(torch, dts)) for x in xw]
            r = f32_run(xs, True, None, 50.0, f"D={Dw} {dts}")
            wide_err[f"D{Dw}_{dts}"] = r["max_abs_err"] \
                if dts == "float32" else r["rel_rms_err"]
            wide_ms[f"D{Dw}_{dts}"] = time_ms(
                lambda: flash_attention_cuda(*xs, True, None, 50.0), 3,
                warmup=1)
    # a sweep: ragged and unequal Sq / Skv, g in {1, 2, 8}, causal and not,
    # window, cap; f32 at D <= 256 (clusters of 1 and 2 blocks), f32 and
    # bf16 past it (one cluster up to D = 2048, 16 blocks; column groups
    # past it: D = 4100 in 3 groups of 11 blocks)
    f32_sweep = {"float32": 0.0, "bfloat16": 0.0}
    for (Bs, Sq, Skv, Hq, Hkv, D, causal, win, cap) in [
            (2, 40, 40, 2, 2, 64, True, None, None),
            (1, 77, 77, 8, 4, 96, True, 16, 30.0),
            (1, 100, 70, 8, 1, 200, False, None, 50.0),
            (2, 65, 65, 16, 2, 256, True, None, 50.0),
            (2, 40, 40, 2, 2, 257, True, None, None),
            (1, 77, 77, 8, 4, 320, True, 16, 30.0),
            (1, 100, 70, 8, 1, 512, False, None, 50.0),
            (1, 33, 90, 2, 1, 1024, False, 20, None),
            (2, 65, 65, 16, 2, 320, True, None, 50.0),
            (1, 30, 45, 2, 1, 1100, True, 20, 50.0),
            (1, 30, 45, 2, 1, 2048, True, 20, 50.0),
            (1, 40, 40, 4, 2, 4100, True, None, None)]:
        xw = [randn(Bs, Sq, Hq, D), randn(Bs, Skv, Hkv, D),
              randn(Bs, Skv, Hkv, D)]
        for dts in ("float32", "bfloat16")[:1 if D <= MAX_HEAD_DIM else 2]:
            xs = [x.to(getattr(torch, dts)) for x in xw]
            r = f32_run(xs, causal, win, cap,
                        f"sweep {(Bs, Sq, Skv, Hq, Hkv, D)} {dts}")
            key = "max_abs_err" if dts == "float32" else "rel_rms_err"
            f32_sweep[dts] = max(f32_sweep[dts], r[key])

    def f32_row(D, S, reps, extra):
        """The f32 form at B = 1, Hq = 8, Hkv = 4, head dim D, causal, no
        cap, against the plain version, SDPA beside it."""
        qw, kw_, vw = randn(1, S, 8, D), randn(1, S, 4, D), randn(1, S, 4, D)
        errw = f32_run([qw, kw_, vw], True, None, None,
                       f"D={D} S={S} float32 no cap")
        bmsw, byw = bound((2 * qw.numel() + 2 * kw_.numel()) * 4,
                          4.0 * 8 * D * attn_pairs(S, S, True, None))
        qwt, kwt, vwt = (x.transpose(1, 2) for x in (qw, kw_, vw))
        n_ch = -(-D // 128)
        n_g = -(-n_ch // 16)
        return dict(
            name=f"flash_attention_f32_d{D}", route="cuda",
            source="src/repro_torch/csrc/flash_attention.cu",
            replaces="src/repro/kernels/flash_attention.py:119",
            count="flash_attention_f32",
            **path_launches("flash_attention_f32"),
            max_abs_err=errw["max_abs_err"],
            ms=time_ms(lambda: flash_attention_cuda(qw, kw_, vw, True),
                       reps, warmup=1),
            plain_ms=time_ms(lambda: ref.flash_attention_ref(qw, kw_, vw,
                                                             True),
                             3, warmup=1),
            bound_ms=bmsw, bound_by=byw,
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                qwt, kwt, vwt, is_causal=True, enable_gqa=True), reps,
                warmup=1),
            library_call="F.scaled_dot_product_attention(is_causal=True, "
                         "enable_gqa=True) at the same inputs",
            form=f"f32 arithmetic on CUDA cores: {n_g} group(s) of "
                 f"{-(-n_ch // n_g)} blocks a cluster over {n_ch} chunks "
                 "of 128 columns",
            shape=f"B=1 S={S} Hq=8 Hkv=4 D={D} float32 causal, no cap",
            bound_peak="FP32 non-tensor 67 TFLOP/s, HBM 3.35 TB/s",
            tol=K9_TOL, **extra)

    out.append(f32_row(512, 2048, 5, dict(
        cap50_ms=wide_ms, cap50_err=wide_err,
        cap50_err_kind="f32: max abs error; bf16: relative RMS error",
        sweep_max_abs_err_f32=f32_sweep["float32"],
        sweep_max_rel_rms_err_bf16=f32_sweep["bfloat16"],
        bf16_rel_rms_tol=K9_BF16_REL_RMS)))
    out.append(f32_row(1100, 1024, 5, {}))
    out.append(f32_row(2048, 1024, 5, {}))

    # ---- K10 selective scan (falcon-mamba-7b's prefill) -------------------
    args = lm_recs["mamba_scan"]
    delta = args[0]
    Bs, S, C = delta.shape
    N = args[2].shape[1]
    err = compare("mamba_scan (path)", mamba_scan_cuda(*args),
                  ref.mamba_scan_ref(*args), exact=True)
    for (Bs_, S_, C_, N_) in MAMBA_SWEEP:
        sw = (torch.rand(Bs_, S_, C_, generator=gen).to(dev) * 0.1,
              randn(Bs_, S_, C_),
              -torch.rand(C_, N_, generator=gen).to(dev) * 3,
              randn(Bs_, S_, N_), randn(Bs_, S_, N_), randn(Bs_, C_, N_))
        compare(f"mamba_scan sweep {(Bs_, S_, C_, N_)}", mamba_scan_cuda(*sw),
                ref.mamba_scan_ref(*sw), exact=True)
    bms, by = scan_bound(Bs, S, C, N)
    # the SFU's share: one ex2 per (b, t, c, n) at 16 a clock per SM, at
    # the card's maximum SM clock (not counted in the bound)
    props = torch.cuda.get_device_properties(dev)
    sfu_ms = Bs * S * C * N / (props.multi_processor_count * 16
                               * max_sm_clock_hz()) * 1e3
    out.append(dict(
        name="mamba_scan", route="cuda",
        source="src/repro_torch/csrc/mamba_scan.cu",
        replaces="src/repro/kernels/mamba_scan.py:89",
        **path_launches("mamba_scan"), max_abs_err=err,
        ms=time_ms(lambda: mamba_scan_cuda(*args), 10),
        plain_ms=time_ms(lambda: ref.mamba_scan_ref(*args), 2, warmup=1),
        bound_ms=bms, bound_by=by, library_ms=None,
        sfu_floor_ms=sfu_ms,
        form="states across lanes: a group of G lanes a channel, 8 states "
             "a lane, the running sum passed down the skewed group by a "
             "shuffle, chunks copied in by cp.async",
        shape=f"B={Bs} S={S} C={C} N={N} f32 (a layer of the falcon "
              f"prefill)", bit_equal_to_plain=True,
        sweep_states=sorted({sw[3] for sw in MAMBA_SWEEP}),
        **ptxas.get("mamba_scan", {})))

    # ---- K10's wide-state form (N > 256; no configuration reaches it) ----
    def scan_inputs(Bs_, S_, C_, N_):
        return (torch.rand(Bs_, S_, C_, generator=gen).to(dev) * 0.1,
                randn(Bs_, S_, C_),
                -torch.rand(C_, N_, generator=gen).to(dev) * 3,
                randn(Bs_, S_, N_), randn(Bs_, S_, N_), randn(Bs_, C_, N_))

    def wide_scan(sw, label):
        _build.reset_counts()
        got = mamba_scan_cuda(*sw)
        got_counts = {k: v for k, v in _build.counts().items() if v}
        check(got_counts == {"mamba_scan_wide": 1},
              f"mamba_scan {label}: launches {got_counts}, expected one of "
              "mamba_scan_wide")
        return got

    for (Bs_, S_, C_, N_) in MAMBA_WIDE_SWEEP:
        sw = scan_inputs(Bs_, S_, C_, N_)
        compare(f"mamba_scan_wide sweep {(Bs_, S_, C_, N_)}",
                wide_scan(sw, f"sweep {(Bs_, S_, C_, N_)}"),
                ref.mamba_scan_ref(*sw), exact=True)
    # falcon-mamba-7b's prefill shape with 512 states: one plain run gives
    # both the check and the plain time
    Bw, Sw, Cw, Nw = 4, 2048, 8192, 2 * MAX_STATE
    sw = scan_inputs(Bw, Sw, Cw, Nw)
    got = wide_scan(sw, f"B={Bw} S={Sw} C={Cw} N={Nw}")
    want, plain_ms = timed(lambda: ref.mamba_scan_ref(*sw))
    errw = compare(f"mamba_scan_wide B={Bw} S={Sw} C={Cw} N={Nw}", got,
                   want, exact=True)
    del got, want
    bmsw, byw = scan_bound(Bw, Sw, Cw, Nw)
    out.append(dict(
        name="mamba_scan_wide", route="cuda",
        source="src/repro_torch/csrc/mamba_scan.cu",
        replaces="src/repro/kernels/mamba_scan.py:89",
        **path_launches("mamba_scan_wide"), max_abs_err=errw,
        ms=time_ms(lambda: mamba_scan_cuda(*sw), 3, warmup=1),
        plain_ms=plain_ms, bound_ms=bmsw, bound_by=byw, library_ms=None,
        sfu_floor_ms=Bw * Sw * Cw * Nw / (props.multi_processor_count * 16
                                          * max_sm_clock_hz()) * 1e3,
        form="N > 256: the lanes form at G = 32 in ceil(N / 256) passes "
             "over the sequence in one launch, each step's sum carried "
             "from pass to pass through y",
        shape=f"B={Bw} S={Sw} C={Cw} N={Nw} f32 (falcon-mamba-7b's "
              "prefill shape with 512 states)", bit_equal_to_plain=True,
        sweep_states=sorted({sw_[3] for sw_ in MAMBA_WIDE_SWEEP}),
        **ptxas.get("mamba_scan_wide", {})))
    del sw
    return out


def main() -> int:
    # the shapes phase and train-moe hold ~90 % of the card in tensors of
    # many sizes: with fixed segments the caching allocator's free pieces
    # left a 7.3 GiB request unserved beside 13.9 GiB reserved and unused
    # (gemma2-2b prefill_32k at B = 13); segments that grow in place keep
    # what is reserved near what is allocated
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port package is missing ({e}); run from "
              "the repository root", file=sys.stderr)
        return 1
    import torch.distributed as dist

    phases = {}
    sizing = None

    def phase(name: str) -> None:
        phases[name] = round(time.perf_counter() - t_start, 1)

    profile = "--profile" in sys.argv[1:]
    lm_only = "--lm-only" in sys.argv[1:]
    shapes_only = "--shapes-only" in sys.argv[1:]
    paper_tmp = Path(tempfile.mkdtemp(prefix="paper_data_"))
    paper_proc = (None if lm_only or shapes_only
                  else start_paper_data(paper_tmp))
    try:
        line = card_line()
        print(line)
        name = torch.cuda.get_device_name(0)
        print(f"device: {name} (torch {torch.__version__}, CUDA "
              f"{torch.version.cuda})")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        from repro_torch.kernels import _build

        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            procs = ptxas_start(Path(tmp))
            lib_path = _build.build()
            _build.library()
            ptxas = ptxas_report(procs)
        print(f"kernels built in {time.perf_counter() - t0:.1f} s: "
              f"{lib_path.name}")
        ptxas = occupancy_report(ptxas)
        print("ptxas: " + json.dumps(ptxas))
        phase("build")
        dev = torch.device("cuda:0")
        if lm_only:
            run_lm_phase(torch, dev, profile)
            phase("lm phase")
            run_lm_families(torch, dev, profile)
            phase("lm families")
            print("phase seconds (cumulative): " + json.dumps(phases))
            print("chip_smoke --lm-only: every LM request passed its checks")
            return 0
        if shapes_only:
            sizing = start_sizing(torch)
            run_train_path(torch, dev, profile, labels=SIZING_TASKS[:1],
                           sizing=sizing)
            phase("train-moe")
            run_shapes_phase(torch, dev, profile, sizing)
            phase("shapes")
            print("phase seconds (cumulative): " + json.dumps(phases))
            print("chip_smoke --shapes-only: every shape cell passed its "
                  "checks")
            return 0
        ds, index, cfg, res, launches, recs = run_main_path(torch, dev)
        for kname in ("envelope", "lb_enhanced", "lb_enhanced_pairwise",
                      "dtw_band"):
            check(launches[kname] > 0,
                  f"kernel {kname} was not launched on the main path")
        check(launches["dtw_band_block"] == 0, "main path: K4 ran its block "
              "form at w = 51, where k4_form picks the warp form")
        check_search(torch, ds, index, cfg, res)
        phase("main path")
        sk_ds, sk_index, sk_cfg, sk_launches = run_sketch_path(torch, dev)
        phase("sketch path")
        guard_phase(torch, ds, index, cfg, dev)
        lg_ds, lg_index, lg_cfg, lg_recs, lg_launches = run_long_path(
            torch, dev)
        phase("long path")
        # --profile: each path's warm search, profiled after the kernel
        # phases' last device_ms (a profile of a whole search before them
        # left their short profiler sessions seeing no kernel)
        profiles = [(ds, index, cfg, "main path"),
                    (sk_ds, sk_index, sk_cfg, "sketch path"),
                    (lg_ds, lg_index, lg_cfg, "long path")] \
            if profile else None
        wd_launches, wd_recs = run_wide_path(
            torch, dev, {"main": ds, "long": lg_ds}, profiles)
        phase("wide path")
        dn_launches, dn_recs, dn_res = run_dense_path(
            torch, dev, {"main": ds, "sketch": sk_ds}, sk_cfg, profiles)
        phase("dense path")
        windows = {"main": launches, "sketch": sk_launches,
                   "long": lg_launches, "wide": wd_launches,
                   "dense": dn_launches}
        for path, counts in windows.items():
            if path != "dense":
                check(counts["lb_enhanced_full"] == 0, f"{path} path: K2's "
                      "full form ran outside the dense path")
        kernels = kernel_phases(torch, dev, recs, windows, sk_index,
                                sk_ds.x_test, index, ds.x_test, lg_recs,
                                wd_recs, dn_recs, ptxas)
        phase("kernel phases")
        if profile:
            for args in profiles:
                profile_search(torch, *args)
            del profiles, args
            phase("search profiles")
        # the LM phase needs the card's memory: falcon-mamba-7b's f32
        # weights and bf16 copy are 43.6 GB
        main_ds = ds
        del ds, index, res, recs, lg_ds, lg_index, lg_recs, wd_recs, dn_recs
        gc.collect()
        torch.cuda.empty_cache()
        # the train-moe and shapes cells' sizing, on the host beside the
        # LM and train phases: what is resident now is what those cells
        # will find (each phase frees what it draws)
        sizing = start_sizing(torch)
        readings = {}
        lm_windows, lm_recs = run_lm_phase(torch, dev, profile, readings)
        phase("lm phase")
        fam_windows, fam_recs = run_lm_families(torch, dev, profile)
        lm_windows.update(fam_windows)
        lm_recs.update(fam_recs)
        del fam_recs
        phase("lm families")
        kernels += lm_kernel_phases(torch, dev, lm_windows, lm_recs,
                                    ptxas)
        del lm_recs
        gc.collect()
        torch.cuda.empty_cache()
        phase("lm kernels")
        tr_launches, tr_warm = run_train_path(torch, dev, profile, readings,
                                              sizing=sizing)
        for rec in kernels:
            if rec["name"] in LM_KERNELS:
                rec["train_path_launches"] = tr_launches[rec["name"]]
                rec["launches"] += tr_launches[rec["name"]]
        check(sum(tr_launches[k] for k in tr_launches
                  if k not in LM_KERNELS) == 0,
              f"train path: a search kernel launched: {tr_launches}")
        phase("train path")
        # before init_world: the dry-run's fake world is the process's
        # default group while it lasts
        run_dryrun_phase(torch, readings)
        phase("dryrun")
        gc.collect()
        torch.cuda.empty_cache()
        sp_launches, sp_recs = run_shapes_phase(torch, dev, profile, sizing)
        sizing["pool"].shutdown()
        sizing = None
        for rec in kernels:
            if rec["name"] in LM_KERNELS:
                rec["shapes_path_launches"] = sp_launches[rec["name"]]
                rec["launches"] += sp_launches[rec["name"]]
                if rec["name"] in sp_recs:
                    rec["shapes"] = sp_recs[rec["name"]]
        check(sum(sp_launches[k] for k in sp_launches
                  if k not in LM_KERNELS) == 0,
              f"shapes phase: a search kernel launched: {sp_launches}")
        del sp_recs
        phase("shapes")
        # the distributed paths come after every device_ms measurement:
        # a short profiler session after the paper path saw no kernel
        # (four calls on the H100 machine, with the sessions primed and
        # retried); a long one, the paper path's profile, still did
        init_world(torch)
        sh_launches, sh_recs = run_sharded_lm(torch, dev, tr_warm)
        for rec in kernels:
            if rec["name"] in LM_KERNELS:
                rec["sharded_lm_path_launches"] = sh_launches[rec["name"]]
                rec["launches"] += sh_launches[rec["name"]]
                if rec["name"] in sh_recs:
                    rec["local_shards"] = sh_recs[rec["name"]]
        check(sum(sh_launches[k] for k in sh_launches
                  if k not in LM_KERNELS) == 0,
              f"sharded lm: a search kernel launched: {sh_launches}")
        del sh_recs
        phase("sharded lm")
        pp_data = paper_data(paper_proc, paper_tmp)
        pp_launches, pp_recs = run_paper_path(torch, dev, pp_data)
        phase("paper path")
        dt_launches = run_dist_sketch_path(torch, sk_ds, sk_index, sk_cfg)
        check(dt_launches["lb_enhanced_full"] == 0, "dist sketch path: K2's "
              "full form ran outside the dense path")
        del sk_ds, sk_index
        phase("dist sketch path")
        dd_launches = run_dense_dist(torch, dev, main_ds, dn_res)
        del main_ds, dn_res
        phase("dense-dist")
        pkeys = paper_kernel_keys(torch, pp_recs)
        del pp_recs
        search_names = {rec["name"] for rec in kernels
                        if "main_path_launches" in rec}
        for rec in kernels:
            if rec["name"] in search_names:
                cname = rec.get("count", rec["name"])
                for path, counts in (("paper", pp_launches),
                                     ("dist", dt_launches)):
                    n = counts[cname]
                    rec[f"{path}_path_launches"] = n
                    rec["launches"] += n
                # dense-dist is a case of the dense path
                rec["dense_path_launches"] += dd_launches[cname]
                rec["launches"] += dd_launches[cname]
            rec.update(pkeys.get(rec["name"], {}))
        gc.collect()
        torch.cuda.empty_cache()
        phase("paper kernel keys")
        run_examples(torch)
        phase("examples")
        if profile:
            profile_paper_path(torch, dev, pp_data[0])
            phase("paper path profile")
        del pp_data
        torch.cuda.synchronize()
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        if sizing is not None:
            sizing["pool"].shutdown(cancel_futures=True)
        if paper_proc is not None:
            if paper_proc.poll() is None:
                paper_proc.kill()
            paper_proc.wait()
        shutil.rmtree(paper_tmp, ignore_errors=True)
        if dist.is_initialized():
            dist.destroy_process_group()
    print("phase seconds (cumulative): " + json.dumps(phases))
    print(f"chip_smoke wall seconds: {time.perf_counter() - t_start:.1f}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
