#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA card: the quickest proof that the port builds and serves.

    python3 chip_smoke.py

Phases (each prints its own line; any failure raises and exits non-zero):

1. the card's name and power limit (``nvidia-smi``);
2. build every CUDA kernel from ``src/repro_torch/kernels/*/csrc`` (one
   ``nvcc`` per source, all at once) and print the build seconds, the
   registers ``ptxas`` reports, the chunk kernel's shared memory and
   resident CTAs per SM (at least 2 required at D 128, 1 at gemma3's D
   256), the decode kernels' (G 4, D 128) and the SSD kernel's
   (mamba2-370m's L 128, N 128, P 64, with the heads per CTA its rule
   picks);
3. hold each kernel against its plain PyTorch version on the card at the
   main path's shapes, in fp32 (tolerance 3e-5, the reference's) and
   bf16 (3e-2), and time kernel, plain version and, where one exists,
   one PyTorch library call (``scaled_dot_product_attention`` with the
   same boolean mask, a yardstick only) with CUDA events; compute each
   kernel's bound from the bytes and operations these inputs need (the
   chunk kernel's fp32 products as 3xTF32 at the TF32 rate, the CUDA-core
   figure beside it). Two chunk launches on the same inputs must give the
   same bytes, and so must two launches of each decode kernel. The chunk
   and decode kernels are held and timed again at gemma3-4b's shapes (D
   256, G 2, the 1024-key window; chunk A 512 x S 2048, decode B 4 x S
   2048, paged NBmax 128). The chunk
   kernel is measured again after engine A, on the recorded inputs of
   A's most frequent ``(B, A, S)``, and timed at each number of key
   ranges at the table's shape and every shape A launched, beside the
   count ``num_splits`` picks (``sweep_chunk_splits``); the decode
   kernels likewise on the recorded inputs of A's most frequent ``(B,
   S)`` and B's most frequent ``(B, NBmax, bs)`` (``DecodeRecorder``,
   ``sweep_decode_splits``). The SSD kernel is held at mamba2-370m's
   prefill shape (worst ratio to the allclose bound printed, two launches
   byte for byte, events and device time, its bound on the route it takes
   with the CUDA-core figure beside it) and timed at every number of
   heads per CTA beside the rule's pick, each count giving the same bytes
   (``sweep_ssd_heads``). RoPE
   is held at two shapes (K of one chunk over all layers, a 1024-token
   span), applying and removing, with one whole-stack call equal to one
   call per layer byte for byte and remove o apply within 2e-5 of x;
4. mamba2: full-width mamba2-370m (random weights from a seed, fp32):
   ``make_prefill_step`` over 4 prompts of 1920 tokens (the SSD
   intra-chunk kernel in every layer), 128 teacher-forced
   ``make_decode_step`` steps (plain PyTorch recurrence, no kernel), one
   prefill of all 2048 tokens and 8 greedy tokens; decode is held against
   the 2048-token prefill layer by layer (same inputs, 3e-4) and in the
   logits (against the model's own fp32 noise floor);
5. training: full-width mamba2-370m (48 layers) and full-width
   llama3-8b cut to 2 layers (its 32 would need ~128 GB of params,
   grads and moments), each 8 AdamW steps from random weights on a
   global batch of 4 x 1024 synthetic tokens in 2 microbatches (step
   time by CUDA events after one warm-up step, tokens/s, peak memory,
   the loss at every step; finite, and the last below the first); 3
   straight steps == 2 + checkpoint save / restore + 1, byte for byte,
   on mamba2-370m cut to 2 layers; ``examples/torch_train_tiny.py
   --steps 20`` (``launch.train`` on the tiny config) on the card, then
   ``--steps 22`` on its checkpoint, which must resume
   from step 20, then a tiny ``kernel`` engine built from that
   checkpoint (``EngineSpec(params_path=...)``) serving the smoke's 12
   requests; training launches no kernel (its counts stay 0);
6. engine A: full-width llama3-8b (random weights from a seed, fp32),
   ``cachecraft`` with a chunk store, ``attn_impl="kernel"``: chunk
   attention in the prefill windows, decode attention over the arena,
   the RoPE kernel removing RoPE from every stored chunk and re-applying
   it to every reused one; logs the chunk calls by ``(B, A, S)`` and the
   decode calls by ``(B, S)``;
7. engine B: the same weights and workload with ``paged_decode=True,
   attn_impl="paged_kernel"``: the paged kernel reads the pool in place
   (its calls logged by ``(B, NBmax, bs)``);
8. engine C: the same with ``attn_impl="dense"`` (plain PyTorch
   attention); A's and B's per-step decode logits are held against C's;
9. server: the HTTP server (``serving/server.py``) around a fresh
   ``kernel`` engine, the same 12 requests submitted and streamed through
   ``ServeClient``, one cancelled after its 2nd token (``run_server``);
10. families (fp32, random weights from seed 0, its seconds printed):
    llama3-8b once more, one 4096-token ``M.prefill`` on ``auto`` (its
    blocked-flash branch) against ``kernel``; then, its weights freed,
    gemma3-4b (34 layers, 29 of them ``local`` with a 1024-key window)
    and granite-moe-1b-a400m (24 MoE layers) at full width and depth
    through engines A and C on the smoke workload (12/12, identical
    plans, A's decode logits within 2e-3 of C's, A's chunk / decode /
    rope launches counted from 0, and each of the three kernels held
    against its plain version and timed on the recorded inputs of A's
    most frequent call shape: gemma3's D 256 with its window and rope at
    theta 1e6, granite's G 2, D 64); gemma3-4b again on 4 requests past
    its window (5 chunks of 205-245 tokens each), where the window must
    mask (query, key) pairs in A's chunk calls and keys in its decode
    calls; gemma3-4b's model roots on a 2048-token prompt (prefill on
    ``kernel``, ``auto`` and ``dense`` within 2e-3, then 8 decode steps
    on the ring cache against the full-length one within 1e-4, and a
    ring without its oldest live key, a planted fault, beyond 1e-4);
    phi3.5-moe-42b-a6.6b at full width cut to 2 layers (its 32 are ~168
    GB in fp32), a 1024-token prefill and 8 decode steps, ``kernel``
    against ``dense`` (``run_families``);
11. recurrent and vision (fp32, random weights from seed 0; the
    reference's engine serves neither family, so the model roots):
    recurrentgemma-9b at full width and depth (38 layers: 26 ``rglru``,
    12 ``local`` with a 2048-key window), one 4096-token prompt (the
    window masks pairs, the ring wraps): prefill on ``kernel``, ``auto``
    and ``dense`` within 2e-3, 8 greedy decode steps on ``kernel``
    against ``dense`` within 2e-3, the ring cache against a full-length
    one within 1e-4, decode after the prefill against the prefill
    extended by that token within 2e-3, prefill / decode step / one
    full-width ``rglru_scan`` timed; llama-3.2-vision-90b at full width
    cut to 5 of its 100 layers (one group, 4 ``attn`` + 1 ``xattn``),
    its zero-initialised gates set nonzero from the seed, media [1, 1600,
    8192] from the seed, prompts of 1024 tokens (dense cross-attention)
    and 2048 (its blocked flash): prefill and 8 decode steps, ``kernel``
    against ``dense`` within 2e-3, and the same run with the media
    zeroed, a planted control, above 2e-3. Each model's chunk and decode
    launches are counted (one per attention layer and call, exactly) and
    both kernels held and timed on the recorded inputs of its most
    frequent call shape (``run_recurrent_vision``);
12. serving mesh (run after phase 9, while llama3-8b's weights are
    loaded; ``run_mesh``): a serving mesh of 4 head shards, all on the
    card (``launch.mesh.make_serving_mesh(4, device="cuda")``); engine C
    with ``mesh=`` (forced to ``sharded``: the dense oracle once per head
    shard, a head-sharded pool) against engine C: tokens and plans
    identical, decode logits within 1e-5 (bit equality printed),
    per-device KV bytes and attention FLOPs exactly 1/4, total FLOPs
    equal; the same engine with ``paged_decode=True`` bit-equal to it
    with 0 gather bytes; engine B (``paged_kernel``, ``paged_decode``)
    with the mesh installed through ``set_serving_mesh``: the paged
    kernel launched exactly 4 times per layer and decode step, each on its
    shard's head slice of the pool twin read in place, logits within 2e-3
    of engine C; then on engine B's recorded inputs each shard's launch
    against the plain version on the same view (3e-5, bf16 3e-2), the
    shards' outputs put together against the unsharded launch, and the 4
    launches timed against the one (``measure_paged_shards``);
13. context parallel and compression (after phase 11; ``run_cp_ef``):
    ``gqa_attend_flash_cp`` over a CP mesh of 4 (axis "model", on the
    card) against ``gqa_attend_flash`` at gemma3-4b's width (8 / 4 heads
    of 256, 2048 tokens, its 1024-key window and none) within 1e-5, and
    gemma3-4b at full width and depth through ``make_prefill_step`` on
    ``flash_cp`` against ``flash`` within 1e-5; the int8 error-feedback
    all-reduce of llama3-8b's gradients (full width, 2 layers, 1024 tokens
    per shard) over 4 shards for 8 steps within the reference's bounds;
14. sharded training and the dry-run (after phase 13; ``run_sharded``):
    llama3-8b cut to 2 layers, 3 steps unsharded and 3 ZeRO-1
    data-parallel steps (``make_train_step(..., grad_specs=...)``) over a
    (data 4, model 1) mesh on the card from the same init, 8 x 512
    tokens, accum 2: losses within 1e-5, params within rtol 2e-4 / atol
    1e-4 (AdamW's sign flips aside, ``FLIP_SHARE``), every split leaf's
    shards exactly 1/4, the counted collective bytes equal to the
    dry-run's closed form, the sharded peak memory within one fp32 copy
    of the params of the unsharded one; mamba2-370m cut to 2 layers, 2
    steps on data 4, saved, restored onto data 2 (every shard its slice
    byte for byte) and a 3rd step against data 4's; phase 5's llama3-8b/2
    step counted on meta (``count_cell``) over its measured time; four
    llama3-8b cells of the dry-run on meta in CPU worker processes;
15. tensor-parallel training (after phase 14; ``run_tp``): llama3-8b
    cut to 2 layers, 3 steps on a (data 2, model 4) mesh on the card
    (q / kv heads, the SwiGLU and the vocab split over "model") against
    phase 14's unsharded steps: losses within 1e-5, params within rtol
    2e-4 / atol 1e-4 (sign flips aside, ``FLIP_SHARE``), ``m`` and ``v``
    within it; the recurrent blocks split by channels and heads:
    recurrentgemma-9b at full width cut to 3 layers (rglru, rglru, local)
    on (data 1, model 4) against 3 unsharded steps from the same init
    (kept on the host) to the same standard, mamba2-370m cut to 2 layers
    and whole on (data 2, model 4), its step drifting under any
    reordering of fp32 sums as granite's does (``RECURRENT_TP``): one
    sharded step from each unsharded state at 2 layers to the standard
    with the CPU tests' flip allowance (``FLIP_GRAD``), and so one
    data-parallel step on (data 2, model 1) beside it, each whole run
    within 4x the drift of three controls from inits perturbed by
    2^-20; granite-moe-1b-a400m at full width cut to 2 layers and
    whole, 3 unsharded steps, 3 from each of three inits whose embedding
    elements are scaled by 1 + 2^-20 N(0, 1) (the controls: top-k
    routing is discontinuous, ``MOE_CONTROL``), then 3 on (data 4, model
    1) (the MoE aux term from global means alone) and 3 on (data 2,
    model 2) (experts and vocab split), the routing flips of every step
    counted against the unsharded run's: the 2-layer run on (4, 1) within
    the parity standard, at 2 layers one sharded step from each
    unsharded state within it wherever that step flips no route, every
    run's loss gap and params outside the tolerance within 4x the
    controls' most, its params within twice the summed lr; 8 x 512
    tokens, accum 2; the counted collective bytes equal to the dry-run's
    closed forms, mesh position 0's param / ``m`` / ``v`` bytes equal to
    their layouts', each microbatch's aux printed beside the unsharded
    one's;
16. the engine under pool pressure (after phase 12, while llama3-8b's
    weights are loaded; fp32, TF32 off; ``run_pressure``): the
    reference's churn workload (6 requests, decode lengths 18, 18, 3, 5,
    4, 6) at pool 512 and at pool 20 (80 MiB of fp32 KV) with
    ``preempt_after_iters`` 4 on the default route, ``kernel`` and
    ``paged_kernel`` + ``paged_decode``: preemptions, recovered blocks,
    no burned pass, the pool settled, outputs equal to the unpressured
    run's, decode logits and final KV within 2e-4 of it (byte equality
    printed; a preempted request re-prefills beside another partner, and
    the packed shape moves every route's sums on the card, as a control
    without pressure or packing shows on the default route), the kernel
    routes within 2e-3 of the default route's; zero-copy against copy on
    ``tests/test_shared_chunks.py``'s workload with a store (default and
    ``kernel``) and the incremental decode batch against rebuilds, each
    within 1e-5 (the same shapes on both sides); the chunk, decode,
    paged and rope launches counted from 0 around these runs, each
    kernel held and timed on the recorded inputs of its most frequent
    call shape;
17. the executor's decision surface (after phase 16, while llama3-8b's
    weights are loaded; fp32, TF32 off; ``run_strategies``): one chunk
    store warmed on ``dense`` by the smoke workload's 12 prompts, then
    only read; 4 of the prompts with their chunks reversed, packed in one
    pass a run, ``use_focus=False``, a seeded generator: every registered
    strategy (``cachecraft``, ``random``, ``h2o``, ``none``, ``all``,
    ``prefix``, ``blend``) at recompute fraction 0.3, ``cachecraft`` at
    its own CFO, ``blend`` at 1 and 0, ``cachecraft`` forced to 1, 0 and
    0.7, ``none`` without the RPE fix and ``cachecraft`` without the
    causality fix, on ``kernel`` and on ``dense``: plans equal (``blend``:
    tokens that differ only at near ties, counted), logits within 2e-3;
    on each route blend@1 == all and blend@0 == none byte for byte,
    forced full recompute within 3e-4 of ``all``, the deviation from
    ``all`` at 0.7 below that at 0, without the RPE fix above with it; on
    ``kernel`` streamed loads (the RoPE kernel once per layer) == eager
    byte for byte and one focus run; the chunk and RoPE launches counted
    from 0 around the runs, and the chunk kernel held and timed on
    ``blend``'s probe call (every row active, A = S);
18. the serving steps over a (data, model) mesh (after phase 15; fp32,
    TF32 off; ``run_tp_serving``): ``make_prefill_step``,
    ``make_cachecraft_prefill_step`` and ``make_decode_step`` with
    ``shardings=`` (the dry-run's serving layout: params by the rules,
    the rows over "data", the cache by ``cache_shardings``) on 4 rows: a
    512-token prefill into a 576-slot cache, the Cache-Craft step of 160
    active positions (30%) against it, 8 decode steps after it;
    llama3-8b at full width and depth on (1, 4) and (2, 2) (its kv heads
    split with the q heads), recurrentgemma-9b at full width cut to its
    first group on (1, 4) (one kv head: the prefill cache split by D
    columns, the decode cache by sequence, attention reading them put
    together), mamba2-370m cut to 2 layers and whole on (1, 4)
    (``ssd_intra`` on each shard's heads); unsharded and sharded on
    ``kernel`` and on ``dense``: sharded within 2e-4 of unsharded on the
    same route (whole mamba2, whose 48 random layers amplify rounding,
    within 4x the drift of three unsharded controls from embeddings
    perturbed by 2^-20), ``kernel`` within 2e-3 of ``dense`` (logits and
    caches, allclose), the chunk,
    decode and SSD launches counted from 0 around each sharded run and
    equal to one per layer, model shard and data shard; each kernel held
    and timed on the recorded inputs of its most frequent per-shard call
    (llama3-8b's on (1, 4), mamba2's for SSD) beside the unsharded call
    of that shape and SDPA on the shard's slice;
19. bf16 serving (after phase 10's long prompt, the last use of
    llama3-8b's fp32 weights; TF32 off; ``run_bf16``): the weights rounded
    to bf16 values in place and copied to bf16 (48 GB of weights on the
    card, peak memory logged); engine A16 (``kernel``,
    ``cfg.replace(dtype="bfloat16", param_dtype="bfloat16")``: bf16
    weights and activations over the engine's fp32 caches, the chunk and
    decode kernels' mixed instantiation, bf16 q and out over fp32 K/V)
    after an untimed bf16 warm-up, and engine A32 (``kernel``, fp32, on
    the same rounded weights), the smoke workload: both complete, A16's
    chunk and decode launches counted from 0 all of the mixed
    instantiation and exactly what its plans imply (one per layer and
    prefill pass, one per layer and decode step), the A16-A32 decode
    logit gap logged with the steps where greedy tokens part (each where
    A32's top-two gap is within that gap), plans compared, TTFT mean and
    p99, decode step and computed / total tokens of both; each mixed
    kernel held on the recorded inputs of A16's most frequent call shape
    (out within one bf16 rounding of the plain version's fp32 value plus
    3e-5, the mass within 3e-5, two launches byte for byte) and timed
    beside its plain version, its bound and the upcast plus SDPA;
20. the reference's bf16 deployment through the step roots and the
    train step (TF32 off; ``run_bf16_steps`` after phase 19, on its
    weights; ``run_bf16_families`` after llama3-8b's weights are freed):
    ``cfg.replace(dtype="bfloat16", param_dtype="bfloat16")`` with bf16
    caches from ``init_cache`` at ``cfg.dtype``, phase 18's inputs and
    steps (recurrentgemma-9b's prompt 2048 tokens, filling its ring; no
    Cache-Craft step where the config takes no chunk cache). llama3-8b at
    full width and depth on ``kernel`` and ``dense`` in bf16, on
    ``kernel`` over (1, 4) and on ``kernel`` in fp32 on the same
    bf16-rounded weights (the yardstick); recurrentgemma-9b, gemma3-4b
    and mamba2-370m whole likewise, unsharded (its ``dense`` and fp32
    routes on the plain SSD, ``PlainSsd``). Held by the bf16 rule
    (``BF16_GAP_FACTOR``: the bf16 kernel route against the fp32 one,
    against ``dense`` in bf16 and sharded against unsharded, each within
    twice the rms and the largest of the ``dense`` bf16 route's gap to the
    fp32 one, the largest plus one bf16 ulp; positions equal). The chunk,
    decode and SSD launches counted from 0 around each run by
    instantiation: every chunk and decode launch the pure-bf16 one, one
    per attention layer (and model shard) and pass or step, the SSD ones
    fp32; the pure-bf16 chunk and decode kernels held (3e-2) and timed on
    the recorded inputs of each model's most frequent calls (and
    recurrentgemma's decode at B 1) beside SDPA in bf16 and their bound,
    mamba2's SSD call against ``ssd_intra_ref`` (fp32 allclose bound).
    The bf16 train step of llama3-8b/2 (phase 5's shape, 3 steps) beside
    the fp32 step from the same bf16-rounded init: step ms, tokens/s,
    peak memory, MFU against the bf16 peak, the bf16 losses falling, the
    first step's loss and grad norm (the same params in both) within
    twice the plain forward's per-token NLL gap and grad gap norm, its
    update bit-equal to AdamW written out in fp32 and rounded to nearest
    bf16 (``BF16_UPDATE_EQUAL``) and beyond one ulp of the fp32 run's no
    more often than twice the grads' sign flips;
21. the rest of the bf16 engine (after phase 19, on its weights, before
    phase 20; TF32 off; ``run_bf16_engine``), llama3-8b on ``kernel``
    over the engine's fp32 caches: phase 17's 15 executor cases in bf16
    over a store warmed on ``kernel`` in bf16, each beside the same case
    in fp32 on the same rounded weights replaying the bf16 run's choices
    (plans equal, the fp32 run's own choices differing only at near ties,
    counted; the last logits within phase 19's limit, 4x the plain
    forward's bf16 gap); in bf16 blend@1 == all and blend@0 == none byte
    for byte, forced full recompute within 3e-4 of ``all``, the
    deviation from ``all`` at 0.7 below that at 0 and without the RPE
    fix above that with it, streamed loads == eager byte for byte; the
    churn workload in fp32 at pool 512 (the yardstick: bf16 against it by
    phase 19's rule) and in bf16 at pool 512 and 20 (preemptions, the
    pool settled, the pressured logits within the limit while the tokens
    agree, a token parted only where the unpressured top-two gap is
    within it; a parted request run again without pressure, packed with
    its pressured partners, logged); zero-copy == copy and incremental ==
    rebuild byte for byte in bf16; the HTTP server around a bf16 engine
    (``run_server``'s requirements, its survivors' tokens against A16's
    logged). Every chunk and decode launch of the bf16 runs, counted from
    0 around each, is the mixed instantiation and as many as the plans
    imply; RoPE stays fp32; no paged launch. ``blend``'s probe call (A =
    S) held in the mixed instantiation (one bf16 rounding + 3e-5) and
    timed beside its fp32 call, upcast plus SDPA and its bound;
22. a ``kernels`` JSON line (launches on the main paths, error, times,
    bound, the D 256 rows, the paged kernel's per-shard call, each
    family's path shape, the pressure phase's and the strategies phase's
    beside them; and a row each for the chunk, decode and SSD kernels
    launched per model shard in phase 18), the mamba2 and training
    figures, per-engine TTFT / decode-step figures, the server's, the
    families', the recurrent and vision ones, the mesh phases', the
    pressure phase's, the strategies phase's, phases 14-15's and phase
    18's; the two mixed rows of phase 19 with its figures; and the two
    pure-bf16 step-root rows of phase 20 and its fp32 SSD row with its
    figures (a row cut from another call, never launched at its own
    shape, shows 0 launches); and phase 21's mixed probe row with its
    figures; the RoPE row's launches in phase 23's examples and its
    figures at their most frequent shapes, and that phase's figures;
23. the examples (after phase 17, while llama3-8b's fp32 weights are
    loaded, before phase 10; ``run_examples``): ``run`` of
    ``examples/torch_quickstart.py``, ``torch_cache_analysis.py`` and
    ``torch_serve_rag.py`` on those weights (serve_rag at its 16 requests
    and 4,096-block pool, full recompute then Cache-Craft), each one's
    launches counted from 0, the peak memory logged; each example's tiny
    ``main()`` as a subprocess with no ``--device`` (serve_rag with
    ``--requests 4``). Every request completes in both strategies,
    Cache-Craft computes fewer prefill tokens than the total and full
    recompute all of them, quickstart's second request has two hits or
    more and computes fewer tokens than it holds, cache_analysis's 100%
    row is within 2e-4, the RoPE kernel runs in quickstart and in the
    Cache-Craft engine, and each example's most frequent RoPE call,
    replayed on its recorded inputs, holds against the plain RoPE (fp32
    3e-5, bf16 3e-2); deviations, CCI, TTFT and throughput are logged,
    not gated;
24. last line: ``{"ok": true, "device": {...}}``.

Launch counts are set to 0 just before the mamba2 phase, the training
runs, the engine serving the trained checkpoint, engines A and B,
each family's engine A, each counted run of phase 11, engine B on the
mesh, the pressure phase's runs, the strategies phase's, engine A16 and
each bf16 run of phase 21 (with each instantiation's count,
``launches_by_type``) and each example of phase 23, and read
just after (rope and the attention kernels of engine A in A, paged
decode in B and in B on the mesh, all four in phase 16, chunk and rope
in phase 17, chunk, decode and SSD around each sharded run of phase 18,
the mixed chunk and decode instantiations and rope in A16, chunk, decode
and SSD by instantiation around each run of phase 20, around each
bf16 run of phase 21, summed, and all four around each example of phase
23);
the comparison launches
of phase 3 and the replays after the engines and the examples do not
count. Without CUDA, or without the
repository's ``src/`` beside it, the script exits non-zero and prints no
result.
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import gc
import json
import math
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# the chunk kernel's fp32 products run as 3xTF32: three TF32 products for
# each fp32 product, so its fp32 bound counts 3x the operations at the
# TF32 rate (the CUDA-core figure is kept beside it); the SSD kernel's
# per-head products likewise, and in bf16 as three bf16 parts at the bf16
# rate
TF32_PASSES = 3
TOL = {"float32": 3e-5, "bfloat16": 3e-2}
# the (q and out, K/V) dtype pairs the attention kernels take: one type
# for all, or the bf16 engine's mix, bf16 q and out over fp32 K/V (phase
# 19). A mixed kernel's bf16 output is held within one bf16 rounding (half
# an ulp, at most 2^-8 |x|) of the plain version's fp32 value, plus the
# fp32 kernels' 3e-5 for the difference of the fp32 values; its fp32 mass
# at 3e-5
SAME_TYPES = (("float32", "float32"), ("bfloat16", "bfloat16"))
MIXED_TYPES = (("bfloat16", "float32"),)
MIXED = "bfloat16 q / float32 kv"     # build.ATTN_TYPE_NAMES of the mix
BF16_ONE_ROUNDING = 2.0 ** -8
# A/B vs C decode logits: fp32 attention summed in another order (online
# softmax over 64-key tiles vs one dense softmax), carried through 32
# layers; logits are O(1) (unit-variance unembedding). The families phase
# holds its twins to the same bound: kernel vs dense, and auto's blocked
# flash vs kernel
LOGIT_TOL = 2e-3
# gemma3-4b's ring cache vs the full-length one, 8 decode steps from the
# same prefill on the same route: the live keys are the same, held in
# another slot order, so only the order of the decode's fp32 sums
# differs. On the H100 these read 1.04e-5 (kernel) and 1.20e-5 (dense
# decode on the ring), and the ring without its oldest live key at the
# first step (a planted fault) 0.145 (PERF.md)
RING_TOL = 1e-4
# mamba2, decode (plain fp32 recurrence) vs prefill (ssd_intra kernel):
# - per layer, same input through both paths: the reference's 3e-4
#   (tests/test_equivalence.py); the block outputs are O(1);
# - end to end, the logits of 48 random layers: a perturbation of one ulp
#   on the embeddings alone moves them by O(1) on the H100 (the random
#   model amplifies rounding through depth), so no fixed tolerance
#   applies. They are held within MAMBA_NOISE_FACTOR times
#   that noise floor, measured in the same run at the same positions.
MAMBA_LAYER_TOL = 3e-4
MAMBA_NOISE_FACTOR = 4.0


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, iters=20, warmup=3):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def device_ms(fn, iters=20, warmup=3, windows=3):
    """Device time of one call of ``fn``: the durations of the kernels,
    copies and memsets ``torch.profiler`` records over ``iters`` calls,
    summed and divided by ``iters``; the median over ``windows`` profiled
    windows, since a window now and then records no or too little device
    activity. Unlike ``cuda_ms`` it leaves out the host's time between
    launches, which a call that is cheap on the card cannot hide. None if
    no window saw device activity."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    reads = []
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(float(ev.self_device_time_total)
                 for ev in prof.key_averages()
                 if ev.device_type == torch.autograd.DeviceType.CUDA)
        if us > 0:
            reads.append(us / iters / 1e3)
    return float(np.median(reads)) if reads else None


def _fmt(ms):
    return "not measured" if ms is None else f"{ms:.4f}"


def _roofline():
    """The H100 SXM's peaks (NVIDIA data sheet, dense): HBM bytes/s and
    the rate for each operand type, from the port's one home for them."""
    from repro_torch.launch import roofline
    return roofline


def bound(nbytes, flops, dtype):
    rl = _roofline()
    t_b = nbytes / rl.HBM_BW
    t_f = flops / rl.PEAK_FLOPS_BY_TYPE[dtype]
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


# ---------------------------------------------------------------------------
# phase 3: kernels vs plain versions at the main path's shapes
# ---------------------------------------------------------------------------
def chunk_inputs(rng, dev):
    """The kernel table's shape: A 256 query rows x S 1024 keys, H 32 / Hkv 8 /
    D 128, C 16: two packed requests (segments 0 / 1, request-local
    positions), padding rows and slots (pos -1 / seg -1) as the executor
    lays them out."""
    import numpy as np
    import torch
    A, S, H, Hkv, D, C = 256, 1024, 32, 8, 128, 16
    s_len = (600, 360)                 # keys of request 0 / 1; rest padding
    a_len = (160, 80)                  # active rows of request 0 / 1
    kpos = np.full(S, -1, np.int32)
    kseg = np.full(S, -1, np.int32)
    kch = np.full(S, C - 1, np.int32)
    qpos = np.full(A, -1, np.int32)
    qseg = np.full(A, -1, np.int32)
    k0 = a0 = 0
    for r, (sl, al) in enumerate(zip(s_len, a_len)):
        kpos[k0:k0 + sl] = np.arange(sl)
        kseg[k0:k0 + sl] = r
        kch[k0:k0 + sl] = np.minimum(np.arange(sl) // 48 + 1, C - 2)
        qpos[a0:a0 + al] = np.sort(rng.choice(sl, al, replace=False))
        qseg[a0:a0 + al] = r
        k0 += sl
        a0 += al
    f = lambda *s: torch.from_numpy(  # noqa: E731
        rng.normal(size=s).astype(np.float32)).to(dev)
    i = lambda x: torch.from_numpy(x)[None].to(dev)  # noqa: E731
    return dict(q=f(1, A, H, D), k=f(1, S, Hkv, D), v=f(1, S, Hkv, D),
                q_pos=i(qpos), k_pos=i(kpos), k_chunk=i(kch), q_seg=i(qseg),
                k_seg=i(kseg), C=C, window=0)


def chunk_inputs_d256(rng, dev):
    """gemma3-4b's prefill window on its ``local`` layers: A 512 query
    rows (scattered positions) over S 2048 keys of one request, H 8 / Hkv
    4 / D 256, C 16 chunks of 128 keys, the 1024-key window."""
    import numpy as np
    import torch
    A, S, H, Hkv, D, C = 512, 2048, 8, 4, 256, 16
    kpos = np.arange(S, dtype=np.int32)
    qpos = np.sort(rng.choice(S, A, replace=False)).astype(np.int32)
    kch = np.minimum(kpos // 128, C - 1).astype(np.int32)
    f = lambda *s: torch.from_numpy(  # noqa: E731
        rng.normal(size=s).astype(np.float32)).to(dev)
    i = lambda x: torch.from_numpy(x)[None].to(dev)  # noqa: E731
    return dict(q=f(1, A, H, D), k=f(1, S, Hkv, D), v=f(1, S, Hkv, D),
                q_pos=i(qpos), k_pos=i(kpos), k_chunk=i(kch),
                q_seg=i(np.zeros(A, np.int32)),
                k_seg=i(np.zeros(S, np.int32)), C=C, window=1024)


def time_head_dim_halves(ci):
    """What D 256's plan costs against D 128's: the kernel on ``ci`` as
    given, and on its first 128 columns (the D 128 instantiation, one
    warp per query block, two CTAs per SM), by events, fp32 and bf16.
    Returns {dtype: {"ms_d256", "ms_d128", "ratio"}}."""
    import torch

    from repro_torch.kernels.chunk_attention import ops as cops

    out = {}
    for dt_name in ("float32", "bfloat16"):
        dt = getattr(torch, dt_name)
        kw = dict(q_seg=ci["q_seg"], k_seg=ci["k_seg"], num_chunks=ci["C"],
                  window=ci["window"])
        ints = (ci["q_pos"], ci["k_pos"], ci["k_chunk"])
        full = [ci[n].to(dt) for n in ("q", "k", "v")]
        half = [x[..., :128].contiguous() for x in full]
        ms = {f"ms_d{x[0].shape[-1]}": cuda_ms(
            lambda x=x: cops.chunk_attention(*x, *ints, **kw))
            for x in (full, half)}
        out[dt_name] = dict(ms, ratio=ms["ms_d256"] / ms["ms_d128"])
    log("chunk_attention at gemma3's shape, D 256 against its first 128 "
        "columns (D 128): " + json.dumps(out))
    return out


def _pair(q_name, kv_name):
    """A (q, K/V) dtype pair's name: the dtype, or MIXED."""
    return q_name if q_name == kv_name else MIXED


def _hold_rounding(what, out, ref32):
    """bf16 ``out`` within one bf16 rounding of fp32 ``ref32`` plus 3e-5:
    returns (max abs error, worst ratio to that bound); raises beyond."""
    import torch
    d = (out.float() - ref32).abs()
    ratio = float((d / (BF16_ONE_ROUNDING * ref32.abs()
                        + TOL["float32"])).max())
    if out.dtype != torch.bfloat16 or not ratio <= 1.0 or \
            not bool(torch.isfinite(out).all()):
        raise RuntimeError(f"{what}: {out.dtype} out beyond one bf16 "
                           f"rounding + 3e-5 (worst ratio {ratio:.3f})")
    return float(d.max()), ratio


def measure_chunk(label, ci, pairs=SAME_TYPES):
    """chunk_attention on ``ci`` (batched tensors as the wrapper takes
    them, plus ``C`` and ``window``) for each (q, K/V) dtype pair of
    ``pairs``: error against the plain version (per batch row; a mix
    within one bf16 rounding of the plain version's fp32 value, its mass
    within 3e-5), two launches byte for byte, kernel / plain / SDPA times
    by events over 20 calls after 3 warm-up calls (for a mix, SDPA's
    column is two calls: q upcast, then SDPA), and the bound from what
    these inputs need: the (query, key) pairs they mask in, q read for the
    rows that attend a key and K/V for the slots that some row attends,
    out and the mass written for every row. On fp32 K/V (the mix too) the
    bound counts the 3xTF32 products at the TF32 rate; the CUDA-core bound
    (fp32 at 67 TFLOP/s) is kept beside it. Returns {pair name: {...}}."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.chunk_attention import ops as cops
    from repro_torch.kernels.chunk_attention.ref import chunk_attention_ref

    C, window = ci["C"], ci["window"]
    B, A, H, D = ci["q"].shape
    S, Hkv = ci["k"].shape[1:3]
    qp, kp = ci["q_pos"], ci["k_pos"]
    mask = (qp[:, :, None] >= kp[:, None]) & (qp[:, :, None] >= 0) & \
        (kp[:, None] >= 0) & (ci["q_seg"][:, :, None] == ci["k_seg"][:, None])
    if window:
        mask &= (qp[:, :, None] - kp[:, None]) < window
    n_pairs = int(mask.sum())
    rows_live = int(mask.any(2).sum())       # q rows that attend a key
    slots_live = int(mask.any(1).sum())      # K/V slots some row attends
    flops = 4 * D * H * n_pairs
    shape = (f"B {B}, A {A}, S {S}, H {H}/{Hkv}, D {D}, C {C}, "
             f"window {window}")
    res = {}
    for q_name, kv_name in pairs:
        name = _pair(q_name, kv_name)
        kv_dt = getattr(torch, kv_name)
        x = {n: (t.to(kv_dt) if t.is_floating_point() else t)
             for n, t in ci.items() if isinstance(t, torch.Tensor)}
        x["q"] = ci["q"].to(getattr(torch, q_name))
        args = (x["q"], x["k"], x["v"], x["q_pos"], x["k_pos"], x["k_chunk"])
        kw = dict(q_seg=x["q_seg"], k_seg=x["k_seg"], num_chunks=C,
                  window=window)
        o, m = cops.chunk_attention(*args, **kw)
        o2, m2 = cops.chunk_attention(*args, **kw)
        torch.cuda.synchronize()
        if not (torch.equal(o, o2) and torch.equal(m, m2)):
            raise RuntimeError(f"chunk_attention {label} {name}: two "
                               "launches on the same inputs differ")

        def plain(qq=x["q"], x=x):
            return [chunk_attention_ref(
                qq[b], x["k"][b], x["v"][b], x["q_pos"][b],
                x["k_pos"][b], x["k_chunk"][b], num_chunks=C, window=window,
                q_seg=x["q_seg"][b], k_seg=x["k_seg"][b]) for b in range(B)]
        extra = {}
        if name == MIXED:
            ref = plain(x["q"].float())
            e, ratio = _hold_rounding(f"chunk_attention {label} {name}", o,
                                      torch.stack([r for r, _ in ref]))
            mass_err = float((m - torch.stack([r for _, r in ref]))
                             .abs().max())
            if not mass_err <= TOL["float32"]:
                raise RuntimeError(f"chunk_attention {label} {name}: mass "
                                   f"err {mass_err} > {TOL['float32']}")
            extra = dict(ratio=ratio, mass_err=mass_err)
            tol = (f"worst {ratio:.3f} of one bf16 rounding + 3e-5, mass "
                   f"err {mass_err:.3e}")
        else:
            e = 0.0
            for b, (orf, mrf) in enumerate(plain()):
                e = max(e, float((o[b].float() - orf.float()).abs().max()),
                        float((m[b] - mrf).abs().max()))
            if not (e <= TOL[name] and torch.isfinite(o).all()):
                raise RuntimeError(f"chunk_attention {label} {name}: max "
                                   f"abs err {e} > {TOL[name]}")
            tol = f"tol {TOL[name]}"
        qh = x["q"].transpose(1, 2).contiguous()           # [B, H, A, D]
        kh = x["k"].transpose(1, 2).contiguous()
        vh = x["v"].transpose(1, 2).contiguous()
        t_k = cuda_ms(lambda: cops.chunk_attention(*args, **kw))
        t_p = cuda_ms(plain, iters=5)
        t_l = cuda_ms(lambda: F.scaled_dot_product_attention(
            qh.to(kv_dt), kh, vh, attn_mask=mask[:, None], enable_gqa=True))
        el_q, el_kv = x["q"].element_size(), x["k"].element_size()
        nbytes = ((rows_live + B * A) * H * D * el_q
                  + 2 * slots_live * Hkv * D * el_kv
                  + B * (4 * (2 * A + 3 * S) + 4 * A * C))
        cc_ms, note = None, ""
        if kv_name == "float32":
            b_ms, b_by = bound(nbytes, TF32_PASSES * flops, "tf32")
            cc_ms, cc_by = bound(nbytes, flops, "float32")
            note = (f" (3xTF32 at 495 TFLOP/s; CUDA cores: {cc_ms:.4f} "
                    f"{cc_by})")
        else:
            b_ms, b_by = bound(nbytes, flops, kv_name)
        ns = cops.num_splits(B, A, S, H, Hkv, kv_dt)
        res[name] = dict(err=e, ms=t_k, plain_ms=t_p, library_ms=t_l,
                         bound_ms=b_ms, bound_by=b_by,
                         bound_ms_cuda_cores=cc_ms, splits=ns, shape=shape,
                         **extra)
        lib = " (upcast + SDPA)" if name == MIXED else ""
        log(f"kernel chunk_attention {label} {name} B={B} A={A} S={S} "
            f"H={H} Hkv={Hkv} D={D} C={C} window={window} splits={ns} "
            f"pairs={n_pairs} live_rows={rows_live} live_slots="
            f"{slots_live}: max_abs_err={e:.3e} ({tol}) two launches "
            f"bit-identical ms={t_k:.4f} plain_ms={t_p:.4f} "
            f"library_ms={t_l:.4f}{lib} bound_ms={b_ms:.4f} ({b_by}){note} "
            f"share={b_ms / t_k:.1%}")
    return res


def sweep_chunk_splits(inputs, splits=(1, 2, 3, 4, 6, 8, 12, 16)):
    """Times the chunk kernel on each of ``inputs`` (label -> batched
    inputs as ``measure_chunk`` takes them) in fp32 and bf16 at each
    number of key ranges that gives whole, non-empty ranges, through the
    wrapper with ``num_splits`` held at that count, and prints the count
    ``num_splits`` picks beside the fastest. Each forced split is held
    against the plain version. Returns {label: {dtype: {...}}}."""
    import torch

    from repro_torch.kernels.chunk_attention import ops as cops
    from repro_torch.kernels.chunk_attention.ref import chunk_attention_ref

    rule = cops.num_splits
    res = {}
    try:
        for label, ci in inputs.items():
            C, window = ci["C"], ci["window"]
            B, A, H, D = ci["q"].shape
            S, Hkv = ci["k"].shape[1:3]
            for dt_name in ("float32", "bfloat16"):
                dt = getattr(torch, dt_name)
                x = {n: (t.to(dt) if t.is_floating_point() else t)
                     for n, t in ci.items() if isinstance(t, torch.Tensor)}
                args = (x["q"], x["k"], x["v"], x["q_pos"], x["k_pos"],
                        x["k_chunk"])
                kw = dict(q_seg=x["q_seg"], k_seg=x["k_seg"], num_chunks=C,
                          window=window)
                ref = [chunk_attention_ref(
                    x["q"][b], x["k"][b], x["v"][b], x["q_pos"][b],
                    x["k_pos"][b], x["k_chunk"][b], num_chunks=C,
                    window=window, q_seg=x["q_seg"][b], k_seg=x["k_seg"][b])
                    for b in range(B)]
                tiles = -(-S // cops._BK[dt])
                pick = rule(B, A, S, H, Hkv, dt)
                # the counts the kernel takes: tiles split into ranges of
                # ceil(tiles / n), none empty
                counts = sorted({-(-tiles // -(-tiles // n))
                                 for n in splits if n <= tiles} | {pick})
                ms = {}
                for n in counts:
                    cops.num_splits = lambda *a, n=n: n  # noqa: E731
                    o, m = cops.chunk_attention(*args, **kw)
                    torch.cuda.synchronize()
                    e = max(max(float((o[b].float() - orf.float()).abs()
                                      .max()),
                                float((m[b] - mrf).abs().max()))
                            for b, (orf, mrf) in enumerate(ref))
                    if not e <= TOL[dt_name]:
                        raise RuntimeError(
                            f"chunk_attention {label} {dt_name} with {n} "
                            f"key ranges: max abs err {e} > {TOL[dt_name]}")
                    ms[n] = cuda_ms(lambda: cops.chunk_attention(*args,
                                                                 **kw))
                cops.num_splits = rule
                best = min(ms, key=ms.get)
                res.setdefault(label, {})[dt_name] = dict(
                    rule=pick, best=best, ms=ms)
                log(f"chunk split sweep {label} {dt_name}: num_splits "
                    f"picks {pick} ({ms[pick]:.4f} ms), fastest {best} "
                    f"({ms[best]:.4f} ms); ms by ranges " + " ".join(
                        f"{n}:{t:.4f}" for n, t in ms.items()))
    finally:
        cops.num_splits = rule
    return res


def _window_masked(q_pos, k_pos, window, q_seg=None, k_seg=None):
    """The (query, key) pairs that the window alone masks: both live, in
    the same segment, the key not after the query and ``window`` or more
    positions before it. q_pos [..., A], k_pos [..., S]."""
    qp, kp = q_pos[..., :, None], k_pos[..., None, :]
    m = (qp >= 0) & (kp >= 0) & (kp <= qp) & (qp - kp >= window)
    if q_seg is not None:
        m &= q_seg[..., :, None] == k_seg[..., None, :]
    return int(m.sum())


class ChunkRecorder:
    """Wraps the chunk wrapper's launch during a run: counts the calls by
    (B, A, S) and keeps a copy of the first call's inputs for each, so the
    path's own shapes and data can be replayed after the run; sums the
    (query, key) pairs that the window alone masked over every call with
    a window (``window_masked``)."""

    def __init__(self, cops):
        self.cops, self.orig, self.calls = cops, cops._launch, {}
        self.shapes = collections.Counter()
        self.order = []                  # every call's (B, A, S), in order
        self.window_masked = 0

    def __enter__(self):
        def rec(q, k, v, q_pos, k_pos, k_chunk, q_seg, k_seg, num_chunks,
                window):
            key = (q.shape[0], q.shape[1], k.shape[1])
            self.shapes[key] += 1
            self.order.append(key)
            if window:
                self.window_masked += _window_masked(q_pos, k_pos, window,
                                                     q_seg, k_seg)
            if key not in self.calls:
                self.calls[key] = dict(
                    q=q.float().clone(), k=k.float().clone(),
                    v=v.float().clone(), q_pos=q_pos.clone(),
                    k_pos=k_pos.clone(), k_chunk=k_chunk.clone(),
                    q_seg=q_seg.clone(), k_seg=k_seg.clone(), C=num_chunks,
                    window=int(window))
            return self.orig(q, k, v, q_pos, k_pos, k_chunk, q_seg, k_seg,
                             num_chunks, window)
        self.cops._launch = rec
        return self

    def __exit__(self, *exc):
        self.cops._launch = self.orig


def decode_inputs(rng, dev, S=1024, H=32, Hkv=8, D=128,
                  lens=(1000, 800, 600, 300), window=0):
    """B 4 requests over an arena of S 1024 slots, H 32 / Hkv 8 / D 128;
    per-request lengths 1000 / 800 / 600 / 300, slots past them -1 (the
    table; gemma3's D 256 row passes its own shape and window)."""
    import numpy as np
    import torch
    B = len(lens)
    lens = np.array(lens)
    kpos = np.where(np.arange(S)[None] < lens[:, None],
                    np.arange(S)[None], -1).astype(np.int32)
    f = lambda *s: torch.from_numpy(  # noqa: E731
        rng.normal(size=s).astype(np.float32)).to(dev)
    return dict(q=f(B, H, D), k=f(B, S, Hkv, D), v=f(B, S, Hkv, D),
                q_pos=torch.from_numpy((lens - 1).astype(np.int32)).to(dev),
                k_pos=torch.from_numpy(kpos).to(dev), window=window)


def paged_inputs(rng, dev, H=32, Hkv=8, D=128, nblk=(64, 50, 30, 10),
                 window=0):
    """Pool of NB 512 blocks x bs 16 slots (H 32 / Hkv 8 / D 128), B 4
    requests with 64 / 50 / 30 / 10 blocks (-1 padded to NBmax, the
    longest), request 1 sharing request 0's first 10 blocks, each
    request's last block half empty and 5% dead interior slots (pos -1)
    (the table; gemma3's D 256 row passes its own shape and window)."""
    import numpy as np
    import torch
    NB, bs, B, NBmax = 512, 16, len(nblk), max(nblk)
    perm = rng.permutation(NB)
    rows = np.full((B, NBmax), -1, np.int32)
    kpos = np.full((NB, bs), -1, np.int32)
    used = 0
    for b, n in enumerate(nblk):
        own = list(perm[used:used + n])
        if b == 1:
            own = list(rows[0, :10]) + own[10:]
            used += n - 10
        else:
            used += n
        rows[b, :n] = own
        for j, blk in enumerate(own):
            if kpos[blk, 0] < 0:
                kpos[blk] = j * bs + np.arange(bs)
        kpos[own[-1], bs // 2:] = -1
    kpos[rng.random((NB, bs)) < 0.05] = -1
    qpos = np.array([n * bs for n in nblk], np.int32)
    f = lambda *s: torch.from_numpy(  # noqa: E731
        rng.normal(size=s).astype(np.float32)).to(dev)
    return dict(q=f(B, H, D), k_blocks=f(NB, bs, Hkv, D),
                v_blocks=f(NB, bs, Hkv, D),
                kpos_blocks=torch.from_numpy(kpos).to(dev),
                block_rows=torch.from_numpy(rows).to(dev),
                q_pos=torch.from_numpy(qpos).to(dev), window=window)


def _cast(d, dt):
    import torch
    return {n: (x.to(dt) if isinstance(x, torch.Tensor)
                and x.is_floating_point() else x) for n, x in d.items()}


def _err(a, b):
    return float((a.float() - b.float()).abs().max())


def _decode_live(q_pos, k_pos, window):
    """[B, S] bool: the keys the decode mask lets through."""
    live = (k_pos >= 0) & (k_pos <= q_pos[:, None])
    if window:
        live &= (q_pos[:, None] - k_pos) < window
    return live


def _paged_gather(pi):
    """The paged inputs' keys per request in block-row order: block ids
    (-1 -> 0), positions [B, NBmax * bs] (-1 on -1 blocks)."""
    import torch
    bs = pi["k_blocks"].shape[1]
    rows = pi["block_rows"].long()
    safe = rows.clamp(min=0)
    gpos = pi["kpos_blocks"][safe].reshape(rows.shape[0], -1)
    gpos = torch.where((rows >= 0).repeat_interleave(bs, 1), gpos,
                       torch.full_like(gpos, -1))
    return safe, gpos


def measure_decode(label, di, pairs=SAME_TYPES):
    """decode_attention on ``di`` (q, k, v, q_pos, k_pos as the wrapper
    takes them, and ``window``) for each (q, K/V) dtype pair of ``pairs``:
    error against the plain version (a mix within one bf16 rounding of the
    plain version's fp32 value), two launches byte for byte, kernel /
    plain / SDPA times by events over 20 calls after 3 warm-up calls and
    by ``torch.profiler``'s device time (for a mix, SDPA's column is two
    calls: q upcast, then SDPA), and the bound from the keys these inputs
    let through. Returns {pair name: {...}}."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref

    window = di.get("window", 0)
    B, H, D = di["q"].shape
    S, Hkv = di["k"].shape[1:3]
    live = _decode_live(di["q_pos"], di["k_pos"], window)
    n_keys = int(live.sum())
    shape = f"B {B}, S {S}, H {H}/{Hkv}, D {D}, window {window}"
    res = {}
    for q_name, kv_name in pairs:
        name = _pair(q_name, kv_name)
        kv_dt = getattr(torch, kv_name)
        x = _cast(di, kv_dt)
        x["q"] = di["q"].to(getattr(torch, q_name))
        args = (x["q"], x["k"], x["v"], x["q_pos"], x["k_pos"])
        o = dops.decode_attention(*args, window=window)
        o2 = dops.decode_attention(*args, window=window)
        torch.cuda.synchronize()
        if not torch.equal(o, o2):
            raise RuntimeError(f"decode_attention {label} {name}: two "
                               "launches on the same inputs differ")
        extra = {}
        if name == MIXED:
            e, ratio = _hold_rounding(
                f"decode_attention {label} {name}", o, decode_attention_ref(
                    x["q"].float(), *args[1:], window=window))
            extra = dict(ratio=ratio)
            tol = f"worst {ratio:.3f} of one bf16 rounding + 3e-5"
        else:
            e = _err(o, decode_attention_ref(*args, window=window))
            if not (e <= TOL[name] and torch.isfinite(o).all()):
                raise RuntimeError(f"decode_attention {label} {name}: max "
                                   f"abs err {e} > {TOL[name]}")
            tol = f"tol {TOL[name]}"
        qh = x["q"][:, :, None]                          # [B, H, 1, D]
        kh = x["k"].transpose(1, 2).contiguous()
        vh = x["v"].transpose(1, 2).contiguous()
        lmask = live[:, None, None, :]
        kern = lambda: dops.decode_attention(  # noqa: E731
            *args, window=window)
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qh.to(kv_dt), kh, vh, attn_mask=lmask, enable_gqa=True)
        t_k, t_l = cuda_ms(kern), cuda_ms(lib)
        t_p = cuda_ms(lambda: decode_attention_ref(*args, window=window))
        d_k, d_l = device_ms(kern), device_ms(lib)
        nbytes = 2 * B * H * D * x["q"].element_size() + \
            2 * n_keys * Hkv * D * x["k"].element_size() + 4 * (B + B * S)
        b_ms, b_by = bound(nbytes, 4 * D * H * n_keys, kv_name)
        ns = dops.num_splits(B, S, Hkv, kv_dt)
        res[name] = dict(err=e, ms=t_k, plain_ms=t_p, library_ms=t_l,
                         device_ms=d_k, library_device_ms=d_l,
                         bound_ms=b_ms, bound_by=b_by, splits=ns,
                         shape=shape, **extra)
        up = " (upcast + SDPA)" if name == MIXED else ""
        log(f"kernel decode_attention {label} {name} B={B} S={S} H={H} "
            f"Hkv={Hkv} D={D} window={window} live_keys={n_keys} "
            f"splits={ns}: max_abs_err={e:.3e} ({tol}) two "
            f"launches bit-identical ms={t_k:.4f} device_ms={_fmt(d_k)} "
            f"plain_ms={t_p:.4f} library_ms={t_l:.4f} library_device_ms="
            f"{_fmt(d_l)}{up} bound_ms={b_ms:.4f} ({b_by}) share="
            f"{b_ms / t_k:.1%} of ms, "
            f"{'-' if d_k is None else f'{b_ms / d_k:.1%}'} of device_ms")
    return res


def measure_paged(label, pi):
    """paged_decode_attention on ``pi`` (the wrapper's inputs, fp32, and
    ``window``) in fp32 and bf16, as ``measure_decode``; the SDPA
    yardstick runs on the same keys gathered densely beforehand (the
    gather itself is not timed)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.decode_attention.ref import \
        paged_decode_attention_ref

    window = pi.get("window", 0)
    B, H, D = pi["q"].shape
    NB, bs, Hkv = pi["k_blocks"].shape[:3]
    NBmax = pi["block_rows"].shape[1]
    safe, gpos = _paged_gather(pi)
    live = _decode_live(pi["q_pos"], gpos, window)
    n_keys = int(live.sum())
    brows = pi["block_rows"]
    ref_blocks = torch.unique(brows[brows >= 0].long())
    n_slots_needed = int((pi["kpos_blocks"][ref_blocks] >= 0).sum())
    res = {}
    for dt_name in ("float32", "bfloat16"):
        dt = getattr(torch, dt_name)
        x = _cast(pi, dt)
        args = (x["q"], x["k_blocks"], x["v_blocks"], x["kpos_blocks"],
                x["block_rows"], x["q_pos"])
        o = dops.paged_decode_attention(*args, window=window)
        o2 = dops.paged_decode_attention(*args, window=window)
        torch.cuda.synchronize()
        if not torch.equal(o, o2):
            raise RuntimeError(f"paged_decode_attention {label} {dt_name}: "
                               "two launches on the same inputs differ")
        e = _err(o, paged_decode_attention_ref(*args, window=window))
        if not (e <= TOL[dt_name] and torch.isfinite(o).all()):
            raise RuntimeError(f"paged_decode_attention {label} {dt_name}: "
                               f"max abs err {e} > {TOL[dt_name]}")
        kg = x["k_blocks"][safe].reshape(B, -1, Hkv, D).transpose(1, 2) \
            .contiguous()
        vg = x["v_blocks"][safe].reshape(B, -1, Hkv, D).transpose(1, 2) \
            .contiguous()
        qh = x["q"][:, :, None]
        lmask = live[:, None, None, :]
        kern = lambda: dops.paged_decode_attention(  # noqa: E731
            *args, window=window)
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qh, kg, vg, attn_mask=lmask, enable_gqa=True)
        t_k, t_l = cuda_ms(kern), cuda_ms(lib)
        t_p = cuda_ms(lambda: paged_decode_attention_ref(*args,
                                                         window=window))
        d_k, d_l = device_ms(kern), device_ms(lib)
        el = x["q"].element_size()
        nbytes = (2 * B * H * D + 2 * n_slots_needed * Hkv * D) * el + \
            4 * (B + B * NBmax + int(ref_blocks.numel()) * bs)
        b_ms, b_by = bound(nbytes, 4 * D * H * n_keys, dt_name)
        ns = dops.num_splits(B, NBmax * bs, Hkv, dt, block=bs)
        res[dt_name] = dict(err=e, ms=t_k, plain_ms=t_p, library_ms=t_l,
                            device_ms=d_k, library_device_ms=d_l,
                            bound_ms=b_ms, bound_by=b_by, splits=ns)
        log(f"kernel paged_decode_attention {label} {dt_name} NB={NB} "
            f"bs={bs} B={B} NBmax={NBmax} window={window} "
            f"live_keys={n_keys} splits={ns}: max_abs_err={e:.3e} (tol "
            f"{TOL[dt_name]}) two launches bit-identical ms={t_k:.4f} "
            f"device_ms={_fmt(d_k)} plain_ms={t_p:.4f} library_ms="
            f"{t_l:.4f} library_device_ms={_fmt(d_l)} bound_ms={b_ms:.4f} "
            f"({b_by}) share={b_ms / t_k:.1%} of ms, "
            f"{'-' if d_k is None else f'{b_ms / d_k:.1%}'} of device_ms")
    return res


def sweep_decode_splits(inputs, splits=(1, 2, 3, 4, 6, 8, 12, 16, 24, 32)):
    """Times the decode kernels on each of ``inputs`` (label -> ("dense" |
    "paged", inputs as ``measure_decode`` / ``measure_paged`` take them))
    in fp32 and bf16 at each number of key ranges that gives whole,
    non-empty ranges (``split_units``: tiles, or runs of pool blocks), by
    the card's clock (``device_ms``) and by events, through the
    wrapper with ``num_splits`` held at that count, and prints the count
    ``num_splits`` picks beside the fastest. Each forced count is held
    against the plain version. Returns {label: {dtype: {...}}}."""
    import torch

    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.decode_attention.ref import (
        decode_attention_ref, paged_decode_attention_ref)

    rule = dops.num_splits
    res = {}
    try:
        for label, (kind, di) in inputs.items():
            window = di.get("window", 0)
            B = di["q"].shape[0]
            for dt_name in ("float32", "bfloat16"):
                dt = getattr(torch, dt_name)
                x = _cast(di, dt)
                if kind == "dense":
                    fn = dops.decode_attention
                    args = (x["q"], x["k"], x["v"], x["q_pos"], x["k_pos"])
                    ref = decode_attention_ref(*args, window=window)
                    S, Hkv = x["k"].shape[1:3]
                    units, pick = dops.split_units(S, dt), rule(B, S, Hkv, dt)
                else:
                    fn = dops.paged_decode_attention
                    args = (x["q"], x["k_blocks"], x["v_blocks"],
                            x["kpos_blocks"], x["block_rows"], x["q_pos"])
                    ref = paged_decode_attention_ref(*args, window=window)
                    bs, Hkv = x["k_blocks"].shape[1:3]
                    S = x["block_rows"].shape[1] * bs
                    units = dops.split_units(S, dt, block=bs)
                    pick = rule(B, S, Hkv, dt, block=bs)
                # the counts the kernel takes: units split into ranges of
                # ceil(units / n), none empty
                counts = sorted({-(-units // -(-units // n)) for n in splits
                                 if n <= units} | {pick})
                ms, dms = {}, {}
                for n in counts:
                    dops.num_splits = lambda *a, n=n, **k: n  # noqa: E731
                    o = fn(*args, window=window)
                    torch.cuda.synchronize()
                    e = _err(o, ref)
                    if not e <= TOL[dt_name]:
                        raise RuntimeError(
                            f"{kind} decode {label} {dt_name} with {n} key "
                            f"ranges: max abs err {e} > {TOL[dt_name]}")
                    ms[n] = cuda_ms(lambda: fn(*args, window=window))
                    dms[n] = device_ms(lambda: fn(*args, window=window))
                dops.num_splits = rule
                # the fastest on the card's own clock (device time), the
                # host's share of a call being the same at every count
                key = {n: t for n, t in dms.items() if t is not None} or ms
                best = min(key, key=key.get)
                res.setdefault(label, {})[dt_name] = dict(
                    rule=pick, best=best, ms=ms, device_ms=dms)
                log(f"decode split sweep {label} {dt_name}: num_splits "
                    f"picks {pick} (device {_fmt(dms[pick])} ms, "
                    f"{ms[pick]:.4f} ms), fastest {best} (device "
                    f"{_fmt(dms[best])} ms, {ms[best]:.4f} ms); device ms "
                    "by ranges " + " ".join(f"{n}:{_fmt(t)}"
                                            for n, t in dms.items())
                    + "; ms by ranges " + " ".join(
                        f"{n}:{t:.4f}" for n, t in ms.items()))
    finally:
        dops.num_splits = rule
    return res


class DecodeRecorder:
    """Wraps the decode wrappers' launch during a run: counts the calls by
    (B, S) for the dense kernel and by (B, NBmax, bs) for the paged one,
    and keeps a copy of the first call's inputs for each, so the path's
    own shapes and data can be replayed after the run; sums the keys that
    the window alone masked over every dense call with a window
    (``window_masked``)."""

    def __init__(self, dops):
        self.dops, self.orig = dops, dops._call
        self.shapes = collections.Counter()
        self.calls = {}
        self.window_masked = 0

    def __enter__(self):
        def rec(what, entry, ptrs, ints, q, nsplit):
            if entry == "decode_attention_fwd":
                names = ("q", "k", "v", "q_pos", "k_pos")
                key = ("dense", ints[0], ints[1])
                window = ints[5]      # the type code follows on the card
                if window:
                    self.window_masked += _window_masked(
                        ptrs[3][:, None], ptrs[4], window)
            else:
                names = ("q", "k_blocks", "v_blocks", "kpos_blocks",
                         "block_rows", "q_pos")
                key = ("paged", ints[0], ints[2], ints[3])
                window = ints[8]
            self.shapes[key] += 1
            if key not in self.calls:
                d = {n: t.clone() for n, t in zip(names, ptrs)}
                d["window"] = int(window)
                self.calls[key] = d
            return self.orig(what, entry, ptrs, ints, q, nsplit)
        self.dops._call = rec
        return self

    def __exit__(self, *exc):
        self.dops._call = self.orig

    def most_frequent(self, kind):
        keys = [k for k in self.shapes if k[0] == kind]
        return max(keys, key=lambda k: (self.shapes[k], k)) if keys \
            else None


class RopeRecorder:
    """Wraps the RoPE wrapper during a run: counts the calls by (x's
    shape, theta) and by x's dtype, and keeps a copy of the first call's
    inputs for each shape (x as fp32), so the path's own shapes and data
    can be replayed after the run. The wrapper counts its launches on the
    module's ``rope``, so the count moves to the stand-in and back."""

    def __init__(self, rops):
        self.rops, self.orig = rops, rops.rope
        self.shapes = collections.Counter()
        self.dtypes = collections.Counter()
        self.calls = {}

    def __enter__(self):
        orig = self.orig

        def rec(x, pos, *, theta, inverse=False):
            key = (tuple(x.shape), float(theta))
            self.shapes[key] += 1
            self.dtypes[str(x.dtype).replace("torch.", "")] += 1
            if key not in self.calls:
                self.calls[key] = (x.float().clone(), pos.clone(),
                                   float(theta))
            return orig(x, pos, theta=theta, inverse=inverse)
        rec.launches = orig.launches
        self.rops.rope = rec
        return self

    def __exit__(self, *exc):
        self.orig.launches = self.rops.rope.launches
        self.rops.rope = self.orig

    def most_frequent(self):
        return max(self.shapes, key=lambda k: (self.shapes[k], k)) \
            if self.shapes else None


def check_kernels(dev):
    import numpy as np

    rng = np.random.default_rng(0)
    rows = {}
    # ---- chunk attention, at the kernel table's shape ----
    rows["chunk_attention"] = measure_chunk("table", chunk_inputs(rng, dev))
    # ---- decode attention, dense arena and paged pool ----
    tables = {"dense table": ("dense", decode_inputs(rng, dev)),
              "paged table": ("paged", paged_inputs(rng, dev))}
    rows["decode_attention"] = measure_decode("table",
                                              tables["dense table"][1])
    rows["paged_decode_attention"] = measure_paged("table",
                                                   tables["paged table"][1])
    # ---- gemma3-4b's shapes: D 256, G 2, the 1024-key window ----
    ci = chunk_inputs_d256(rng, dev)
    rows["chunk_attention_d256"] = measure_chunk("d256", ci)
    for dt, r in time_head_dim_halves(ci).items():
        rows["chunk_attention_d256"][dt]["ms_d128_half"] = r["ms_d128"]
    rows["decode_attention_d256"] = measure_decode("d256", decode_inputs(
        rng, dev, S=2048, H=8, Hkv=4, D=256, lens=(2000, 1600, 1200, 600),
        window=1024))
    rows["paged_decode_attention_d256"] = measure_paged("d256", paged_inputs(
        rng, dev, H=8, Hkv=4, D=256, nblk=(128, 100, 60, 20), window=1024))
    return rows, tables


def ssd_inputs(rng, dev):
    """The intra-chunk block of one full-width mamba2-370m prefill of 4
    rows x 1920 tokens: nC 60 chunks of L 128, H 32 heads of P 64, state N
    128. Distributions as the model makes them: dt = softplus(N(0, 1)),
    A = -U(1, 8) per head, log_a = dt * A, xdt = x * dt with x ~ N(0, 1),
    B/C ~ N(0, 1)."""
    import numpy as np
    import torch
    nC, L, H, P, N = 60, 128, 32, 64, 128
    dt = np.log1p(np.exp(rng.normal(size=(nC, L, H)))).astype(np.float32)
    A = -rng.uniform(1, 8, size=H).astype(np.float32)
    f = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)  # noqa
    return dict(
        xdt=f(rng.normal(size=(nC, L, H, P)).astype(np.float32)
              * dt[..., None]),
        log_a=f(dt * A),
        B=f(rng.normal(size=(nC, L, N)).astype(np.float32)),
        C=f(rng.normal(size=(nC, L, N)).astype(np.float32)))


def _ssd_bound(nC, L, H, P, N, nbytes, dt_name):
    """The SSD block's bound on the route the kernel takes, and the
    CUDA-core figure beside it: S = C B^T once per chunk and the decay
    products on the CUDA cores in fp32; the two per-head products on the
    tensor cores as three passes (3xTF32 for fp32 inputs, hi + mid + lo
    bf16 parts for bf16). Returns (bound ms, by, CUDA-core ms, GFLOP of
    one pass)."""
    pairs = L * (L + 1) // 2            # causal (i >= j) pairs per chunk
    core = nC * (2 * N * pairs + H * pairs)        # C B^T, decay * scores
    tc = nC * (2 * H * P * pairs + 2 * H * P * N * L)   # y and states
    peaks = _roofline().PEAK_FLOPS_BY_TYPE
    rate = peaks["tf32" if dt_name == "float32" else "bfloat16"]
    t_ops = core / peaks["float32"] + TF32_PASSES * tc / rate
    t_b = nbytes / _roofline().HBM_BW
    b_cores = max(t_b, (core + tc) / peaks["float32"]) * 1e3
    return (max(t_b, t_ops) * 1e3, "bytes" if t_b >= t_ops else
            "operations", b_cores, (core + tc) / 1e9)


def check_ssd(dev):
    """ssd_intra vs its plain version at the mamba2 path's shapes. The
    check is the reference's ``assert_allclose(rtol=tol, atol=tol)``:
    |y| reaches ~450 here, where fp32 sums taken in another order may
    differ by more than tol in absolute terms. Two launches must give the
    same bytes. Timed with CUDA events and in device time."""
    import numpy as np
    import torch

    from repro_torch.kernels.ssd import ops as sops
    from repro_torch.kernels.ssd.ref import ssd_intra_ref

    si = ssd_inputs(np.random.default_rng(1), dev)
    nC, L, H, P = si["xdt"].shape
    N = si["B"].shape[-1]
    res = {}
    for dt_name in ("float32", "bfloat16"):
        dt = getattr(torch, dt_name)
        args = [si[k].to(dt) for k in ("xdt", "log_a", "B", "C")]
        y, st = sops.ssd_intra(*args)
        y2, st2 = sops.ssd_intra(*args)
        torch.cuda.synchronize()
        if not (torch.equal(y, y2) and torch.equal(st, st2)):
            raise RuntimeError(f"ssd_intra {dt_name}: two launches on the "
                               "same inputs differ")
        yr, sr = ssd_intra_ref(*args)
        tol = TOL[dt_name]
        e, worst_ratio = 0.0, 0.0
        for a, b in ((y, yr), (st, sr)):
            d = (a - b).abs()
            e = max(e, float(d.max()))
            worst_ratio = max(worst_ratio,
                              float((d / (tol + tol * b.abs())).max()))
        # the same ratio against fp32's 3e-5, which bf16 inputs also meet
        # (both versions compute in fp32 from the same rounded inputs)
        ratio32 = max(float(((a - b).abs() / (3e-5 + 3e-5 * b.abs())).max())
                      for a, b in ((y, yr), (st, sr)))
        if not (worst_ratio <= 1.0 and torch.isfinite(y).all()
                and torch.isfinite(st).all()):
            raise RuntimeError(f"ssd_intra {dt_name}: max abs err {e}, "
                               f"{worst_ratio:.3f}x the allclose bound "
                               f"(rtol = atol = {tol})")
        t_k = cuda_ms(lambda: sops.ssd_intra(*args))
        d_k = device_ms(lambda: sops.ssd_intra(*args))
        t_p = cuda_ms(lambda: ssd_intra_ref(*args), iters=5)
        el = args[0].element_size()
        nbytes = (nC * L * H * P + nC * L * H + 2 * nC * L * N) * el + \
            4 * (nC * L * H * P + nC * H * P * N)
        b_ms, b_by, b_cores, gflop = _ssd_bound(nC, L, H, P, N, nbytes,
                                               dt_name)
        hg = sops.heads_per_cta(nC, L, H, P, N, dt)
        res[dt_name] = dict(err=e, ms=t_k, device_ms=d_k, plain_ms=t_p,
                            library_ms=None, bound_ms=b_ms, bound_by=b_by,
                            bound_ms_cuda_cores=b_cores, heads_per_cta=hg,
                            worst_ratio=worst_ratio, ratio_3e5=ratio32)
        log(f"kernel ssd_intra {dt_name} nC={nC} L={L} H={H} P={P} N={N} "
            f"heads_per_cta={hg}: max_abs_err={e:.3e} (max |y| "
            f"{float(yr.abs().max()):.2f}; {worst_ratio:.4f}x the allclose "
            f"bound, rtol = atol = {tol}; {ratio32:.4f}x at 3e-5) two "
            f"launches identical ms={t_k:.4f} device_ms={_fmt(d_k)} "
            f"plain_ms={t_p:.4f} library_ms=none bound_ms={b_ms:.4f} "
            f"({b_by}, products as {TF32_PASSES} tensor-core passes; "
            f"CUDA cores {b_cores:.4f}; {gflop:.2f} GFLOP a pass, "
            f"{nbytes / 1e6:.1f} MB)")
    return res


def sweep_ssd_heads(groups=(1, 2, 4, 8, 16, 32)):
    """Times ssd_intra at the smoke shape with every number of heads per
    CTA whose plan fits, through the wrapper with ``heads_per_cta`` held,
    with CUDA events (and in device time), beside the count the rule
    picks. Every count must give the rule's bytes. Returns {dtype:
    {"rule", "best", "times": {hg: {...}}}}."""
    import numpy as np
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels.ssd import ops as sops

    si = ssd_inputs(np.random.default_rng(1), torch.device("cuda"))
    nC, L, H, P = si["xdt"].shape
    N = si["B"].shape[-1]
    rule = sops.heads_per_cta
    slib = sops.bind(build.load("ssd"))
    res = {}
    try:
        for dt_name in ("float32", "bfloat16"):
            dt = getattr(torch, dt_name)
            args = [si[k].to(dt) for k in ("xdt", "log_a", "B", "C")]
            pick = rule(nC, L, H, P, N, dt)
            want = sops.ssd_intra(*args)
            row = {}
            for hg in groups:
                if hg > H or sops.smem_bytes(L, N, P, hg, dt) > \
                        sops._SMEM_MAX:
                    continue
                sops.heads_per_cta = lambda *a, hg=hg: hg
                got = sops.ssd_intra(*args)
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip(got, want)):
                    raise RuntimeError(f"ssd_intra {dt_name}: {hg} heads "
                                       "per CTA differ from the rule's "
                                       f"{pick}")
                row[hg] = dict(
                    device_ms=device_ms(lambda: sops.ssd_intra(*args)),
                    ms=cuda_ms(lambda: sops.ssd_intra(*args)),
                    ctas=nC * -(-H // hg),
                    ctas_per_sm=slib.ssd_intra_occupancy(
                        L, N, P, hg, int(dt == torch.bfloat16)))
            sops.heads_per_cta = rule
            # a profiled window now and then misses kernels; a call here
            # is long enough that events time the card, so pick by them
            best = min(row, key=lambda k: row[k]["ms"])
            res[dt_name] = dict(rule=pick, best=best, times=row)
            log(f"ssd_intra head-group sweep {dt_name} nC={nC} L={L} H={H} "
                f"(rule {pick}, fastest {best}; same bytes at every count): "
                + ", ".join(f"{hg}: events {r['ms']:.4f} ms dev "
                            f"{_fmt(r['device_ms'])} ms ({r['ctas']} CTAs, "
                            f"{r['ctas_per_sm']}/SM)"
                            for hg, r in row.items()))
    finally:
        sops.heads_per_cta = rule
    return res


def rope_inputs(rng, dev):
    """The two shapes of the chunk-cache RPE path, as the executor hands
    them to the kernel (``core/prefill.py`` ``rope_np``: K of all layers,
    one position vector shared by the layers): ``path``, K of one 48-token
    chunk of llama3-8b [L 32, n 48, Hkv 8, D 128] at a layout span ending
    near 2.6k; ``span``, a 1024-token span [32, 1024, 8, 128] at sorted
    positions drawn from 0..8191."""
    import numpy as np
    import torch
    L, Hkv, D = 32, 8, 128
    start = int(rng.integers(2000, 2600 - 48))
    shapes = {"path": (48, np.arange(start, start + 48)),
              "span1024": (1024, np.sort(rng.choice(8192, 1024,
                                                    replace=False)))}
    out = {}
    for name, (n, pos) in shapes.items():
        out[name] = (
            torch.from_numpy(rng.normal(size=(L, n, Hkv, D))
                             .astype(np.float32)).to(dev),
            torch.from_numpy(pos.astype(np.int32)).to(dev))
    return out


def measure_rope(label, x32, pos, theta):
    """rope on ``x32`` ([L, n, H, D] fp32, ``pos [n]`` shared by the
    layers) against its plain version, fp32 (3e-5) and bf16 (3e-2),
    applying and removing; one whole-stack call vs one call per layer
    (byte for byte, the streamed == eager contract); remove o apply == id
    (2e-5). No single PyTorch call computes RoPE, so there is no library
    yardstick. The bound counts x read and out written once, plus the
    positions and the frequencies."""
    import torch

    from repro_torch.kernels.rope import ops as rops
    from repro_torch.kernels.rope.ref import rope_ref

    L, n, H, D = x32.shape
    res = {}
    for dt_name in ("float32", "bfloat16"):
        x = x32.to(getattr(torch, dt_name))
        e = 0.0
        for inverse in (False, True):
            o = rops.rope(x, pos, theta=theta, inverse=inverse)
            torch.cuda.synchronize()
            r = rope_ref(x.reshape(L * n, H, D), pos.repeat(L),
                         theta=theta, inverse=inverse).reshape(x.shape)
            e = max(e, float((o.float() - r.float()).abs().max()))
            if not (e <= TOL[dt_name] and torch.isfinite(o).all()):
                raise RuntimeError(f"rope {label} {dt_name} inverse="
                                   f"{inverse}: max abs err {e} > "
                                   f"{TOL[dt_name]}")
        per_layer = torch.cat([rops.rope(x[l:l + 1].contiguous(), pos,
                                         theta=theta) for l in range(L)])
        if not torch.equal(per_layer, rops.rope(x, pos, theta=theta)):
            raise RuntimeError(f"rope {label} {dt_name}: per-layer calls "
                               "differ from the whole-stack call")
        t_k = cuda_ms(lambda: rops.rope(x, pos, theta=theta))
        # device time alone: at the path's shape the events above mostly
        # time the wrapper's host work
        d_k = device_ms(lambda: rops.rope(x, pos, theta=theta))
        t_p = cuda_ms(lambda: rope_ref(
            x.reshape(L * n, H, D), pos.repeat(L), theta=theta))
        # the wrapper's host time per call (checks, ctypes, enqueue; no
        # sync): where it exceeds the kernel's device time, the
        # event-timed ms above is the host's, not the card's
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(50):
            rops.rope(x, pos, theta=theta)
        t_h = (time.perf_counter() - t0) / 50 * 1e3
        torch.cuda.synchronize()
        el = x.element_size()
        nbytes = 2 * x.numel() * el + 4 * n + 4 * D // 2
        # per (t, h, i) pair: the angle and 6 products / sums; the cos /
        # sin evaluations are not counted (bytes bound anyway)
        b_ms, b_by = bound(nbytes, 7 * x.numel() // 2, dt_name)
        res[dt_name] = dict(err=e, ms=t_k, device_ms=d_k, plain_ms=t_p,
                            library_ms=None, bound_ms=b_ms, bound_by=b_by,
                            host_ms=t_h)
        log(f"kernel rope {label} {dt_name} [{L}, {n}, {H}, {D}] theta "
            f"{theta:g} pos {int(pos.min())}..{int(pos.max())}: "
            f"max_abs_err={e:.3e} (tol {TOL[dt_name]}) per-layer == "
            f"whole-stack ms={t_k:.4f} device_ms={_fmt(d_k)} plain_ms="
            f"{t_p:.4f} library_ms=none bound_ms={b_ms:.4f} ({b_by}; "
            f"{nbytes / 1e6:.2f} MB) host_ms_per_call={t_h:.4f}")
    back = rops.rope(rops.rope(x32, pos, theta=theta), pos, theta=theta,
                     inverse=True)
    rt = float((back - x32).abs().max())
    log(f"kernel rope {label}: remove o apply vs x max abs diff {rt:.3e} "
        "(tol 2e-5)")
    if not rt <= 2e-5:
        raise RuntimeError(f"rope {label}: round trip {rt} > 2e-5")
    return res


def check_rope(dev):
    """rope at llama3-8b's RPE path shapes (``rope_inputs``), as
    ``measure_rope``."""
    import numpy as np

    theta = 5e5                        # llama3-8b's rope_theta
    return {name: measure_rope(name, x32, pos, theta)
            for name, (x32, pos) in rope_inputs(np.random.default_rng(2),
                                                dev).items()}


# ---------------------------------------------------------------------------
# phase 4: mamba2-370m prefill and decode
# ---------------------------------------------------------------------------
def mamba_layer_gap(cfg, params, toks, T0, dev):
    """Layer by layer, one input through two paths: a prefill of all
    tokens (the ssd_intra kernel) and a prefill of the first T0 tokens
    followed by one decode step per later token (plain recurrence). Both
    get the same hidden states, so the random model's amplification of
    rounding through depth does not enter. Returns the largest difference
    of the block outputs over all layers and decoded positions."""
    import torch

    from repro_torch.models import model as M

    B, T = toks.shape
    arange = torch.arange(T, dtype=torch.int32, device=dev).expand(B, T)
    h = M.embed_tokens(cfg, params, toks)
    worst = 0.0
    for g in range(cfg.num_layers):
        p = {n: x[g] for n, x in params["groups"][0].items()}

        def block(mode, x, pos, state):
            ctx = M.Ctx(cfg=cfg, mode=mode, positions=pos)
            return M.apply_block(ctx, "ssd", p, x, state)[0]

        def fresh(n):
            return M.init_layer_cache(cfg, "ssd", B, n, torch.float32, dev)

        h_full = block("prefill", h, arange, fresh(T))
        st = fresh(T0)
        block("prefill", h[:, :T0], arange[:, :T0], st)
        dec = torch.cat([block("decode", h[:, t:t + 1], arange[:, t:t + 1],
                               st) for t in range(T0, T)], dim=1)
        worst = max(worst, float((dec - h_full[:, T0:]).abs().max()))
        h = h_full
    return worst


def run_mamba2(dev):
    """Prefill 4 x 1920 tokens, decode the next 128 teacher-forced and
    hold each step's logits against one 2048-token prefill at the same
    position; then 8 greedy tokens. Returns (figures, ssd launches)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd import ops as sops
    from repro_torch.models import model as M
    from repro_torch.training import steps

    cfg = get_config("mamba2-370m")
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = M.init_params(cfg, gen)
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in [params["embed"], params["unembed"],
                                        params["final_norm"]]
                   + [x for g in params["groups"] for x in g.values()])
    log(f"params: {cfg.name} {n_params / 1e6:.1f}M fp32 on {dev} in "
        f"{time.perf_counter() - t0:.1f}s ({cfg.num_layers} ssd layers, "
        f"d_model {cfg.d_model}, d_inner {cfg.d_inner}, {cfg.ssm_heads} "
        f"heads of {cfg.ssm_head_dim}, state {cfg.ssm_state}, chunk "
        f"{cfg.ssd_chunk}, vocab {cfg.vocab_size} -> {cfg.padded_vocab})")
    B, T0, n_dec, n_greedy = 4, 1920, 128, 8
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, T0 + n_dec))
                            .astype(np.int32)).to(dev)
    prefill = steps.make_prefill_step(cfg)
    decode = steps.make_decode_step(cfg)

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    sops.ssd_intra.launches = 0
    n_prefill = 0
    pre_ms = []
    for _ in range(3):        # the first call is warm-up
        cache = M.init_cache(cfg, B, T0, device=dev)
        (last, cache), ms = timed(lambda: prefill(
            params, {"tokens": toks[:, :T0], "cache": cache}))
        pre_ms.append(ms)
        n_prefill += 1
    greedy_cache = {"groups": [{n: x.clone() for n, x in g.items()}
                               for g in cache["groups"]], "tail": []}

    launched = sops.ssd_intra.launches
    dec, dec_ms = [], []
    for t in range(n_dec):
        pos = torch.full((B,), T0 + t, dtype=torch.int32, device=dev)
        (lg, cache), ms = timed(lambda: decode(
            params, {"tokens": toks[:, T0 + t], "positions": pos,
                     "cache": cache}))
        dec.append(lg[:, 0])
        dec_ms.append(ms)
    if sops.ssd_intra.launches != launched:
        raise RuntimeError("mamba2: decode steps launched ssd_intra")

    def prefill_all(prm):
        return M.forward(cfg, prm, tokens=toks, mode="prefill",
                         cache=M.init_cache(cfg, B, T0 + n_dec, device=dev),
                         logits_slice="all").logits[:, T0 - 1:]

    full, full_ms = timed(lambda: prefill_all(params))
    n_prefill += 1
    diffs = torch.stack([(d - full[:, 1 + t]).abs().amax()
                         for t, d in enumerate(dec)]).cpu().numpy()
    pre_diff = float((last[:, 0] - full[:, 0]).abs().max())
    if not (torch.isfinite(full).all() and torch.isfinite(last).all()
            and all(bool(torch.isfinite(d).all()) for d in dec)):
        raise RuntimeError("mamba2: non-finite logits")
    worst = float(diffs.max())
    del dec

    # greedy continuation of the prompts
    cache = greedy_cache
    tok = last[:, 0, :cfg.vocab_size].argmax(-1).to(torch.int32)
    gen_toks = [tok]
    for k in range(n_greedy):
        pos = torch.full((B,), T0 + k, dtype=torch.int32, device=dev)
        lg, cache = decode(params, {"tokens": tok, "positions": pos,
                                    "cache": cache})
        if not bool(torch.isfinite(lg).all()):
            raise RuntimeError(f"mamba2: greedy step {k}: non-finite")
        tok = lg[:, 0, :cfg.vocab_size].argmax(-1).to(torch.int32)
        gen_toks.append(tok)
    greedy = torch.stack(gen_toks, 1).cpu().tolist()

    launches = sops.ssd_intra.launches
    if launches != cfg.num_layers * n_prefill:
        raise RuntimeError(f"mamba2: ssd_intra launched {launches} times, "
                           f"expected {cfg.num_layers} x {n_prefill} "
                           "prefill calls")
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9

    # comparisons (after the counted run): the fp32 noise floor of the
    # logits, one ulp on the embeddings; then the per-layer gap
    nudged = dict(params)
    gen.manual_seed(1)
    nudged["embed"] = params["embed"] * (1 + 6e-8 * torch.randn(
        params["embed"].shape, generator=gen, device=dev))
    noise = float((prefill_all(nudged)[:, 1:] - full[:, 1:]).abs().max())
    del nudged, full
    layer_gap = mamba_layer_gap(cfg, params, toks, T0, dev)
    log(f"mamba2 decode vs 2048-token prefill: per layer, same inputs, "
        f"max abs diff of block outputs {layer_gap:.3e} (tol "
        f"{MAMBA_LAYER_TOL}); logits max abs diff {worst:.3e} (by step "
        "0/31/63/95/127: "
        + " ".join(f"{diffs[i]:.2e}" for i in (0, 31, 63, 95, 127))
        + f"; prefill's last position {pre_diff:.3e}) vs {noise:.3e} from "
        f"one ulp on the embeddings (tol {MAMBA_NOISE_FACTOR} x that)")
    if not layer_gap <= MAMBA_LAYER_TOL:
        raise RuntimeError(f"mamba2: decode vs prefill differ by "
                           f"{layer_gap} in some layer > {MAMBA_LAYER_TOL}")
    if not (0 < noise and worst <= MAMBA_NOISE_FACTOR * noise):
        raise RuntimeError(f"mamba2: decode logits vs prefill {worst} > "
                           f"{MAMBA_NOISE_FACTOR} x the noise floor {noise}")

    step_s = float(np.mean(dec_ms[3:])) / 1e3   # the first 3: warm-up
    figs = dict(
        batch=B, prompt_tokens=T0, prefill_calls=n_prefill,
        prefill_ms=float(np.mean(pre_ms[1:])), prefill_ms_first=pre_ms[0],
        prefill_tokens_per_s=B * T0 / (np.mean(pre_ms[1:]) / 1e3),
        full_prefill_2048_ms=full_ms, decode_steps=n_dec,
        decode_step_ms=step_s * 1e3,
        decode_step_ms_p50=float(np.median(dec_ms[3:])),
        decode_tokens_per_s=B / step_s, layer_gap=layer_gap,
        max_abs_logit_diff=worst, logit_noise_floor=noise,
        peak_mem_gb=peak_gb)
    log(f"mamba2: {json.dumps(figs)}; ssd_intra launches {launches} = "
        f"{cfg.num_layers} x {n_prefill} prefill calls; greedy tokens "
        f"{greedy}")
    del params, cache, greedy_cache, last
    gc.collect()
    torch.cuda.empty_cache()
    return figs, launches


# ---------------------------------------------------------------------------
# phase 5: training
# ---------------------------------------------------------------------------
# each training run: global batch 4 x 1024 tokens in 2 microbatches, 8
# AdamW steps, the lr warming up over the first 2. Mamba2's peak lr is
# higher: its init's grad norm (~1e5) clips every gradient element below
# ~1e-3 under AdamW's eps, and at 3e-4 its loss fell less in 8 steps than
# it varies between batches. TRAIN_HELD is a batch no step trains on.
TRAIN_BATCH, TRAIN_SEQ, TRAIN_ACCUM, TRAIN_STEPS = 4, 1024, 2, 8
TRAIN_LR = {"ssm": 3e-3, "dense": 3e-4, "moe": 3e-4,   # by model family
            "hybrid": 3e-4}
TRAIN_HELD = 1000


def _train_opt(cfg):
    return dict(peak_lr=TRAIN_LR[cfg.family], warmup_steps=2,
                total_steps=TRAIN_STEPS)


def _train_setup(cfg, dev, seed=0):
    """A fresh ``TrainState`` from ``seed`` on the card, its train step
    and the synthetic data."""
    import torch

    from repro_torch.training import steps as TS
    from repro_torch.training.data import DataConfig, SyntheticLM
    from repro_torch.training.optimizer import AdamWConfig
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    state = TS.init_train_state(cfg, gen)
    step = TS.make_train_step(cfg, AdamWConfig(**_train_opt(cfg)),
                              accum=TRAIN_ACCUM)
    data = SyntheticLM(DataConfig(seq_len=TRAIN_SEQ,
                                  global_batch=TRAIN_BATCH,
                                  vocab_size=cfg.vocab_size))

    def batch(i):
        return {k: torch.from_numpy(v).to(dev)
                for k, v in data.batch(i).items()}
    return state, step, batch


def _eval_loss(cfg, state, b):
    import torch

    from repro_torch.training import steps as TS
    with torch.no_grad():
        return float(TS.loss_fn(cfg, state.params, b)[0])


def grad_norm_witness(cfg, state, b, seq=128):
    """The global grad norm of ``state``'s params on the first sequence of
    ``b`` cut to ``seq`` tokens, on the card and on the host's CPU (the
    same params copied there, the plain path): the norm is the model's,
    not the card's."""
    import torch

    from repro_torch.training import steps as TS
    from repro_torch.training.optimizer import global_norm, tree_leaves, \
        tree_map
    b = {k: v[:1, :seq] for k, v in b.items()}
    out = {}
    for where, params in (("card", state.params), ("cpu", tree_map(
            lambda x: x.detach().cpu().requires_grad_(), state.params))):
        batch = {k: v.to(next(tree_leaves(params)).device)
                 for k, v in b.items()}
        loss = TS.loss_fn(cfg, params, batch)[0]
        out[where] = float(global_norm(torch.autograd.grad(
            loss, list(tree_leaves(params)))))
        del loss, params
    out["rel_gap"] = abs(out["card"] - out["cpu"]) / out["cpu"]
    return out


def train_run(cfg, dev, card):
    """``TRAIN_STEPS`` train steps of ``cfg`` from random weights: each
    step timed with CUDA events, the loss and grad norm of every step.
    Requires finite losses, the last below the first, and a control: the
    loss on the held-out batch ``TRAIN_HELD`` falls over the run by more
    than the loss varies between the run's batches at the initial params.
    Before training, the grad norm at the initial params on the card
    against the host CPU (``grad_norm_witness``). Returns the figures
    (step ms and tokens/s after one warm-up step, peak memory)."""
    import numpy as np
    import torch

    from repro_torch.training.optimizer import tree_leaves

    rl = _roofline()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    state, step, batch = _train_setup(cfg, dev)
    n_params = sum(x.numel() for x in tree_leaves(state.params))
    t0 = time.perf_counter()
    witness = grad_norm_witness(cfg, state, batch(0))
    init = [_eval_loss(cfg, state, batch(i)) for i in range(TRAIN_STEPS)]
    held = batch(TRAIN_HELD)
    held_before = _eval_loss(cfg, state, held)
    control_s = time.perf_counter() - t0
    losses, grad_norms, ms = [], [], []
    for i in range(TRAIN_STEPS):
        b = batch(i)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        state, m = step(state, b)
        e1.record()
        torch.cuda.synchronize()
        ms.append(e0.elapsed_time(e1))
        losses.append(float(m["loss"]))
        grad_norms.append(float(m["grad_norm"]))
    held_after = _eval_loss(cfg, state, held)
    spread = max(init) - min(init)
    peak = torch.cuda.max_memory_allocated(dev)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    step_ms = float(np.mean(ms[1:]))
    figs = dict(
        model=cfg.name, layers=cfg.num_layers, params=n_params,
        batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, accum=TRAIN_ACCUM,
        steps=TRAIN_STEPS, lr=_train_opt(cfg), losses=losses,
        grad_norms=grad_norms, grad_norm_witness=witness,
        init_losses=init, init_spread=spread, held_before=held_before,
        held_after=held_after, held_drop=held_before - held_after,
        control_s=control_s,
        step_ms=step_ms, step_ms_min=float(np.min(ms[1:])),
        step_ms_max=float(np.max(ms[1:])), step_ms_first=ms[0],
        tokens_per_s=tokens / (step_ms / 1e3),
        # the model FLOPs of a step (roofline.model_flops_6nd: 6 x
        # params x tokens, the embedding included, remat's second forward
        # and attention's products not) and their share of the fp32 peak
        # (TF32 is off): the MFU, as the reference's roofline defines it
        model_tflops_per_s=rl.model_flops_6nd(
            cfg, "train", TRAIN_BATCH, TRAIN_SEQ) / (step_ms / 1e3) / 1e12,
        mfu_fp32=rl.model_flops_6nd(cfg, "train", TRAIN_BATCH, TRAIN_SEQ)
        / (step_ms / 1e3) / rl.PEAK_FLOPS_BY_TYPE["float32"],
        peak_mem_gb=peak / 1e9)
    log(f"train {cfg.name} ({cfg.num_layers} layers, {n_params / 1e9:.3f}B "
        f"params fp32) [{card}]: " + json.dumps(figs))
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"train {cfg.name}: non-finite loss {losses}")
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"train {cfg.name}: loss did not fall: {losses}")
    if not held_before - held_after > spread:
        raise RuntimeError(
            f"train {cfg.name}: the held-out loss fell "
            f"{held_before - held_after:.4f}, not more than the "
            f"{spread:.4f} it varies between batches")
    # the 48-layer mamba2 amplifies rounding (one ulp on the embeddings
    # moves its logits by O(1)), so its card and CPU norms are held to
    # the same magnitude only; the check at 2 layers is tight
    if not witness["rel_gap"] < (0.5 if cfg.family == "ssm" and
                                 cfg.num_layers > 2 else 1e-3):
        raise RuntimeError(f"train {cfg.name}: grad norm card vs CPU "
                           f"{witness}")
    del state, step, m
    return figs


def train_resume_check(cfg, dev, tmp):
    """3 straight steps == 2 steps + ``checkpoint.save`` / ``restore`` + 1,
    byte for byte in every leaf (params, both moments, count, step)."""
    import torch

    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training import steps as TS
    from repro_torch.training.optimizer import tree_leaves

    state, step, batch = _train_setup(cfg, dev)
    witness = grad_norm_witness(cfg, state, batch(0))
    log(f"grad norm at init, {cfg.name} ({cfg.num_layers} layers), one "
        f"128-token sequence: {json.dumps(witness)}")
    if not witness["rel_gap"] < 1e-3:
        raise RuntimeError(f"resume: grad norm card vs CPU {witness}")
    for i in range(3):
        state, _ = step(state, batch(i))
    straight = TS.state_to_tree(state)
    half, step, _ = _train_setup(cfg, dev)
    for i in range(2):
        half, _ = step(half, batch(i))
    t0 = time.perf_counter()
    ckpt.save(TS.state_to_tree(half), tmp, 2)
    del half
    resumed = TS.tree_to_state(ckpt.restore(tmp), dev)
    io_s = time.perf_counter() - t0
    if int(resumed.step) != 2:
        raise RuntimeError(f"resume: restored step {int(resumed.step)}")
    resumed, _ = step(resumed, batch(2))
    leaves = list(zip(tree_leaves(straight),
                      tree_leaves(TS.state_to_tree(resumed))))
    differ = sum(not torch.equal(a, b) for a, b in leaves)
    nbytes = sum(os.path.getsize(os.path.join(tmp, "step_00000002", f))
                 for f in os.listdir(os.path.join(tmp, "step_00000002")))
    log(f"train resume {cfg.name} ({cfg.num_layers} layers): 3 straight "
        f"steps vs 2 + save / restore + 1: {len(leaves) - differ}/"
        f"{len(leaves)} leaves byte-identical; checkpoint {nbytes / 1e9:.2f} "
        f"GB, save + restore {io_s:.1f} s")
    if differ:
        raise RuntimeError(f"resume: {differ} of {len(leaves)} leaves "
                           "differ from the straight run")
    return dict(leaves=len(leaves), checkpoint_gb=nbytes / 1e9,
                save_restore_s=io_s, grad_norm_witness=witness)


def _train_tiny(steps, ckdir, want=None):
    """``examples/torch_train_tiny.py --steps <steps>`` on ``ckdir`` (the
    card, as a user runs it); raises unless it exits 0 having trained to
    ``steps`` on the card and printed ``want``."""
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples",
                                      "torch_train_tiny.py"),
         "--steps", str(steps), "--ckpt-dir", ckdir],
        env=_example_env(), cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    log(f"examples/torch_train_tiny.py --steps {steps} (exit "
        f"{r.returncode}, {time.perf_counter() - t0:.1f}s): "
        + " | ".join(r.stdout.strip().splitlines()[-3:]))
    done = f"done: {steps} steps on cuda"
    if r.returncode != 0 or done not in r.stdout or \
            (want and want not in r.stdout):
        raise RuntimeError(f"torch_train_tiny.py --steps {steps} failed: "
                           f"{(r.stdout + r.stderr)[-3000:]}")


def run_training(dev, card):
    """Phase 5: full-width mamba2-370m (48 layers) and llama3-8b cut to 2
    layers trained for ``TRAIN_STEPS`` steps; the resume check on
    full-width mamba2-370m cut to 2 layers; ``examples/torch_train_tiny.py``
    (``launch.train --tiny``) on the card for 20 steps, then for 22 on
    its checkpoint, and a tiny engine serving that
    checkpoint (``params_path``, ``attn_impl="kernel"``) the smoke's 12
    requests. The in-process training runs reach no kernel (the launch
    counts stay 0 through them; the example runs in its own process,
    where these counts cannot see it); the engine's kernel launches are
    counted on their own. Returns the figures."""
    import torch

    from repro_torch.configs import get_config, get_tiny
    from repro_torch.kernels.chunk_attention import ops as cops
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.rope import ops as rops
    from repro_torch.kernels.ssd import ops as sops

    counters = {"chunk_attention": cops.chunk_attention,
                "decode_attention": dops.decode_attention,
                "paged_decode_attention": dops.paged_decode_attention,
                "rope": rops.rope, "ssd_intra": sops.ssd_intra}

    def zero():
        for fn in counters.values():
            fn.launches = 0

    def read():
        return {n: fn.launches for n, fn in counters.items()}

    t_all = time.perf_counter()
    zero()
    figs = {"mamba2-370m": train_run(get_config("mamba2-370m"), dev, card),
            "llama3-8b/2": train_run(get_config("llama3-8b").replace(
                num_layers=2), dev, card)}
    with tempfile.TemporaryDirectory(prefix="chip-smoke-train-") as tmp:
        figs["resume"] = train_resume_check(
            get_config("mamba2-370m").replace(num_layers=2), dev,
            os.path.join(tmp, "resume"))
        during = read()
        if any(during.values()):
            raise RuntimeError(f"training launched kernels: {during}")
        gc.collect()
        torch.cuda.empty_cache()
        # the port's train_tiny example (launch.train on the tiny config),
        # run as a user runs it, then resumed from its checkpoint
        ckdir = os.path.join(tmp, "tiny")
        _train_tiny(20, ckdir)
        _train_tiny(22, ckdir, want="resumed from step 20")
        zero()
        served = run_engine("T", get_tiny("llama3-8b"), None,
                            tmp, params_path=ckdir, attn_impl="kernel")[0]
        served_launches = read()
    log(f"training phase: kernel launches in the in-process training "
        f"runs {during}; serving "
        f"the tiny checkpoint {served_launches}; "
        f"{time.perf_counter() - t_all:.1f}s")
    for name in ("chunk_attention", "decode_attention", "rope"):
        if served_launches[name] <= 0:
            raise RuntimeError(f"params_path engine: no {name} launch")
    figs["served_from_checkpoint"] = dict(
        completed=served["completed"], launches=served_launches)
    gc.collect()
    torch.cuda.empty_cache()
    return figs


# ---------------------------------------------------------------------------
# phases 6-8: the engine on full-width llama3-8b
# ---------------------------------------------------------------------------
def smoke_engine(tag, cfg, params, tmp, num_requests=12, max_new_tokens=8,
                 kb_kw=None, **spec_kw):
    """A fresh engine with its own chunk store on the card, and the smoke
    workload (12 requests of 5 chunks from a 24-chunk knowledge base,
    arriving at once, 8 new tokens each; ``kb_kw`` overrides the knowledge
    base's chunk lengths)."""
    from repro_torch.serving.api import EngineSpec, StoreSpec, \
        build_engine, build_store
    from repro_torch.serving.rag import KnowledgeBase
    from repro_torch.serving.scheduler import SchedulerConfig
    from repro_torch.serving.workload import WorkloadConfig, generate

    store = build_store(StoreSpec(ssd_dir=os.path.join(tmp, tag)))
    spec = EngineSpec(strategy="cachecraft", pool_blocks=512,
                      sched=SchedulerConfig(max_decode_batch=4),
                      trace_decode=True, device="cuda", **spec_kw)
    eng = build_engine(spec, cfg=cfg, params=params, store=store)
    kb = KnowledgeBase(num_chunks=24, vocab_size=cfg.vocab_size, seed=0,
                       **(kb_kw or {}))
    reqs = generate(kb, WorkloadConfig(num_requests=num_requests, qpm=1e9,
                                       k_chunks=5,
                                       max_new_tokens=max_new_tokens))
    return eng, store, reqs


def run_engine(tag, cfg, params, tmp, num_requests=12, max_new_tokens=8,
               kb_kw=None, **spec_kw):
    import numpy as np

    eng, store, reqs = smoke_engine(tag, cfg, params, tmp, num_requests,
                                    max_new_tokens, kb_kw, **spec_kw)
    t0 = time.perf_counter()
    stats = eng.run(reqs)
    wall = time.perf_counter() - t0
    store.tiers.close()
    ttft = np.array([r.ttft for r in reqs if r.ttft is not None])
    dec_tokens = sum(len(r.output_tokens) for r in reqs) - stats.prefills
    out = dict(
        completed=stats.completed, failed=stats.failed,
        prefill_tokens_total=stats.prefill_tokens_total,
        prompt_tokens_max=max(r.prefill_tokens_total for r in reqs),
        prefill_tokens_computed=stats.prefill_tokens_computed,
        prefill_batches=stats.prefill_batches,
        prefill_batch_max=stats.prefill_batch_max,
        decode_steps=stats.decode_steps,
        ttft_mean_ms=float(ttft.mean() * 1e3) if ttft.size else None,
        ttft_p99_ms=float(np.percentile(ttft, 99) * 1e3)
        if ttft.size else None,
        prefill_pass_ms=stats.prefill_compute_s * 1e3
        / max(1, stats.prefill_batches),
        decode_step_ms=stats.decode_compute_s * 1e3
        / max(1, stats.decode_steps),
        decode_tokens_per_s=dec_tokens / max(stats.decode_compute_s, 1e-9),
        wall_s=wall,
        decode_gather_bytes=eng.counters.decode_gather_bytes,
        paged_block_syncs=eng.counters.paged_block_syncs,
        peak_kv_bytes_per_device=eng.pool.peak_kv_bytes_per_device(),
        attn_flops_total=eng.counters.attn_flops_total,
        attn_flops_device=eng.counters.attn_flops_device)
    log(f"engine {tag}: " + json.dumps(out))
    if stats.completed != len(reqs) or stats.failed:
        raise RuntimeError(f"engine {tag}: {stats.completed}/{len(reqs)} "
                           f"completed, {stats.failed} failed")
    for r in reqs:
        if len(r.output_tokens) != r.max_new_tokens:
            raise RuntimeError(f"engine {tag}: rid {r.rid} produced "
                               f"{len(r.output_tokens)} tokens")
    trace = eng.decode_trace
    tokens = {r.rid: list(r.output_tokens) for r in reqs}
    plans = {r.rid: (r.cache_hits, r.prefill_tokens_computed) for r in reqs}
    counters = eng.counters
    del eng, store
    gc.collect()
    return out, trace, tokens, plans, counters


def run_server(cfg, params, tmp, offline_tokens, tag="server"):
    """The port's HTTP server around a fresh ``kernel`` engine with its
    own store: the smoke workload's 12 requests submitted and streamed
    through ``ServeClient`` on 12 threads, one cancelled after its 2nd
    token. Required: every survivor ends done with max_new_tokens tokens,
    the cancelled stream ends cancelled with fewer, /health is ok, /stats
    shows nothing in flight and no reserved block after the drain, and
    the engine thread stops on shutdown. ``tag`` names the run in the log
    and its store's directory. Logged: how many survivor
    streams equal the offline engine A's tokens for the same rid (on the
    card a plan may depend on the measured window time, so bit identity
    is proved on the CPU, tests/test_torch_server.py), client-side TTFT
    (wall) and the total wall time."""
    import threading

    import numpy as np

    from repro_torch.serving.server import CacheCraftServer, ServeClient

    eng, store, reqs = smoke_engine(tag, cfg, params, tmp,
                                    attn_impl="kernel")
    cancel_rid = 5
    server = CacheCraftServer(eng, host="127.0.0.1", port=0).start()
    got, ttft, errors = {}, {}, []
    try:
        client = ServeClient(server.host, server.port, timeout=300.0)
        if not client.health().get("ok"):
            raise RuntimeError(f"{tag}: /health not ok at start")
        t0 = time.perf_counter()

        def reader(rid):
            try:
                seen = []

                def on_token(tok):
                    if not seen:
                        ttft[rid] = time.perf_counter() - t_sub[rid]
                    seen.append(tok)
                    if rid == cancel_rid and len(seen) == 2:
                        client.cancel(rid)
                got[rid] = client.stream(rid, on_token=on_token)
            except Exception as e:          # re-raised on the main thread
                errors.append(f"rid {rid}: {e!r}")

        t_sub, threads = {}, []
        for req in reqs:
            t_req = time.perf_counter()
            rid = client.submit(req)
            t_sub[rid] = t_req
            th = threading.Thread(target=reader, args=(rid,), daemon=True)
            th.start()
            threads.append(th)
        for th in threads:
            th.join(timeout=600)
        wall = time.perf_counter() - t0
        if errors or any(th.is_alive() for th in threads):
            raise RuntimeError(f"{tag}: stream readers failed or hung: "
                               f"{errors}")
        health = client.health()
        stats = client.stats()
    finally:
        server.shutdown()
        store.tiers.close()
    if server._thread.is_alive():
        raise RuntimeError(f"{tag}: engine thread still alive after "
                           "shutdown")
    if not health.get("ok"):
        raise RuntimeError(f"{tag}: /health {health}")
    if stats["server"]["inflight"] != 0 or \
            stats["pool"]["reserved_blocks"] != 0:
        raise RuntimeError(f"{tag}: after the drain inflight "
                           f"{stats['server']['inflight']}, reserved blocks "
                           f"{stats['pool']['reserved_blocks']}")
    same, n_new = 0, reqs[0].max_new_tokens
    for rid, (toks, state) in sorted(got.items()):
        if rid == cancel_rid:
            if not (state == "cancelled" and 2 <= len(toks) < n_new):
                raise RuntimeError(f"{tag}: cancelled rid {rid} ended "
                                   f"{state} with {len(toks)} tokens")
            continue
        if state != "done" or len(toks) != n_new:
            raise RuntimeError(f"{tag}: rid {rid} ended {state} with "
                               f"{len(toks)} tokens")
        same += toks == offline_tokens[rid]
    t = np.array([ttft[r] for r in sorted(ttft) if r != cancel_rid])
    c_toks = got[cancel_rid][0]
    out = dict(submitted=len(reqs), survivors_done=len(got) - 1,
               cancelled_tokens=len(c_toks),
               cancelled_prefix_of_offline_A=c_toks == offline_tokens[
                   cancel_rid][:len(c_toks)],
               survivors_equal_offline_A=int(same),
               ttft_wall_mean_ms=float(t.mean() * 1e3),
               ttft_wall_p99_ms=float(np.percentile(t, 99) * 1e3),
               wall_s=wall, completed=stats["completed"],
               cancelled=stats["cancelled"],
               reserved_blocks=stats["pool"]["reserved_blocks"],
               prefill_batches=eng.stats.prefill_batches,
               decode_steps=eng.stats.decode_steps)
    log(f"{tag}: " + json.dumps(out))
    del eng, store
    gc.collect()
    return out


def _per_rid(trace):
    """A decode trace (one {rid: logits} per step) -> {rid: [logits of
    each of its steps]}."""
    out = {}
    for step in trace:
        for rid, lg in step.items():
            out.setdefault(rid, []).append(lg)
    return out


def compare_logits(tag, trace, tokens, ref_trace, ref_tokens):
    """Per-request decode logits of ``tag`` vs the dense engine, step by
    step: compared while the request's tokens agree; where greedy tokens
    diverge, the dense logits' top-2 gap at that step must be within
    tolerance (a near tie), and the request is not compared past it. A
    request whose first (prefill) token differs is not compared."""
    import numpy as np

    mine, ref = _per_rid(trace), _per_rid(ref_trace)
    if set(mine) != set(ref):
        raise RuntimeError(f"{tag}: decoded requests differ from dense")
    worst, compared, diverged = 0.0, 0, []
    for rid in sorted(mine):
        for i, (a, b) in enumerate(zip(mine[rid], ref[rid])):
            if not (a.shape == b.shape and np.isfinite(a).all()):
                raise RuntimeError(f"{tag}: rid {rid} step {i}: bad logits")
            # decode step i feeds token i: compare only on equal inputs
            if tokens[rid][:i + 1] != ref_tokens[rid][:i + 1]:
                diverged.append(rid)
                break
            if int(a.argmax()) != int(b.argmax()):
                top2 = np.sort(b)[-2:]
                if top2[1] - top2[0] > LOGIT_TOL:
                    raise RuntimeError(
                        f"{tag}: rid {rid} step {i}: greedy token diverged "
                        f"with top-2 gap {top2[1] - top2[0]}")
                diverged.append(rid)
                break
            worst = max(worst, float(np.abs(a - b).max()))
            compared += 1
    if compared == 0 or worst > LOGIT_TOL:
        raise RuntimeError(f"{tag}: decode logits vs dense max abs diff "
                           f"{worst} over {compared} steps (tol {LOGIT_TOL})")
    same = sum(tokens[r] == ref_tokens[r] for r in tokens)
    log(f"compare {tag} vs dense: {compared} request-steps, max abs logit "
        f"diff {worst:.3e} (tol {LOGIT_TOL}), identical token streams "
        f"{same}/{len(tokens)}, compared up to divergence for {diverged}")
    return worst


# ---------------------------------------------------------------------------
# phases 12-13: the serving mesh, context-parallel flash, the EF all-reduce
# ---------------------------------------------------------------------------
MESH_SHARDS = 4
# sharded engine C vs unsharded: each head's attention is the same
# arithmetic, only the head-summed chunk mass is summed in another order
# (per shard, then over shards); held to this, and printed
MESH_LOGIT_TOL = 1e-5
CP_TOL = 1e-5
CP_TOKENS = 2048            # gemma3-4b's prompt for flash_cp, twice its window


def _trace_gap(tr, ref):
    """(max abs diff, bit-equal) over the decode steps two runs share
    (same rids, same steps)."""
    import numpy as np
    worst, same = 0.0, True
    if len(tr) != len(ref):
        raise RuntimeError(f"decode traces of {len(tr)} and {len(ref)} "
                           "steps")
    for a, b in zip(tr, ref):
        if set(a) != set(b):
            raise RuntimeError("decode traces decode other requests")
        for rid in a:
            same &= bool(np.array_equal(a[rid], b[rid]))
            worst = max(worst, float(np.abs(a[rid] - b[rid]).max()))
    return worst, same


def measure_paged_shards(pi, n):
    """The paged kernel once per head shard on engine B's recorded inputs
    ``pi`` (as ``measure_paged`` takes them), in fp32 and bf16: each
    shard's launch reads its head slice ``[:, :, h0:h1]`` of the pool
    blocks in place and is held against the plain version on that view;
    the shards' outputs put together against the one unsharded launch;
    the n launches timed against the unsharded one (events and the
    card's clock), beside the plain version once per shard and the
    library call once per shard (``scaled_dot_product_attention`` on the
    shard's head slice of the keys pre-gathered by block row, as
    ``measure_paged`` times it). The bound is the unsharded call's: the
    shards read the same bytes between them."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.decode_attention.ref import \
        paged_decode_attention_ref

    window = pi.get("window", 0)
    B, H, D = pi["q"].shape
    NB, bs, Hkv = pi["k_blocks"].shape[:3]
    NBmax = pi["block_rows"].shape[1]
    hs, gs = Hkv // n, H // n
    safe, gpos = _paged_gather(pi)
    live = _decode_live(pi["q_pos"], gpos, window)
    n_keys = int(live.sum())
    brows = pi["block_rows"]
    ref_blocks = torch.unique(brows[brows >= 0].long())
    n_slots = int((pi["kpos_blocks"][ref_blocks] >= 0).sum())
    res = {}
    for dt_name in ("float32", "bfloat16"):
        dt = getattr(torch, dt_name)
        x = _cast(pi, dt)
        rest = (x["kpos_blocks"], x["block_rows"], x["q_pos"])
        views = [(x["q"][:, s * gs:(s + 1) * gs].contiguous(),
                  x["k_blocks"][:, :, s * hs:(s + 1) * hs],
                  x["v_blocks"][:, :, s * hs:(s + 1) * hs])
                 for s in range(n)]
        if any(v[1].is_contiguous() for v in views) and n > 1:
            raise RuntimeError("paged shards: a head slice is contiguous")
        full = lambda: dops.paged_decode_attention(  # noqa: E731
            x["q"], x["k_blocks"], x["v_blocks"], *rest, window=window)
        shards = lambda: [dops.paged_decode_attention(  # noqa: E731
            qs, ks, vs, *rest, window=window) for qs, ks, vs in views]
        o_full, outs = full(), shards()
        torch.cuda.synchronize()
        err = max(_err(o, paged_decode_attention_ref(qs, ks, vs, *rest,
                                                     window=window))
                  for o, (qs, ks, vs) in zip(outs, views))
        gathered = torch.cat(outs, dim=1)
        gap = _err(gathered, o_full)
        if not (err <= TOL[dt_name] and gap <= TOL[dt_name]
                and torch.isfinite(gathered).all()):
            raise RuntimeError(f"paged_decode_attention shards {dt_name}: "
                               f"max abs err {err}, gathered vs unsharded "
                               f"{gap} (tol {TOL[dt_name]})")
        el = x["q"].element_size()
        nbytes = (2 * B * H * D + 2 * n_slots * Hkv * D) * el + \
            4 * (B + B * NBmax + int(ref_blocks.numel()) * bs)
        b_ms, b_by = bound(nbytes, 4 * D * H * n_keys, dt_name)
        t_s, t_f = cuda_ms(shards), cuda_ms(full)
        d_s, d_f = device_ms(shards), device_ms(full)
        plain = lambda: [paged_decode_attention_ref(  # noqa: E731
            qs, ks, vs, *rest, window=window) for qs, ks, vs in views]
        kg = x["k_blocks"][safe].reshape(B, -1, Hkv, D).transpose(1, 2)
        vg = x["v_blocks"][safe].reshape(B, -1, Hkv, D).transpose(1, 2)
        libv = [(x["q"][:, s * gs:(s + 1) * gs, None],
                 kg[:, s * hs:(s + 1) * hs].contiguous(),
                 vg[:, s * hs:(s + 1) * hs].contiguous()) for s in range(n)]
        lmask = live[:, None, None, :]
        lib = lambda: [F.scaled_dot_product_attention(  # noqa: E731
            qs, ks, vs, attn_mask=lmask, enable_gqa=True)
            for qs, ks, vs in libv]
        t_p, t_l, d_l = cuda_ms(plain), cuda_ms(lib), device_ms(lib)
        res[dt_name] = dict(
            err=err, gathered_vs_unsharded=gap,
            gathered_bit_equal=bool(torch.equal(gathered, o_full)),
            ms=t_s, device_ms=d_s, unsharded_ms=t_f,
            unsharded_device_ms=d_f, plain_ms=t_p, library_ms=t_l,
            library_device_ms=d_l, bound_ms=b_ms, bound_by=b_by,
            splits=dops.num_splits(B, NBmax * bs, Hkv, dt, block=bs))
        log(f"kernel paged_decode_attention {n} head shards {dt_name} NB={NB} "
            f"bs={bs} B={B} NBmax={NBmax} H={H}/{Hkv} (per shard "
            f"{gs}/{hs}) live_keys={n_keys}: max_abs_err per shard "
            f"{err:.3e} (tol {TOL[dt_name]}), gathered vs unsharded "
            f"{gap:.3e} (bit-equal "
            f"{res[dt_name]['gathered_bit_equal']}); {n} launches ms="
            f"{t_s:.4f} device_ms={_fmt(d_s)} vs one unsharded ms="
            f"{t_f:.4f} device_ms={_fmt(d_f)}; per shard plain_ms="
            f"{t_p:.4f} library_ms={t_l:.4f} library_device_ms="
            f"{_fmt(d_l)}; bound_ms={b_ms:.4f} ({b_by})")
    return res


def run_mesh(cfg, params, dev, tmp, ref, pi, tr_b, tok_b):
    """Phase 12, full-width llama3-8b on a serving mesh of MESH_SHARDS
    shards, all on ``dev`` (``make_serving_mesh(4, device=dev)``):
    engine C (``dense``) with ``mesh=`` (forced to ``sharded``, a
    head-sharded pool) against engine C without (``ref``: out, trace,
    tokens, plans): tokens and plans identical, decode logits within
    MESH_LOGIT_TOL (bit equality printed), per-device KV bytes and
    attention FLOPs 1/4, total FLOPs equal; the same with
    ``paged_decode=True``, bit-equal to the arena run on the mesh with 0
    gather bytes; engine B (``paged_kernel``, ``paged_decode``) with the
    mesh installed through ``set_serving_mesh``: exactly one paged launch
    per shard, layer and decode step (counts from 0 around the run),
    logits within LOGIT_TOL of engine C and against engine B without the
    mesh (``tr_b``, ``tok_b``); then the per-shard launch on B's recorded
    inputs ``pi`` (``measure_paged_shards``)."""
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.models import backend as AB

    t0 = time.perf_counter()
    out_c, tr_c, tok_c, plan_c = ref
    mesh = make_serving_mesh(MESH_SHARDS, device=dev)
    n = MESH_SHARDS
    res = {"shards": n, "mesh": repr(mesh)}
    try:
        out_m, tr_m, tok_m, plan_m, _ = run_engine(
            "C mesh", cfg, params, tmp, attn_impl="dense", mesh=mesh)
        AB.set_serving_mesh(None)
        if tok_m != tok_c or plan_m != plan_c:
            raise RuntimeError("engine C on the mesh: tokens or plans "
                               "differ from engine C")
        gap, same = _trace_gap(tr_m, tr_c)
        if gap > MESH_LOGIT_TOL:
            raise RuntimeError(f"engine C on the mesh: decode logits vs "
                               f"engine C max abs diff {gap} (tol "
                               f"{MESH_LOGIT_TOL})")
        if not (out_m["peak_kv_bytes_per_device"] * n ==
                out_c["peak_kv_bytes_per_device"] > 0
                and out_m["attn_flops_device"] * n ==
                out_c["attn_flops_device"] > 0
                and out_m["attn_flops_total"] == out_c["attn_flops_total"]):
            raise RuntimeError(
                "engine C on the mesh: per-device KV bytes / FLOPs not 1/"
                f"{n} of engine C's, or totals differ: {out_m} vs {out_c}")
        res["C"] = dict(logit_gap=gap, bit_equal=same,
                        peak_kv_bytes_per_device=[
                            out_c["peak_kv_bytes_per_device"],
                            out_m["peak_kv_bytes_per_device"]],
                        attn_flops_device=[out_c["attn_flops_device"],
                                           out_m["attn_flops_device"]],
                        attn_flops_total=out_m["attn_flops_total"],
                        decode_step_ms=[out_c["decode_step_ms"],
                                        out_m["decode_step_ms"]])
        log(f"mesh: engine C sharded over {n} vs unsharded: tokens and "
            f"plans identical, decode logits max abs diff {gap:.3e} "
            f"(bit-equal {same}; tol {MESH_LOGIT_TOL}), peak KV bytes per "
            f"device {out_c['peak_kv_bytes_per_device']} -> "
            f"{out_m['peak_kv_bytes_per_device']}, attention FLOPs per "
            f"device {out_c['attn_flops_device']} -> "
            f"{out_m['attn_flops_device']}, total "
            f"{out_m['attn_flops_total']}")

        out_p, tr_p, tok_p, _plan, _ = run_engine(
            "C mesh paged", cfg, params, tmp, attn_impl="dense", mesh=mesh,
            paged_decode=True)
        AB.set_serving_mesh(None)
        gap_p, same_p = _trace_gap(tr_p, tr_m)
        if not (tok_p == tok_m and same_p
                and out_p["decode_gather_bytes"] == 0
                and out_m["decode_gather_bytes"] > 0):
            raise RuntimeError(
                f"paged on the mesh vs arena on the mesh: tokens equal "
                f"{tok_p == tok_m}, bit-equal {same_p} (max diff {gap_p}), "
                f"gather bytes {out_p['decode_gather_bytes']} / "
                f"{out_m['decode_gather_bytes']}")
        res["C_paged"] = dict(bit_equal=same_p, decode_gather_bytes=[
            out_m["decode_gather_bytes"], out_p["decode_gather_bytes"]])
        log(f"mesh: paged == arena on the mesh bit for bit, gather bytes "
            f"{out_m['decode_gather_bytes']} -> 0")

        AB.set_serving_mesh(mesh)
        dops.paged_decode_attention.launches = 0
        out_b, tr_bm, tok_bm, _plan, _ = run_engine(
            "B mesh", cfg, params, tmp, attn_impl="paged_kernel",
            paged_decode=True)
        launches = dops.paged_decode_attention.launches
        AB.set_serving_mesh(None)
        want = n * cfg.num_layers * out_b["decode_steps"]
        if launches != want:
            raise RuntimeError(f"engine B on the mesh: {launches} paged "
                               f"launches, expected {want} ({n} per layer "
                               "and decode step)")
        err_b = compare_logits("B mesh(paged_kernel per shard)", tr_bm,
                               tok_bm, tr_c, tok_c)
        gap_bb, same_bb = _trace_gap(tr_bm, tr_b) if tok_bm == tok_b \
            else (None, False)
        res["B"] = dict(launches=launches, expected=want, logit_err=err_b,
                        vs_unsharded_B=gap_bb, bit_equal_B=same_bb,
                        decode_step_ms=out_b["decode_step_ms"])
        log(f"mesh: engine B with {n} paged launches per layer and step "
            f"({launches} = {want}), logits vs C {err_b:.3e}, vs engine B "
            f"without the mesh {gap_bb} (bit-equal {same_bb})")
    finally:
        AB.set_serving_mesh(None)
    res["kernel"] = measure_paged_shards(pi, n)
    res["seconds"] = time.perf_counter() - t0
    log(f"serving mesh phase: {res['seconds']:.1f}s")
    return res


# ---------------------------------------------------------------------------
# phase 16: the engine under pool pressure (after phase 12)
# ---------------------------------------------------------------------------
PRESSURE_ROUTES = (
    ("default", {}),                     # dense prefill windows, auto decode
    ("kernel", {"attn_impl": "kernel"}),
    ("paged_kernel", {"attn_impl": "paged_kernel", "paged_decode": True}),
)
# runs of the same shapes on both sides (zero-copy vs copy, incremental vs
# rebuild): the same arithmetic on the same inputs
PRESSURE_TOL = 1e-5
# pressured vs unpressured: a preempted request re-prefills packed with
# another partner, and on the card every route's prefill sums follow the
# packed shape (ROADMAP C3): on an H100 the default route reads 1.31e-5,
# and so does the unpacked control without pressure
PACKING_TOL = 2e-4
# (tag, pool blocks, preempt_after_iters, max_prefill_batch); the default
# route adds a control without pressure or packing
PRESSURE_RUNS = (("pool 512", 512, 0, 2), ("pool 20", 20, 4, 2))
PACKING_CONTROL = ("pool 512 unpacked", 512, 0, 1)


def _churn_requests(cfg, lengths, seed):
    """The reference's churn workloads: 6 requests of 3 chunks from a
    10-chunk knowledge base, arriving at once, with the given decode
    lengths (``tests/test_engine_incremental.py``)."""
    from repro_torch.serving.rag import KnowledgeBase
    from repro_torch.serving.workload import WorkloadConfig, generate

    kb = KnowledgeBase(num_chunks=10, vocab_size=cfg.vocab_size, seed=0)
    reqs = generate(kb, WorkloadConfig(num_requests=len(lengths), qpm=1e9,
                                       seed=seed, k_chunks=3,
                                       max_new_tokens=4))
    for r, n in zip(reqs, lengths):
        r.max_new_tokens = n
    return reqs


def _overlap_requests(cfg, n):
    """``tests/test_shared_chunks.py``'s workload: n requests over one
    system prompt and the same 3 chunks, distinct questions."""
    import numpy as np

    from repro_torch.serving.rag import KnowledgeBase
    from repro_torch.serving.request import Request

    kb = KnowledgeBase(num_chunks=8, vocab_size=cfg.vocab_size, seed=0)
    rng = np.random.default_rng(17)
    sys_t = rng.integers(0, kb.vocab_size, 8).astype(np.int32)
    chunks = [kb.chunks[0], kb.chunks[1], kb.chunks[2]]
    return [Request(rid=i, system_tokens=sys_t,
                    chunk_tokens=[c.copy() for c in chunks],
                    question_tokens=rng.integers(
                        0, kb.vocab_size, 10).astype(np.int32),
                    max_new_tokens=4, arrival_time=0.0) for i in range(n)]


def pressure_run(tag, eng, reqs, settle=True):
    """One run of ``eng`` over ``reqs``: all complete with their tokens,
    and (``settle``) the pool drains back to all blocks free. Returns the
    figures, the decode trace, the tokens and the final KV."""
    import numpy as np

    t0 = time.perf_counter()
    stats = eng.run(reqs)
    wall = time.perf_counter() - t0
    c, pool = eng.counters, eng.pool
    ttft = np.array([r.ttft for r in reqs if r.ttft is not None])
    out = dict(
        completed=stats.completed, failed=stats.failed, wall_s=wall,
        ttft_mean_ms=float(ttft.mean() * 1e3),
        ttft_p99_ms=float(np.percentile(ttft, 99) * 1e3),
        decode_steps=stats.decode_steps,
        decode_step_ms=stats.decode_compute_s * 1e3
        / max(1, stats.decode_steps),
        prefill_pass_ms=stats.prefill_compute_s * 1e3
        / max(1, stats.prefill_batches),
        preemptions=c.preemptions,
        preempt_block_recovered=c.preempt_block_recovered,
        burn_requeues=c.burn_requeues,
        head_stall_iters_max=c.head_stall_iters_max,
        decode_rebuilds=c.decode_rebuilds, decode_joins=c.decode_joins,
        decode_leaves=c.decode_leaves,
        decode_gather_bytes=c.decode_gather_bytes,
        shared_seg_hits=c.shared_seg_hits,
        shared_blocks_peak=c.shared_blocks_peak, cow_clones=c.cow_clones,
        pool=dict(reserved=pool.reserved_blocks, live=pool.live_blocks,
                  free=pool.free_blocks, blocks=pool.num_blocks))
    log(f"pressure {tag}: " + json.dumps(out))
    if stats.completed != len(reqs) or stats.failed or any(
            len(r.output_tokens) != r.max_new_tokens for r in reqs):
        raise RuntimeError(f"pressure {tag}: {stats.completed}/{len(reqs)} "
                           f"completed, {stats.failed} failed")
    if settle and not (pool.reserved_blocks == 0 and pool.live_blocks == 0
                       and pool.free_blocks == pool.num_blocks):
        raise RuntimeError(f"pressure {tag}: the pool did not settle: "
                           f"{out['pool']}")
    return out, eng.decode_trace, \
        {r.rid: list(r.output_tokens) for r in reqs}, eng.final_kv


def attempt_gap(tag, trace, tokens, ref_trace, ref_tokens, tol):
    """Each request's decode logits in its last attempt (a preempted
    request's discarded attempts come first in its trace) against the
    reference run's, step by step while their tokens agree. Tokens must
    be equal, except after a step whose reference top-2 gap is within
    ``tol`` (a near tie), where the request is compared no further.
    Returns (max abs diff, bit-equal, requests cut at a near tie); the
    caller holds the difference to its tolerance."""
    import numpy as np

    mine, ref = _per_rid(trace), _per_rid(ref_trace)
    if set(mine) != set(ref):
        raise RuntimeError(f"{tag}: decoded requests differ")
    worst, same, cut = 0.0, True, []
    for rid in sorted(ref):
        a_steps = mine[rid][-len(ref[rid]):]
        for i, (a, b) in enumerate(zip(a_steps, ref[rid])):
            if not np.isfinite(a).all():
                raise RuntimeError(f"{tag}: rid {rid} step {i}: non-finite")
            if int(a.argmax()) != int(b.argmax()):
                top2 = np.sort(b)[-2:]
                if top2[1] - top2[0] > tol:
                    raise RuntimeError(
                        f"{tag}: rid {rid} step {i}: greedy token differs "
                        f"with top-2 gap {top2[1] - top2[0]}")
                cut.append(rid)
                break
            same &= bool(np.array_equal(a, b))
            worst = max(worst, float(np.abs(a - b).max()))
    for rid, b in ref_tokens.items():
        if tokens[rid] != b and rid not in cut:
            raise RuntimeError(f"{tag}: rid {rid} tokens {tokens[rid]} vs "
                               f"{b}")
    return worst, same, cut


def kv_gap(tag, kv, ref_kv):
    """Final pool KV per request (positions equal); returns (max abs
    diff of K and V, bit-equal)."""
    import numpy as np

    if set(kv) != set(ref_kv):
        raise RuntimeError(f"{tag}: final KV of other requests")
    worst, same = 0.0, True
    for rid in ref_kv:
        (k, v, p), (k0, v0, p0) = kv[rid], ref_kv[rid]
        if not np.array_equal(p, p0):
            raise RuntimeError(f"{tag}: rid {rid} KV positions differ")
        for x, y in ((k, k0), (v, v0)):
            same &= bool(np.array_equal(x, y))
            worst = max(worst, float(np.abs(x - y).max()))
    return worst, same


def churn_engine(cfg, params, pool, after, pack=2, device="cuda", **kw):
    """An engine for the churn workloads: ``strategy="all"``, no store,
    ``pool`` blocks, prefill batch ``pack``, decode batch 4,
    ``preempt_after_iters`` ``after``, the decode trace kept; ``kw``: the
    route."""
    from repro_torch.serving.api import EngineSpec, build_engine
    from repro_torch.serving.scheduler import SchedulerConfig

    return build_engine(EngineSpec(
        strategy="all", use_focus=False, pool_blocks=pool, decode_bucket_b=4,
        seq_bucket=512,
        sched=SchedulerConfig(max_batch_tokens=100_000, max_decode_batch=4,
                              max_prefill_batch=pack,
                              preempt_after_iters=after),
        trace_decode=True, device=device, **kw),
        cfg=cfg, params=params, store=None)


def _uncounted(eng, fn):
    return fn()


def zero_copy_runs(tag, cfg, params, tmp, device="cuda", counted=_uncounted,
                   **kw):
    """``tests/test_shared_chunks.py``'s workload with a store, without
    and with zero-copy sharing (``{share: pressure_run(...)}``): two
    warm-up runs, then the compared one. ``counted(eng, fn)`` makes each
    run (phase 21 counts its launches there); ``kw``: the route."""
    from repro_torch.core.chunkstore import ChunkStore
    from repro_torch.core.tiers import TieredStore
    from repro_torch.serving.api import EngineSpec, build_engine
    from repro_torch.serving.engine import EngineStats
    from repro_torch.serving.scheduler import SchedulerConfig

    runs = {}
    for share in (False, True):
        store = ChunkStore(TieredStore(
            1 << 28, 1 << 28, os.path.join(tmp, f"{tag}-zero-copy-{share}"),
            start_worker=False), n_chunks=50, m_variants=4)
        eng = build_engine(EngineSpec(
            use_focus=False, store_fixed_variants=False,
            force_recompute_fraction=0.3, pool_blocks=256,
            sched=SchedulerConfig(max_batch_tokens=100_000,
                                  max_decode_batch=8, max_prefill_batch=4),
            share_chunk_kv=share, trace_decode=True, device=device, **kw),
            cfg=cfg, params=params, store=store)
        for _ in range(2):
            counted(eng, lambda: eng.run(_overlap_requests(cfg, 4)))
        eng.clock = 0.0
        eng.stats = EngineStats()
        eng.counters.reset()
        eng.decode_trace, eng.final_kv = [], {}
        runs[share] = counted(eng, lambda: pressure_run(
            f"{tag} zero-copy {share}", eng, _overlap_requests(cfg, 4),
            settle=False))
        store.tiers.close()
        del eng, store
    return runs


def incremental_runs(tag, cfg, params, device="cuda", counted=_uncounted,
                     **kw):
    """The churn workload of decode lengths 3, 5, 7, 9, 4, 6 (seed 11,
    prefill batch 1) with the incremental decode batch and with rebuilds
    (``{incremental: pressure_run(...)}``); ``counted`` and ``kw`` as
    ``zero_copy_runs``'s."""
    from repro_torch.serving.api import EngineSpec, build_engine
    from repro_torch.serving.scheduler import SchedulerConfig

    runs = {}
    for inc in (True, False):
        eng = build_engine(EngineSpec(
            strategy="all", use_focus=False, pool_blocks=512,
            decode_bucket_b=4, seq_bucket=320,
            sched=SchedulerConfig(max_batch_tokens=100_000,
                                  max_decode_batch=4, max_prefill_batch=1),
            incremental_decode=inc, trace_decode=True, device=device, **kw),
            cfg=cfg, params=params, store=None)
        runs[inc] = counted(eng, lambda: pressure_run(
            f"{tag} incremental {inc}", eng,
            _churn_requests(cfg, (3, 5, 7, 9, 4, 6), 11)))
        del eng
    return runs


def run_pressure(cfg, params, tmp):
    """Phase 16, full-width llama3-8b, fp32, TF32 off: the reference's
    pressure gates on the card. (1) Preemption: the churn workload
    (decode lengths 18, 18, 3, 5, 4, 6, seed 17; prefill batch 2, decode
    batch 4) at pool 512 and at pool 20 with ``preempt_after_iters`` 4,
    on the default route, ``kernel`` and ``paged_kernel`` +
    ``paged_decode``: the pressured run preempts, recovers blocks, burns
    no pass, settles the pool and equals the unpressured run within
    PACKING_TOL (the kernel routes also within LOGIT_TOL of the default
    route's); on the default route a control, the unpressured workload
    with each request prefilled alone, shows what packing alone moves.
    (2) Zero-copy vs copy:
    ``tests/test_shared_chunks.py``'s workload with a store (two warm-up
    runs, then the measured one) on the default and ``kernel`` routes:
    outputs equal, logits within PRESSURE_TOL, blocks shared. (3)
    Incremental vs rebuild: the other churn workload (decode lengths 3,
    5, 7, 9, 4, 6, seed 11; prefill batch 1) on the default route: one
    rebuild against more, logits within PRESSURE_TOL. Launches of the
    four serving kernels are counted from 0 around these runs, and each
    kernel is then held against its plain version on the recorded inputs
    of its most frequent call shape."""
    import torch

    from repro_torch.kernels.chunk_attention import ops as cops
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.rope import ops as rops

    t_phase = time.perf_counter()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    res = {"preempt": {}, "zero_copy": {}}
    cops.chunk_attention.launches = 0
    dops.decode_attention.launches = 0
    dops.paged_decode_attention.launches = 0
    rops.rope.launches = 0
    try:
        with ChunkRecorder(cops) as cc, DecodeRecorder(dops) as dc, \
                RopeRecorder(rops) as rc:
            pressed = {}
            for route, kw in PRESSURE_ROUTES:
                runs = {}
                for tag, pool, after, pack in PRESSURE_RUNS + (
                        (PACKING_CONTROL,) if route == "default" else ()):
                    eng = churn_engine(cfg, params, pool, after, pack, **kw)
                    runs[tag] = pressure_run(
                        f"{route} {tag}", eng,
                        _churn_requests(cfg, (18, 18, 3, 5, 4, 6), 17))
                    del eng
                (fu, tru, toku, kvu), (fp, trp, tokp, kvp) = \
                    runs["pool 512"], runs["pool 20"]
                if not (fp["preemptions"] > 0
                        and fp["preempt_block_recovered"] > 0
                        and fp["burn_requeues"] == 0
                        and fu["preemptions"] == 0):
                    raise RuntimeError(f"pressure {route}: preemptions "
                                       f"{fp['preemptions']}, recovered "
                                       f"{fp['preempt_block_recovered']}, "
                                       f"burn requeues {fp['burn_requeues']}")
                tol = PACKING_TOL
                lg, lsame, cut = attempt_gap(f"pressure {route}", trp, tokp,
                                             tru, toku, tol)
                kg, ksame = kv_gap(f"pressure {route}", kvp, kvu)
                row = dict(unpressured=fu, pressured=fp, logit_gap=lg,
                           logit_bit_equal=lsame, kv_gap=kg,
                           kv_bit_equal=ksame, near_tie_cut=cut, tol=tol)
                if route == "default":
                    # the control: the same requests without pressure, each
                    # prefilled alone, against the packed unpressured run
                    fc, trc, tokc, kvc = runs[PACKING_CONTROL[0]]
                    cg, csame, ccut = attempt_gap(
                        "pressure default unpacked", trc, tokc, tru, toku,
                        tol)
                    ckg, cksame = kv_gap("pressure default unpacked", kvc,
                                         kvu)
                    row["packing_control"] = dict(
                        logit_gap=cg, logit_bit_equal=csame, kv_gap=ckg,
                        kv_bit_equal=cksame, near_tie_cut=ccut)
                    log(f"pressure default: unpacked vs packed, no pressure "
                        f"(the control): decode logits max abs diff "
                        f"{cg:.3e} (bit-equal {csame}), final KV {ckg:.3e} "
                        f"(bit-equal {cksame})")
                    del kvc
                del kvu, kvp
                if route != "default":
                    row["vs_default"] = compare_logits(
                        f"pressure {route} pool 20 vs default",
                        trp, tokp, *pressed["default"])
                pressed[route] = (trp, tokp)
                res["preempt"][route] = row
                log(f"pressure {route}: pool 20 vs 512: outputs equal "
                    f"(near-tie cuts {cut}), decode logits max abs diff "
                    f"{lg:.3e} (bit-equal {lsame}), final KV {kg:.3e} "
                    f"(bit-equal {ksame}); tol {tol}; "
                    f"{fp['preemptions']} preemptions")
                if max(lg, kg) > tol:
                    raise RuntimeError(f"pressure {route}: pool 20 vs 512 "
                                       f"logits {lg}, final KV {kg} (tol "
                                       f"{tol})")

            for route, kw in PRESSURE_ROUTES[:2]:
                runs = zero_copy_runs(route, cfg, params, tmp, **kw)
                (fc, trc, tokc, _kc), (fz, trz, tokz, _kz) = runs[False], \
                    runs[True]
                if tokc != tokz:
                    raise RuntimeError(f"zero-copy {route}: outputs differ "
                                       "from the copy path's")
                gap, same = _trace_gap(trz, trc)
                if gap > PRESSURE_TOL:
                    raise RuntimeError(f"zero-copy {route}: decode logits "
                                       f"max abs diff {gap} (tol "
                                       f"{PRESSURE_TOL})")
                if not (fz["shared_seg_hits"] > 0
                        and fz["shared_blocks_peak"] > 0
                        and fz["cow_clones"] > 0
                        and fc["shared_seg_hits"] == 0):
                    raise RuntimeError(f"zero-copy {route}: nothing shared: "
                                       f"{fz}")
                res["zero_copy"][route] = dict(copy=fc, zero_copy=fz,
                                               logit_gap=gap, bit_equal=same)
                log(f"zero-copy {route} vs copy: outputs equal, decode "
                    f"logits max abs diff {gap:.3e} (bit-equal {same}; tol "
                    f"{PRESSURE_TOL}), shared_seg_hits "
                    f"{fz['shared_seg_hits']}, shared_blocks_peak "
                    f"{fz['shared_blocks_peak']}, cow_clones "
                    f"{fz['cow_clones']}")

            runs = incremental_runs("default", cfg, params)
            (fi, tri, toki, kvi), (fr, trr, tokr, kvr) = runs[True], \
                runs[False]
            gap, same = _trace_gap(tri, trr)
            kg, ksame = kv_gap("incremental", kvi, kvr)
            if not (toki == tokr and max(gap, kg) <= PRESSURE_TOL
                    and fi["decode_rebuilds"] == 1
                    and fr["decode_rebuilds"] > 1):
                raise RuntimeError(
                    f"incremental vs rebuild: tokens equal {toki == tokr}, "
                    f"logits {gap}, rebuilds {fi['decode_rebuilds']} vs "
                    f"{fr['decode_rebuilds']}")
            res["incremental"] = dict(incremental=fi, rebuild=fr,
                                      logit_gap=gap, bit_equal=same,
                                      kv_gap=kg, kv_bit_equal=ksame)
            log(f"incremental vs rebuild: rebuilds {fi['decode_rebuilds']} "
                f"vs {fr['decode_rebuilds']}, decode logits max abs diff "
                f"{gap:.3e} (bit-equal {same}), final KV {kg:.3e} "
                f"(bit-equal {ksame}); tol {PRESSURE_TOL}")
        launches = {"chunk_attention": cops.chunk_attention.launches,
                    "decode_attention": dops.decode_attention.launches,
                    "paged_decode_attention":
                        dops.paged_decode_attention.launches,
                    "rope": rops.rope.launches}
        log(f"pressure phase launches: {json.dumps(launches)}")
        for name, n in launches.items():
            if n <= 0:
                raise RuntimeError(f"pressure phase: {name} not launched")
        res["launches"] = launches
        # each kernel on the recorded inputs of its most frequent call
        # shape under pressure (not counted as path launches)
        ck = max(cc.shapes, key=lambda k: (cc.shapes[k], k))
        dk, pk = dc.most_frequent("dense"), dc.most_frequent("paged")
        rk = rc.most_frequent()
        x, pos, theta = rc.calls[rk]
        res["kernels"] = {
            "chunk_attention": dict(
                shape=f"(B, A, S) {list(ck)}", calls=cc.shapes[ck],
                **measure_chunk(f"pressure{list(ck)}", cc.calls[ck])),
            "decode_attention": dict(
                shape=f"(B, S) {list(dk[1:])}", calls=dc.shapes[dk],
                **measure_decode(f"pressure{list(dk[1:])}", dc.calls[dk])),
            "paged_decode_attention": dict(
                shape=f"(B, NBmax, bs) {list(pk[1:])}", calls=dc.shapes[pk],
                **measure_paged(f"pressure{list(pk[1:])}", dc.calls[pk])),
            "rope": dict(
                shape=f"{list(rk[0])}", calls=rc.shapes[rk],
                **measure_rope("pressure", x, pos, theta)),
        }
        del cc, dc, rc
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    res["seconds"] = time.perf_counter() - t_phase
    log(f"engine under pressure phase: {res['seconds']:.1f}s")
    return res


# ---------------------------------------------------------------------------
# phase 17: the executor's decision surface (after phase 16)
# ---------------------------------------------------------------------------
STRATEGY_FRAC = 0.3          # the forced recompute fraction of every strategy
STRATEGY_SEED = 0            # each executor's plan-level generator
STRATEGY_PROMPTS = 4         # reordered smoke prompts, one packed pass a run
# forced full recompute against the storeless oracle (the reference's
# tests/test_executor.py bound)
FORCED_TOL = 3e-4
# blend@1 == all and blend@0 == none where the chunk kernel's main-pass
# shapes (and with them its key split) differ between the two runs (C3)
SPLIT_TOL = 2e-4
# two runs' token choices may differ only at a near tie: each token that one
# run alone picks scores within NEAR_TIE of the boundary's score, relative
# to the largest score of the call, plus the call's rounding floor
NEAR_TIE = 2e-4
# blend's deviation at or below this is the rounding of the RoPE round
# trip, not a difference of context: it ranks nothing (ROADMAP C11; at
# most 1.01e-12 on the tiny models in both packages)
ROUNDING_DEV = 1e-9


def _strategy_prompts(cfg):
    """The smoke workload's 12 prompts (warm-up, in arrival order) and
    the first STRATEGY_PROMPTS of them with their chunks reversed (every
    chunk stored, every context new)."""
    from repro_torch.serving.rag import KnowledgeBase
    from repro_torch.serving.workload import WorkloadConfig, generate

    kb = KnowledgeBase(num_chunks=24, vocab_size=cfg.vocab_size, seed=0)
    reqs = generate(kb, WorkloadConfig(num_requests=12, qpm=1e9, k_chunks=5,
                                       max_new_tokens=8))
    warm = [(r.system_tokens, list(r.chunk_tokens), r.question_tokens)
            for r in reqs]
    evals = [(s, c[::-1], q) for s, c, q in warm[:STRATEGY_PROMPTS]]
    return warm, evals


def record_selections(ex):
    """Swap ``ex``'s strategy for a subclass instance that logs every
    ``select_tokens`` call (scores, fraction, chosen tokens) in order:
    the plan's and the deviation probe's. Returns the log. While
    ``ex.strategy_obj.replay`` holds another run's log, each call takes
    that run's choice in place of its own (its own is logged all the
    same), so that two runs which choose differently at a near tie can be
    held to each other in value."""
    import numpy as np

    calls, base = [], type(ex.strategy_obj)

    class Recorded(base):
        replay = None

        def select_tokens(self, scores, frac, rng=None):
            idx = np.asarray(super().select_tokens(scores, frac, rng))
            calls.append((scores, float(frac), idx))
            if self.replay is None:
                return idx
            if not self.replay:
                raise RuntimeError("the replayed log ran out at call "
                                   f"{len(calls) - 1}")
            return np.asarray(self.replay.pop(0)[2], idx.dtype)

    Recorded.__name__ = base.__name__
    ex.strategy_obj = Recorded()
    return calls


def selection_ties(tag, mine, ref, key, floor=0.0):
    """Two runs' logs (``record_selections``) call by call: each pair of
    choices is equal or a near tie. ``key(scores)`` is the score vector
    the strategy ranks by (None: it does not rank, so choices must be
    equal); ``floor`` is the rounding floor of those scores. A near tie:
    the same number of tokens, the two score vectors within the band
    NEAR_TIE * max|score| + floor of each other, and every token that one
    run alone picks within that band of the boundary's score (the
    ``ref`` run's). Returns the number of calls that differ and the
    number of tokens in which they differ; raises on any other
    difference."""
    import numpy as np

    if len(mine) != len(ref):
        raise RuntimeError(f"{tag}: {len(mine)} vs {len(ref)} selections")
    calls = tokens = 0
    for i, ((sa, _fa, ia), (sb, _fb, ib)) in enumerate(zip(mine, ref)):
        if np.array_equal(ia, ib):
            continue
        ka, kb = key(sa), key(sb)
        diff = sorted(set(np.asarray(ia).tolist())
                      ^ set(np.asarray(ib).tolist()))
        if kb is None or ka is None or len(ia) != len(ib):
            raise RuntimeError(f"{tag}: selection {i} differs in {diff}")
        ka, kb = np.asarray(ka, np.float64), np.asarray(kb, np.float64)
        band = NEAR_TIE * np.abs(kb).max() + floor
        bound = np.sort(kb)[::-1][len(ib) - 1]
        apart = float(np.abs(ka - kb).max())
        gap = float(np.abs(kb[diff] - bound).max())
        if apart > band or gap > band:
            raise RuntimeError(f"{tag}: selection {i} differs in {diff}, "
                               f"{gap} from the boundary, scores {apart} "
                               f"apart (band {band})")
        calls += 1
        tokens += len(diff)
    return calls, tokens


def strategy_cases():
    """The executor cases of phases 17 and 21, (name, executor kwargs):
    every registered strategy at STRATEGY_FRAC, ``cachecraft`` at its own
    CFO, ``blend`` at 1 and 0, ``cachecraft`` forced to 1, 0 and 0.7,
    ``none`` without the RPE fix and ``cachecraft`` at STRATEGY_FRAC
    without the causality fix."""
    from repro_torch.core.strategies import STRATEGIES

    cases = [(name, dict(strategy=name, force_recompute_fraction=STRATEGY_FRAC))
             for name in STRATEGIES]
    return cases + [
        ("cachecraft cfo", dict(strategy="cachecraft")),
        ("blend 1.0", dict(strategy="blend", force_recompute_fraction=1.0)),
        ("blend 0.0", dict(strategy="blend", force_recompute_fraction=0.0)),
        ("forced 1.0", dict(force_recompute_fraction=1.0)),
        ("frac 0.0", dict(force_recompute_fraction=0.0)),
        ("frac 0.7", dict(force_recompute_fraction=0.7)),
        ("no_rpe", dict(strategy="none", fix_rpe=False)),
        # recomputed chunk rows laid out at their original positions: the
        # chunk kernel's mask on positions that are not monotone
        ("no_causal", dict(force_recompute_fraction=STRATEGY_FRAC,
                           fix_causality=False)),
    ]


def ranked_by(strategy):
    """The score ``strategy`` ranks a chunk's tokens by (None: it does not
    rank)."""
    return {"cachecraft": lambda s: s.inter,
            "h2o": lambda s: s.total if s.total is not None else s.inter,
            "blend": lambda s: s.deviation}.get(strategy, lambda s: None)


def score_gap(mine, ref, key):
    """The largest gap between two runs' ranked scores (``key``), call by
    call where both ranked the same number of tokens."""
    import numpy as np

    worst = 0.0
    for (sa, _fa, _ia), (sb, _fb, _ib) in zip(mine, ref):
        a, b = key(sa), key(sb)
        if a is not None and b is not None and len(a) == len(b) and len(a):
            worst = max(worst, float(np.abs(np.asarray(a, np.float64)
                                            - np.asarray(b)).max()))
    return worst


def run_strategies(cfg, params, tmp, device="cuda"):
    """Phase 17, full-width llama3-8b, fp32, TF32 off: the executor's
    whole decision surface on the card. One chunk store is warmed on
    ``dense`` by the smoke workload's 12 prompts; every later run only
    reads it (``store_new_chunks=False``, ``store_fixed_variants=False``),
    so both routes plan from the same stored scores, on
    STRATEGY_PROMPTS of the prompts with their chunks reversed, packed in
    one pass, ``use_focus=False`` and a generator seeded STRATEGY_SEED.
    Each registered strategy at STRATEGY_FRAC, ``cachecraft`` at its own
    CFO, ``blend`` at 1 and 0, ``cachecraft`` forced to 1, 0 and 0.7,
    ``none`` without the RPE fix and ``cachecraft`` at STRATEGY_FRAC
    without the causality fix, on ``kernel`` and on ``dense``: plans
    equal (``blend``: differing tokens only at near ties, counted, and
    then dense is run again on the kernel's choices), logits within
    LOGIT_TOL.
    On each route: blend@1 == all and blend@0 == none byte for byte (at
    SPLIT_TOL where the chunk kernel's main-pass shapes differ), forced
    full recompute within FORCED_TOL of ``all``, the deviation from
    ``all`` at 0.7 below that at 0, and without the RPE fix above that
    with it. On ``kernel``: streamed loads (``layerwise_load``, the RoPE
    kernel once per layer) == eager byte for byte, and one focus run. The
    chunk and RoPE launches are counted from 0 around the runs, and
    ``blend``'s probe call (A = S) is held and timed on its recorded
    inputs."""
    import numpy as np
    import torch

    from repro_torch.core.chunkstore import ChunkStore
    from repro_torch.core.prefill import CacheCraftExecutor
    from repro_torch.core.tiers import TieredStore
    from repro_torch.kernels.chunk_attention import ops as cops
    from repro_torch.kernels.rope import ops as rops
    from repro_torch.serving.metrics import relative_deviation

    t_phase = time.perf_counter()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    warm, evals = _strategy_prompts(cfg)
    store = ChunkStore(TieredStore(1 << 33, 1 << 33,
                                   os.path.join(tmp, "strategies")),
                       n_chunks=64, m_variants=3)
    cops.chunk_attention.launches = 0
    rops.rope.launches = 0
    res = {"runs": {}}

    def executor(impl, **kw):
        return CacheCraftExecutor(
            cfg, params, store, attn_impl=impl,
            use_focus=kw.pop("use_focus", False),
            rng=np.random.default_rng(STRATEGY_SEED), device=device, **kw)

    def run(impl, replay=None, **kw):
        ex = executor(impl, store_new_chunks=False,
                      store_fixed_variants=False, **kw)
        sel = record_selections(ex)
        ex.strategy_obj.replay = None if replay is None else list(replay)
        with ChunkRecorder(cops) as cc:
            t0 = time.perf_counter()
            out = ex.process_batch(evals)
            if device != "cpu":
                torch.cuda.synchronize()
            sec = time.perf_counter() - t0
        return dict(results=out, selections=sel, order=list(cc.order),
                    calls=cc.calls, seconds=sec)

    def plan(r):
        return [[(bool(d.is_hit), float(d.cfo),
                  np.asarray(d.recompute_idx).tolist())
                 for d in p.plan.decisions]
                + [p.plan.num_active_tokens, p.plan.total_len,
                   p.active_rows_layers] for p in r["results"]]

    def gap(a, b, what="logits_last"):
        return max(float(np.abs(getattr(x, what) - getattr(y, what)).max())
                   for x, y in zip(a["results"], b["results"]))

    def same(a, b):
        return all(np.array_equal(getattr(x, w), getattr(y, w))
                   for x, y in zip(a["results"], b["results"])
                   for w in ("logits_last", "k_layers", "v_layers"))

    cases = strategy_cases()
    try:
        with ChunkRecorder(cops) as phase_calls:
            t0 = time.perf_counter()
            warm_ex = executor("dense")
            for prompt in warm:
                warm_ex.process_batch([prompt])
            res["warm"] = dict(seconds=time.perf_counter() - t0,
                               variants=store.num_variants())
            log(f"strategies: store warmed on dense by {len(warm)} prompts: "
                f"{store.num_variants()} variants, "
                f"{res['warm']['seconds']:.1f}s")
            runs = {}
            for name, kw in cases:
                for impl in ("kernel", "dense"):
                    runs[name, impl] = run(impl, **kw)
            runs["streamed", "kernel"] = run(
                "kernel", force_recompute_fraction=STRATEGY_FRAC,
                layerwise_load=True)
            runs["focus", "kernel"] = run(
                "kernel", force_recompute_fraction=STRATEGY_FRAC,
                use_focus=True, focus_w=2)
        launches = {"chunk_attention": cops.chunk_attention.launches,
                    "rope": rops.rope.launches}
        res["launches"] = launches
        res["chunk_calls"] = {str(list(k)): n for k, n in sorted(
            phase_calls.shapes.items(), key=lambda kv: -kv[1])}
        log(f"strategies phase launches: {json.dumps(launches)}; chunk "
            f"calls by (B, A, S): {json.dumps(res['chunk_calls'])}")
        for kname, n in launches.items():
            if n <= 0:
                raise RuntimeError(f"strategies phase: {kname} not launched")

        # kernel against dense, case by case: the same plans (blend: near
        # ties aside, and then dense again on the kernel's choices), logits
        # within LOGIT_TOL
        oracle = {impl: runs["all", impl] for impl in ("kernel", "dense")}
        for name, kw in cases:
            k, d = runs[name, "kernel"], runs[name, "dense"]
            row = dict(seconds_kernel=k["seconds"], seconds_dense=d["seconds"])
            ties = (0, 0)
            if name.startswith("blend"):
                row["max_deviation"] = max(
                    (float(np.abs(c[0].deviation).max())
                     for c in k["selections"]
                     if c[0].deviation is not None and len(c[0].deviation)),
                    default=0.0)
            if plan(k) != plan(d):
                if not name.startswith("blend"):
                    raise RuntimeError(f"strategies {name}: kernel and dense "
                                       "plan differently")
                ties = selection_ties(f"strategies {name}", k["selections"],
                                      d["selections"],
                                      lambda sc: sc.deviation, ROUNDING_DEV)
                d = run("dense", replay=k["selections"], **kw)
                if plan(k) != plan(d):
                    raise RuntimeError(f"strategies {name}: dense on the "
                                       "kernel's choices plans differently")
            row["near_tie_calls"], row["near_tie_tokens"] = ties
            lg = gap(k, d)
            row["kernel_vs_dense"] = lg
            row["kernel_vs_dense_kv"] = max(gap(k, d, "k_layers"),
                                            gap(k, d, "v_layers"))
            if not (lg <= LOGIT_TOL and all(
                    np.isfinite(r.logits_last).all() for r in k["results"])):
                raise RuntimeError(f"strategies {name}: kernel vs dense "
                                   f"logits {lg} (tol {LOGIT_TOL})")
            for impl, r in (("kernel", k), ("dense", d)):
                row[f"deviation_{impl}"] = float(np.mean([
                    relative_deviation(x.logits_last, y.logits_last)
                    for x, y in zip(r["results"], oracle[impl]["results"])]))
            row["computed_tokens"] = sum(r.plan.num_active_tokens
                                         for r in k["results"])
            row["total_tokens"] = sum(r.plan.total_len for r in k["results"])
            res["runs"][name] = row

        # the reference's identities, on each route
        res["identities"] = {}
        for impl in ("kernel", "dense"):
            idn = {}
            for got, want in (("blend 1.0", "all"), ("blend 0.0", "none")):
                a, b = runs[got, impl], runs[want, impl]
                # blend's probe windows come first, one per prompt
                main = a["order"][len(evals):]
                shapes_same = collections.Counter(main) == \
                    collections.Counter(b["order"])
                eq = same(a, b)
                g = max(gap(a, b), gap(a, b, "k_layers"),
                        gap(a, b, "v_layers"))
                idn[f"{got} == {want}"] = dict(
                    bit_equal=eq, max_abs=g, shapes_same=shapes_same)
                if not eq and (shapes_same or g > SPLIT_TOL):
                    raise RuntimeError(
                        f"strategies {impl}: {got} vs {want}: max abs {g}, "
                        f"chunk shapes {sorted(set(main))} vs "
                        f"{sorted(set(b['order']))}")
            fg = gap(runs["forced 1.0", impl], runs["all", impl])
            idn["forced 1.0 vs all"] = fg
            if fg > FORCED_TOL:
                raise RuntimeError(f"strategies {impl}: forced full "
                                   f"recompute {fg} from all (tol "
                                   f"{FORCED_TOL})")
            dv = {f: res["runs"][n][f"deviation_{impl}"] for f, n in (
                (0.0, "frac 0.0"), (0.3, "cachecraft"), (0.7, "frac 0.7"))}
            idn["deviation by fraction"] = dv
            if not dv[0.7] < dv[0.0]:
                raise RuntimeError(f"strategies {impl}: deviation at 0.7 "
                                   f"{dv[0.7]} not below 0's {dv[0.0]}")
            # Table 3 on the reuse path: without each fix beside with both
            ab = {n: res["runs"][n][f"deviation_{impl}"]
                  for n in ("none", "no_rpe", "cachecraft", "no_causal")}
            idn["ablations"] = ab
            if not ab["no_rpe"] > ab["none"]:
                raise RuntimeError(f"strategies {impl}: without the RPE fix "
                                   f"{ab['no_rpe']} not above {ab['none']}")
            res["identities"][impl] = idn
            log(f"strategies {impl}: " + json.dumps(idn))

        s, e = runs["streamed", "kernel"], runs["cachecraft", "kernel"]
        hits = sum(d.is_hit for r in s["results"] for d in r.plan.decisions)
        streamed = [r.streamed for r in s["results"]]
        layers = sum(r.load_blocked_layers + r.load_hidden_layers
                     for r in s["results"])
        if not (all(streamed) and layers == cfg.num_layers * hits
                and same(s, e)):
            raise RuntimeError(f"strategies: streamed vs eager on kernel: "
                               f"streamed {streamed}, {layers} layer loads "
                               f"for {hits} hits, bit-equal {same(s, e)}")
        res["streamed"] = dict(bit_equal=True, layer_loads=layers, hits=hits,
                               seconds=s["seconds"],
                               eager_seconds=e["seconds"])
        f = runs["focus", "kernel"]
        res["focus"] = dict(
            cutoff=[r.focus_cutoff for r in f["results"]],
            focused=[None if r.focused is None else sorted(r.focused)
                     for r in f["results"]],
            active_rows_layers=[r.active_rows_layers for r in f["results"]],
            without_focus=[r.active_rows_layers for r in e["results"]])
        log("strategies: streamed == eager on kernel byte for byte "
            f"({layers} layer loads, {hits} hits); focus run: "
            + json.dumps(res["focus"]))
        log("strategies (random weights: a check of the mechanism, not a "
            "quality result): relative deviation of the last logits from "
            "all, kernel / dense: " + ", ".join(
                f"{n} {r['deviation_kernel']:.4e} / {r['deviation_dense']:.4e}"
                for n, r in res["runs"].items())
            + "; near-tie calls / tokens of blend runs: " + ", ".join(
                f"{n} {r['near_tie_calls']}/{r['near_tie_tokens']}"
                for n, r in res["runs"].items() if n.startswith("blend")))

        # blend's probe on kernel: the chunk kernel with every row active
        # (A = S), one call per prompt before the main pass, held and timed
        # on its recorded inputs (not counted)
        probe = runs["blend", "kernel"]
        keys = [k for k in probe["order"][:len(evals)] if k[1] == k[2]]
        if len(keys) != len(evals):
            raise RuntimeError(f"strategies: blend's probe calls "
                               f"{probe['order'][:len(evals)]}")
        pk = max(set(keys), key=lambda k: (keys.count(k), k))
        res["probe"] = dict(shape=f"(B, A, S) {list(pk)}",
                            calls=keys.count(pk),
                            **measure_chunk(f"probe{list(pk)}",
                                            probe["calls"][pk]))
        del probe, phase_calls, runs
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
        store.tiers.close()
    res["seconds"] = time.perf_counter() - t_phase
    log(f"strategies phase: {res['seconds']:.1f}s")
    return res


def run_cp_ef(dev):
    """Phase 13: ``flash_cp`` on a CP mesh of 4 (axis "model", all on the
    card) at gemma3-4b's full width, layer by layer (q [1, 2048, 8, 256]
    against k/v [1, 2048, 4, 256], the 1024-key window and none) and
    through ``make_prefill_step`` on a 2048-token prompt, against
    ``flash``; then the int8 error-feedback all-reduce of full-width
    llama3-8b's gradients cut to 2 layers, one batch of 1024 tokens per
    shard over 4 shards, 8 steps, leaf by leaf (the reference's bounds:
    each step's mean within 0.2 of the exact mean relative to its
    largest entry, the mean over the 8 steps within 0.02)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.distributed import compression as TC
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.training import steps as TS
    from repro_torch.training.data import DataConfig, SyntheticLM
    from repro_torch.training.optimizer import tree_leaves

    t0 = time.perf_counter()
    res = {}
    cfg = get_config("gemma3-4b")
    cp = make_debug_mesh((MESH_SHARDS,), ("model",), device=dev)
    rng = np.random.default_rng(13)
    T, H, Hkv, D = CP_TOKENS, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
               .to(dev) for s in ((1, T, H, D), (1, T, Hkv, D),
                                  (1, T, Hkv, D)))
    pos = torch.arange(T, dtype=torch.int32, device=dev)[None]
    layer = {}
    for w in (cfg.window, 0):
        a = L.gqa_attend_flash_cp(q, k, v, pos, pos, cp, w)
        b = L.gqa_attend_flash(q, k, v, pos, pos, w)
        torch.cuda.synchronize()
        layer[w] = _max_diff(a, b)
        if not (layer[w] <= CP_TOL and torch.isfinite(a).all()):
            raise RuntimeError(f"flash_cp vs flash at gemma3-4b's width, "
                               f"window {w}: {layer[w]} (tol {CP_TOL})")
    del q, k, v
    params = _params(cfg, dev)
    toks = _prompt(cfg, T, dev)
    logits = {}
    try:
        for impl in ("flash", "flash_cp"):
            M.set_cp_mesh(cp if impl == "flash_cp" else None)
            step = TS.make_prefill_step(cfg, impl)
            logits[impl], _cache = step(params, {"tokens": toks, "cache":
                                                 M.init_cache(cfg, 1, T,
                                                              device=dev)})
            del _cache
    finally:
        M.set_cp_mesh(None)
    torch.cuda.synchronize()
    lg = _max_diff(logits["flash_cp"], logits["flash"])
    if not (lg <= CP_TOL and torch.isfinite(logits["flash_cp"]).all()):
        raise RuntimeError(f"gemma3-4b prefill on flash_cp vs flash: max "
                           f"abs logit diff {lg} (tol {CP_TOL})")
    res["flash_cp"] = dict(layer_window=layer[cfg.window], layer_global=
                           layer[0], logits=lg)
    log(f"flash_cp over {MESH_SHARDS} shards vs flash, gemma3-4b "
        f"({H}/{Hkv} heads of {D}, {T} tokens): attention window "
        f"{cfg.window} {layer[cfg.window]:.3e}, global {layer[0]:.3e}; "
        f"make_prefill_step last logits {lg:.3e} (tol {CP_TOL})")
    del params, logits
    _free()

    # the EF all-reduce of real gradients
    cfg = get_config("llama3-8b").replace(num_layers=2)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    state = TS.init_train_state(cfg, gen)
    data = SyntheticLM(DataConfig(seq_len=1024, global_batch=MESH_SHARDS,
                                  vocab_size=cfg.vocab_size))
    b = {k: torch.from_numpy(x).to(dev) for k, x in data.batch(0).items()}
    names_leaves = list(tree_leaves(state.params))
    grads = []
    for s in range(MESH_SHARDS):
        with torch.enable_grad():
            loss = TS.loss_fn(cfg, state.params,
                              {k: x[s:s + 1] for k, x in b.items()})[0]
            grads.append([g.detach() for g in torch.autograd.grad(
                loss, names_leaves)])
        del loss
    del state, names_leaves
    _free()
    t1 = time.perf_counter()
    worst_rel, worst_drift, n_el = 0.0, 0.0, 0
    for i in range(len(grads[0])):
        gs = [{"g": grads[s][i]} for s in range(MESH_SHARDS)]
        exact = torch.stack([g["g"] for g in gs]).mean(0)
        scale = float(exact.abs().max()) + 1e-9
        ef = [TC.init_error_feedback(g) for g in gs]
        total = torch.zeros_like(exact)
        for _step in range(8):
            means, ef = TC.ef_allreduce_grads(gs, ef)
            got = means[0]["g"]
            total += got
            worst_rel = max(worst_rel,
                            float((got - exact).abs().max()) / scale)
        worst_drift = max(worst_drift,
                          float((total / 8 - exact).abs().max()) / scale)
        n_el += exact.numel()
        del gs, ef, means, exact, total
    torch.cuda.synchronize()
    ef_s = time.perf_counter() - t1
    if not (worst_rel < 0.2 and worst_drift < 0.02):
        raise RuntimeError(f"EF all-reduce: worst step error {worst_rel} "
                           f"(bound 0.2), drift {worst_drift} (bound 0.02)")
    res["ef_allreduce"] = dict(shards=MESH_SHARDS, steps=8, elements=n_el,
                               worst_rel=worst_rel, drift=worst_drift,
                               seconds=ef_s)
    log(f"EF all-reduce of llama3-8b/2 gradients ({n_el} elements x "
        f"{MESH_SHARDS} shards, 8 steps): worst step error {worst_rel:.4f} "
        f"of the largest entry (bound 0.2), mean over the steps "
        f"{worst_drift:.5f} (bound 0.02); {ef_s:.1f}s")
    del grads
    _free()
    res["seconds"] = time.perf_counter() - t0
    log(f"context-parallel and EF phase: {res['seconds']:.1f}s")
    return res


# ---------------------------------------------------------------------------
# the families phase: gemma3's local layers, the MoE FFN, long prompts
# ---------------------------------------------------------------------------
def _free():
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def _max_diff(a, b):
    return float((a.float() - b.float()).abs().max())


def family_engines(tag, cfg, params, tmp, num_requests=12, kb_kw=None):
    """Engines A (``kernel``) and C (``dense``) over the smoke workload
    (``num_requests`` and ``kb_kw`` as ``smoke_engine`` takes them): all
    complete on both, identical plans (hits, computed tokens), A's decode
    logits within LOGIT_TOL of C's. A's chunk, decode and rope calls are
    recorded. Returns A's and C's figures, A's kernel launches (counted
    from 0 over A's run), the logit gap, the (query, key) pairs and decode
    keys the window alone masked in A, and the recorders."""
    from repro_torch.kernels.chunk_attention import ops as cops
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.rope import ops as rops

    cops.chunk_attention.launches = 0
    dops.decode_attention.launches = 0
    rops.rope.launches = 0
    with ChunkRecorder(cops) as cc, DecodeRecorder(dops) as dc, \
            RopeRecorder(rops) as rc:
        fig_a, tr_a, tok_a, plan_a, _ = run_engine(
            f"{tag}-A", cfg, params, tmp, num_requests=num_requests,
            kb_kw=kb_kw, attn_impl="kernel")
    launches = {"chunk_attention": cops.chunk_attention.launches,
                "decode_attention": dops.decode_attention.launches,
                "rope": rops.rope.launches}
    masked = {"chunk_attention": cc.window_masked,
              "decode_attention": dc.window_masked}
    log(f"{tag} engine A launches: {json.dumps(launches)}; pairs masked by "
        f"the window alone: {json.dumps(masked)}; calls by shape: chunk "
        f"(B, A, S) {dict(cc.shapes.most_common())}, decode (B, S) "
        f"{ {k[1:]: n for k, n in dc.shapes.most_common()} }, rope (x, "
        f"theta) {dict(rc.shapes.most_common())}")
    for name, n in launches.items():
        if n <= 0:
            raise RuntimeError(f"{tag}: {name} was not launched in engine A")
    if fig_a["prefill_tokens_computed"] >= fig_a["prefill_tokens_total"]:
        raise RuntimeError(f"{tag}: no chunk reuse happened in engine A")
    fig_c, tr_c, tok_c, plan_c, _ = run_engine(
        f"{tag}-C", cfg, params, tmp, num_requests=num_requests,
        kb_kw=kb_kw, attn_impl="dense")
    if plan_a != plan_c:
        diff = {r: (plan_a[r], plan_c[r]) for r in plan_a
                if plan_a[r] != plan_c[r]}
        raise RuntimeError(f"{tag}: plans A vs C differ: {diff}")
    log(f"{tag} plans A vs C (hits, computed tokens) identical for "
        f"{len(plan_a)}/{len(plan_a)} requests")
    err = compare_logits(f"{tag} A(kernel)", tr_a, tok_a, tr_c, tok_c)
    return dict(A=fig_a, C=fig_c, launches=launches, logit_err=err,
                window_masked=masked, recorders=(cc, dc, rc))


def measure_family_path(tag, cc, dc, rc=None):
    """Each kernel a family's run launched, held against its plain version
    and timed on the recorded inputs of its first call at its most
    frequent shape, the larger on a tie (``measure_chunk``,
    ``measure_decode``, and ``measure_rope`` where ``rc`` recorded the
    RPE path; these launches are not path launches). Returns {kernel:
    {"shape", "calls", "float32", "bfloat16"}}."""
    ck = max(cc.shapes, key=lambda k: (cc.shapes[k], k))
    dk = dc.most_frequent("dense")
    ci, di = cc.calls[ck], dc.calls[dk]
    B, A, H, D = ci["q"].shape
    S, Hkv = ci["k"].shape[1:3]
    out = {
        "chunk_attention": dict(
            shape=f"B {B}, A {A}, S {S}, H {H}/{Hkv}, D {D}, C {ci['C']}, "
                  f"window {ci['window']}",
            calls=cc.shapes[ck],
            **measure_chunk(f"{tag} path{list(ck)}", ci)),
        "decode_attention": dict(
            shape=f"B {dk[1]}, S {dk[2]}, H {H}/{Hkv}, D {D}, window "
                  f"{di['window']}",
            calls=dc.shapes[dk],
            **measure_decode(f"{tag} path{list(dk[1:])}", di)),
    }
    if rc is not None:
        rk = rc.most_frequent()
        x, pos, theta = rc.calls[rk]
        out["rope"] = dict(
            shape=f"{list(rk[0])}, theta {theta:g}", calls=rc.shapes[rk],
            **measure_rope(f"{tag} path", x, pos, theta))
    return out


def _prompt(cfg, T, dev, seed=1):
    import numpy as np
    import torch
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (1, T))
    return torch.from_numpy(toks.astype(np.int32)).to(dev)


def prefill_agree(tag, cfg, params, toks, impls, ref_impl, **kw):
    """``M.prefill`` of ``toks`` on ``ref_impl`` and each of ``impls``;
    every one's logits within LOGIT_TOL of the reference's. Returns the
    gaps and every output, the reference's included, with its logits cut
    to the last position."""
    import torch

    from repro_torch.models import model as M

    ref = M.prefill(cfg, params, toks, attn_impl=ref_impl, **kw)
    gaps, outs = {}, {}
    for impl in impls:
        out = M.prefill(cfg, params, toks, attn_impl=impl, **kw)
        torch.cuda.synchronize()
        gaps[impl] = _max_diff(out.logits, ref.logits)
        if not (torch.isfinite(out.logits).all()
                and gaps[impl] <= LOGIT_TOL):
            raise RuntimeError(f"{tag}: prefill on {impl} vs {ref_impl} "
                               f"max abs logit diff {gaps[impl]} (tol "
                               f"{LOGIT_TOL})")
        out.logits = out.logits[:, -1:]
        outs[impl] = out
    ref.logits = ref.logits[:, -1:]
    outs[ref_impl] = ref
    log(f"{tag}: {toks.shape[1]}-token prefill max abs logit diff vs "
        f"{ref_impl}: " + ", ".join(f"{k} {v:.3e}" for k, v in gaps.items())
        + f" (tol {LOGIT_TOL})")
    return gaps, outs


def decode_agree(tag, cfg, params, caches, first, T, steps=8,
                 tol=LOGIT_TOL, controls=()):
    """``steps`` decode steps on each of ``caches`` (label -> (cache,
    attn_impl)), fed the same tokens: greedy from the first cache's
    logits, from ``first`` on. Every other run's logits within ``tol`` of
    the first's at every step, but for the labels in ``controls`` (caches
    with a planted fault), whose largest gap must exceed ``tol``. Returns
    the largest gap per label."""
    import torch

    from repro_torch.models import model as M

    labels = list(caches)
    tok, gaps = first, {k: 0.0 for k in labels[1:]}
    for s in range(steps):
        pos = torch.full((1,), T + s, dtype=torch.int32, device=tok.device)
        lg = {k: M.decode_step(cfg, params, tok, pos, c,
                               attn_impl=impl).logits
              for k, (c, impl) in caches.items()}
        if not torch.isfinite(lg[labels[0]]).all():
            raise RuntimeError(f"{tag}: decode step {s}: bad logits")
        for k in labels[1:]:
            gaps[k] = max(gaps[k], _max_diff(lg[k], lg[labels[0]]))
        tok = lg[labels[0]][:, -1].argmax(-1).to(torch.int32)
    for k, g in gaps.items():
        if (g > tol) != (k in controls):
            what = "a planted fault must exceed" if k in controls else "tol"
            raise RuntimeError(f"{tag}: decode {k} vs {labels[0]} max abs "
                               f"logit diff {g} ({what} {tol})")
    log(f"{tag}: {steps} decode steps, max abs logit diff vs {labels[0]}: "
        + ", ".join(f"{k} {v:.3e}" for k, v in gaps.items())
        + f" (tol {tol}; planted faults, which must exceed it: "
        f"{', '.join(controls) or 'none'})")
    return gaps


def _clone_cache(c):
    return {part: [{n: x.clone() for n, x in g.items()} for g in gs]
            for part, gs in c.items()}


def _params(cfg, dev, seed=0):
    import torch

    from repro_torch.models import model as M

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = M.init_params(cfg, gen)
    n = sum(x.numel() for x in [params["embed"], params["unembed"],
                                params["final_norm"]]
            + [x for g in params["groups"] + params["tail"]
               for x in g.values()])
    log(f"params: {cfg.name} {n / 1e9:.3f}B fp32 ({cfg.num_layers} layers "
        f"{''.join(k[0] for k in cfg.layer_kinds)}, d_model {cfg.d_model}, "
        f"{cfg.num_heads}/{cfg.num_kv_heads} heads of {cfg.head_dim_}, d_ff "
        f"{cfg.d_ff}, experts {cfg.num_experts}/{cfg.experts_per_token}, "
        f"window {cfg.window}, vocab {cfg.vocab_size})")
    return params


def run_long_prompt(cfg, params, dev):
    """The paper's model on the default route past 2^21 score elements:
    one 4096-token ``M.prefill`` on ``auto`` (its blocked-flash branch)
    against ``kernel``."""
    toks = _prompt(cfg, 4096, dev)
    gaps, _ = prefill_agree(f"{cfg.name} long prompt", cfg, params, toks,
                            ["auto"], "kernel")
    return gaps["auto"]


def run_families(dev, tmp):
    """gemma3-4b and granite-moe-1b-a400m at full width and depth through
    engines A and C, with their kernels held on A's own inputs; gemma3-4b
    again on requests past its window; gemma3-4b's model roots on a
    prompt longer than its window (prefill on kernel / auto / dense, 8
    decode steps on the ring cache against the full-length one and
    against a planted fault); phi3.5-moe-42b-a6.6b at full width cut to
    2 layers (prefill 1 x 1024 and 8 decode steps, kernel against
    dense)."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    t0 = time.perf_counter()
    out = {}
    cfg = get_config("gemma3-4b")
    params = _params(cfg, dev)
    out["gemma3-4b"] = family_engines("gemma3-4b", cfg, params, tmp)
    out["gemma3-4b"]["path"] = measure_family_path(
        "gemma3-4b", *out["gemma3-4b"].pop("recorders"))
    # requests past the window: 5 chunks of at least window / 5 tokens
    # each, so that the window masks keys in the prefill windows and in
    # decode on the engine's path (the arena and pool hold local layers
    # at full length, the mask applies the window)
    n = -(-cfg.window // 5)
    out["gemma3-4b long"] = family_engines(
        "gemma3-4b long", cfg, params, tmp, num_requests=4,
        kb_kw=dict(chunk_len_min=n, chunk_len_max=n + 40))
    out["gemma3-4b long"].pop("recorders")
    masked = out["gemma3-4b long"]["window_masked"]
    if min(masked.values()) <= 0:
        raise RuntimeError("gemma3-4b long: the window masked nothing in "
                           f"engine A: {masked}")
    T = 2048
    toks = _prompt(cfg, T, dev)
    # ring caches (the default): local layers keep the last 1024 tokens
    gaps, outs = prefill_agree("gemma3-4b", cfg, params, toks,
                               ["kernel", "auto"], "dense",
                               cache_len=T + 8)
    ring = outs["kernel"].cache
    del outs["auto"], outs["dense"]
    if ring["groups"][cfg.pattern.index("local")]["k"].shape[2] != \
            cfg.window:
        raise RuntimeError("gemma3-4b: the local layers' cache is not a "
                           f"ring of {cfg.window} slots")
    full = M.prefill(cfg, params, toks, attn_impl="kernel",
                     cache_len=T + 8, ring=False).cache
    first = outs["kernel"].logits[:, -1].argmax(-1).to(toks.dtype)
    ring2, lost = _clone_cache(ring), _clone_cache(ring)
    # the planted fault: each local layer's ring without its oldest live
    # key at the first decode step (position T - window + 1, in slot
    # (T + 1) % window), which is what a decode write one slot off does
    for kind, g in zip(list(cfg.pattern) * (cfg.n_groups > 0)
                       + list(cfg.layer_kinds[cfg.n_groups
                                              * len(cfg.pattern):]),
                       lost["groups"] + lost["tail"]):
        if kind == "local":
            g["pos"][..., (T + 1) % cfg.window] = -1
    dgaps = decode_agree("gemma3-4b ring vs full cache", cfg, params,
                         {"full": (full, "kernel"), "ring": (ring, "kernel"),
                          "ring dense": (ring2, "dense"),
                          "ring without its oldest live key":
                              (lost, "kernel")},
                         first, T, tol=RING_TOL,
                         controls=("ring without its oldest live key",))
    out["gemma3-4b roots"] = dict(prefill=gaps, decode=dgaps)
    del params, outs, full, ring, ring2, lost
    _free()

    cfg = get_config("granite-moe-1b-a400m")
    params = _params(cfg, dev)
    out["granite-moe-1b-a400m"] = family_engines("granite-moe-1b-a400m", cfg,
                                                 params, tmp)
    out["granite-moe-1b-a400m"]["path"] = measure_family_path(
        "granite-moe-1b-a400m", *out["granite-moe-1b-a400m"].pop("recorders"))
    del params
    _free()

    cfg = get_config("phi3.5-moe-42b-a6.6b").replace(num_layers=2)
    params = _params(cfg, dev)
    T = 1024
    toks = _prompt(cfg, T, dev)
    gaps, outs = prefill_agree("phi3.5-moe-42b-a6.6b/2", cfg, params, toks,
                               ["kernel"], "dense", cache_len=T + 8)
    first = outs["dense"].logits[:, -1].argmax(-1).to(toks.dtype)
    dgaps = decode_agree("phi3.5-moe-42b-a6.6b/2", cfg, params,
                         {"dense": (outs["dense"].cache, "dense"),
                          "kernel": (outs["kernel"].cache, "kernel")},
                         first, T)
    out["phi3.5-moe-42b-a6.6b/2"] = dict(prefill=gaps, decode=dgaps)
    del params, outs
    _free()
    out["seconds"] = time.perf_counter() - t0
    log(f"families phase: {out['seconds']:.1f}s")
    return out


# ---------------------------------------------------------------------------
# phase 11: the recurrent and vision families through the model roots
# ---------------------------------------------------------------------------
def _recorded_launches(run):
    """Runs ``run()`` with the chunk and decode counts set to 0 just before
    it and the calls recorded; returns its result, the launches and the
    recorders."""
    from repro_torch.kernels.chunk_attention import ops as cops
    from repro_torch.kernels.decode_attention import ops as dops

    cops.chunk_attention.launches = 0
    dops.decode_attention.launches = 0
    with ChunkRecorder(cops) as cc, DecodeRecorder(dops) as dc:
        res = run()
    return res, {"chunk_attention": cops.chunk_attention.launches,
                 "decode_attention": dops.decode_attention.launches}, cc, dc


def _expect_launches(tag, launches, want):
    log(f"{tag}: kernel launches {json.dumps(launches)} (expected "
        f"{json.dumps(want)})")
    if launches != want:
        raise RuntimeError(f"{tag}: launches {launches}, expected {want}")


RG_TOKENS = 4096            # recurrentgemma-9b's prompt, twice its window
VISION_LAYERS = 5           # llama-3.2-vision-90b cut to one group
VISION_TOKENS = (1024, 2048)


def run_recurrentgemma(dev):
    """recurrentgemma-9b at full width and depth (38 layers: 26 rglru, 12
    local with a 2048-key window, the tail of two rglru), fp32, one prompt
    of RG_TOKENS tokens: prefill on kernel / auto / dense within
    LOGIT_TOL, 8 greedy decode steps on kernel against dense within it
    (the counted run), the ring cache against a full-length one within
    RING_TOL, decode after the prefill against the prefill extended by
    that token within LOGIT_TOL; the chunk and decode kernels on the
    recorded inputs; prefill, decode step and one full-width rglru_scan
    timed."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.training import steps as TS

    tag = "recurrentgemma-9b"
    cfg = get_config(tag)
    params = _params(cfg, dev)
    T, n_local = RG_TOKENS, cfg.layer_kinds.count("local")
    toks = _prompt(cfg, T, dev)

    def counted():
        gaps, outs = prefill_agree(tag, cfg, params, toks, ["kernel", "auto"],
                                   "dense", cache_len=T + 8)
        del outs["auto"]
        ring = outs["kernel"].cache
        if ring["groups"][cfg.pattern.index("local")]["k"].shape[2] != \
                cfg.window:
            raise RuntimeError(f"{tag}: the local layers' cache is not a "
                               f"ring of {cfg.window} slots")
        first = outs["kernel"].logits[:, -1].argmax(-1).to(toks.dtype)
        kept = _clone_cache(ring)
        dgaps = decode_agree(tag, cfg, params,
                             {"dense": (outs["dense"].cache, "dense"),
                              "kernel": (ring, "kernel")}, first, T)
        return gaps, dgaps, kept, first
    (gaps, dgaps, ring, first), launches, cc, dc = _recorded_launches(counted)
    # one chunk call per local layer, one decode call per local layer a step
    _expect_launches(tag, launches, {"chunk_attention": n_local,
                                     "decode_attention": 8 * n_local})
    out = dict(prefill=gaps, decode=dgaps, launches=launches)
    # decode after the prefill of T == the prefill of T + 1, last position
    pos = torch.full((1,), T, dtype=torch.int32, device=dev)
    step = M.decode_step(cfg, params, first, pos, _clone_cache(ring),
                         attn_impl="kernel").logits[:, -1]
    ext = M.prefill(cfg, params, torch.cat([toks, first[:, None]], 1),
                    attn_impl="kernel", cache_len=T + 8).logits[:, -1]
    out["extended"] = _max_diff(step, ext)
    del ext
    log(f"{tag}: decode after the {T}-token prefill vs the {T + 1}-token "
        f"prefill's last position: max abs logit diff "
        f"{out['extended']:.3e} (tol {LOGIT_TOL})")
    if not out["extended"] <= LOGIT_TOL:
        raise RuntimeError(f"{tag}: decode vs extended prefill "
                           f"{out['extended']} > {LOGIT_TOL}")
    full = M.prefill(cfg, params, toks, attn_impl="kernel", cache_len=T + 8,
                     ring=False).cache
    out["ring"] = decode_agree(f"{tag} ring vs full cache", cfg, params,
                               {"full": (full, "kernel"),
                                "ring": (_clone_cache(ring), "kernel")},
                               first, T, tol=RING_TOL)["ring"]
    del full
    _free()
    # times: the serving roots, and one full-width layer's scan
    root = TS.make_prefill_step(cfg, "kernel")
    out["prefill_ms"] = cuda_ms(lambda: root(params, {
        "tokens": toks, "cache": M.init_cache(cfg, 1, T + 8, device=dev)}),
        iters=3, warmup=1)
    c = _clone_cache(ring)
    out["decode_step_ms"] = cuda_ms(lambda: M.decode_step(
        cfg, params, first, pos, c, attn_impl="kernel"), iters=10)
    p = {n: params["groups"][0][n][0] for n in ("lam", "alpha", "beta")}
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    b = torch.randn((1, T, cfg.rnn_width_), generator=gen, device=dev)
    out["rglru_scan_ms"] = cuda_ms(lambda: L.rglru_scan(
        b, p["lam"], p["alpha"], p["beta"]), iters=10)
    log(f"{tag}: prefill {out['prefill_ms']:.1f} ms ({T} tokens, "
        f"make_prefill_step, kernel), decode step "
        f"{out['decode_step_ms']:.2f} ms, rglru_scan "
        f"{out['rglru_scan_ms']:.3f} ms ([1, {T}, {cfg.rnn_width_}] fp32, "
        f"{(T - 1).bit_length()} rounds)")
    del params, ring, c, b
    _free()
    out["path"] = measure_family_path(tag, cc, dc)
    return out


def run_vision(dev):
    """llama-3.2-vision-90b at full width cut to VISION_LAYERS layers (one
    group: 4 attn + 1 xattn), fp32, the xattn gates set nonzero from the
    seed (zero at init, where the layer adds nothing), media [1, 1600,
    8192] from the seed. For each prompt of VISION_TOKENS (1024 x 1600
    score elements take the dense cross-attention, 2048 x 1600 its blocked
    flash): prefill on kernel against dense within LOGIT_TOL, 8 decode
    steps reading the cached media K and V, kernel against dense (the
    counted run); the planted control, the same run with the media zeroed,
    must move the logits above LOGIT_TOL in the prefill and in decode."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    full = get_config("llama-3.2-vision-90b")
    cfg = full.replace(num_layers=VISION_LAYERS)
    tag = f"{cfg.name}/{VISION_LAYERS}"
    log(f"{tag}: cut to {VISION_LAYERS} of {full.num_layers} layers "
        f"({''.join(k[0] for k in cfg.layer_kinds)}; the full model is "
        f"{full.param_count() * 4 / 1e9:.0f} GB in fp32)")
    params = _params(cfg, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    for g, kind in zip(params["groups"], cfg.pattern):
        if kind == "xattn":
            for n in ("gate_attn", "gate_ffn"):
                g[n].copy_(0.5 + torch.rand(g[n].shape, generator=gen,
                                            device=dev))
    media = torch.randn((1, cfg.num_media_tokens, cfg.d_model),
                        generator=gen, device=dev)
    zero = torch.zeros_like(media)
    n_attn = cfg.layer_kinds.count("attn")

    def counted():
        res = {}
        for T in VISION_TOKENS:
            toks = _prompt(cfg, T, dev)
            gaps, outs = prefill_agree(f"{tag} {T}", cfg, params, toks,
                                       ["kernel"], "dense", cache_len=T + 8,
                                       media=media)
            z = M.prefill(cfg, params, toks, attn_impl="dense",
                          cache_len=T + 8, media=zero)
            zgap = _max_diff(z.logits[:, -1],
                             outs["dense"].logits[:, -1])
            log(f"{tag} {T}: zeroed media moves the last position's logits "
                f"by {zgap:.3e} (a planted fault, must exceed {LOGIT_TOL})")
            if not zgap > LOGIT_TOL:
                raise RuntimeError(f"{tag} {T}: zeroed media moved the "
                                   "logits by no more than the bound")
            first = outs["dense"].logits[:, -1].argmax(-1).to(toks.dtype)
            dgaps = decode_agree(
                f"{tag} {T}", cfg, params,
                {"dense": (outs["dense"].cache, "dense"),
                 "kernel": (outs["kernel"].cache, "kernel"),
                 "zeroed media": (z.cache, "dense")},
                first, T, controls=("zeroed media",))
            res[T] = dict(prefill=gaps, zeroed_prefill=zgap, decode=dgaps)
            del outs, z
        return res
    out, launches, cc, dc = _recorded_launches(counted)
    # one chunk call per attn layer and prompt, one decode call per attn
    # layer, prompt and step (the xattn layers run no kernel)
    _expect_launches(tag, launches, {
        "chunk_attention": len(VISION_TOKENS) * n_attn,
        "decode_attention": 8 * len(VISION_TOKENS) * n_attn})
    out["launches"] = launches
    del params, media, zero
    _free()
    out["path"] = measure_family_path(tag, cc, dc)
    return out


def run_recurrent_vision(dev):
    t0 = time.perf_counter()
    out = {"recurrentgemma-9b": run_recurrentgemma(dev)}
    out[f"llama-3.2-vision-90b/{VISION_LAYERS}"] = run_vision(dev)
    out["seconds"] = time.perf_counter() - t0
    log(f"recurrent and vision phase: {out['seconds']:.1f}s")
    return out


# ---------------------------------------------------------------------------
# phase 14: sharded training and the dry-run
# ---------------------------------------------------------------------------
# a (data 4, model 1) mesh on the one card; 8 x 512 tokens, the 4096 of
# phase 5's batch, so that accum 2 x dp 4 divides the rows
SHARD_DP, SHARD_BATCH, SHARD_SEQ, SHARD_STEPS = 4, 8, 512, 3
# tests/test_torch_training.py: each loss, and the final params (the
# reference's own accumulation tolerance, tests/test_training.py)
LOSS_RTOL = 1e-5
PARAM_TOL = dict(rtol=2e-4, atol=1e-4)
# AdamW's step lr * m / (sqrt(v) + eps) is ~ +-lr wherever |grad| >> eps
# and swings with a grad near eps = 1e-8: an embedding element whose few
# contributions nearly cancel moves by a good part of lr when the fp32
# sums run in another order (data-parallel shards against one batch).
# On the H100 at full width that was 4 of llama3-8b's 525M embedding
# elements (gap 1.31e-4) and 1 of mamba2's 51.6M (1.39e-4), their v at
# ~3.4e-10 (PERF.md §6). So, as tests/test_torch_training.py
# allows tiny mamba2's first step: at most FLIP_SHARE of a leaf may lie
# outside PARAM_TOL, each element within twice the lr summed over the
# compared steps (the most a changed sign of the step can move it)
FLIP_SHARE = 1e-6
# mamba2's init has a grad norm of ~1e5, so clipping leaves many of its
# grad elements near AdamW's eps = 1e-8 and below the rounding of their
# own sums: an element moves by a good part of lr in one step of either
# sharded route, data-parallel too (PERF.md §6). Where a check says so it
# takes the CPU tests' allowance (tests/test_torch_tp_training.py)
# instead of FLIP_SHARE: every element outside PARAM_TOL one whose grads
# both runs' second moments put below FLIP_GRAD (sqrt(v / bc2)), within
# twice the summed lr
FLIP_GRAD = 1e-6
DRYRUN_CELLS = (("train_4k", False), ("prefill_32k", False),
                ("prefill_32k", True), ("decode_32k", False))


def _dryrun_cell(shape, cc):
    """One llama3-8b dry-run cell on the single production mesh, on meta
    (a worker process: CPU only)."""
    from repro_torch.launch import dryrun
    return dryrun.run_cell("llama3-8b", shape, "single", cc=cc)


def _shard_setup(cfg, dev, seed=0):
    """A fresh state from ``seed`` on ``dev``, the phase's AdamW config
    and its synthetic batches."""
    import torch

    from repro_torch.training import steps as TS
    from repro_torch.training.data import DataConfig, SyntheticLM
    from repro_torch.training.optimizer import AdamWConfig
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    data = SyntheticLM(DataConfig(seq_len=SHARD_SEQ, global_batch=SHARD_BATCH,
                                  vocab_size=cfg.vocab_size))

    def batch(i):
        return {k: torch.from_numpy(v).to(dev)
                for k, v in data.batch(i).items()}
    return (TS.init_train_state(cfg, gen), AdamWConfig(**_train_opt(cfg)),
            batch)


def _peak(dev):
    import torch
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else None


def _reset_peak(dev):
    import torch
    _free()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def _steps(step, state, batch, dev, first=0, n=SHARD_STEPS, auxes=None):
    """``n`` steps from batch ``first``: (state, losses, ms per step on
    the host clock around work that ends in a synchronise, lrs); each
    step's per-microbatch MoE aux loss appended to ``auxes``."""
    from repro_torch import device as devmod
    losses, ms, lrs = [], [], []
    for i in range(first, first + n):
        b = batch(i)
        devmod.sync(dev)
        t0 = time.perf_counter()
        state, m = step(state, b)
        losses.append(float(m["loss"]))
        lrs.append(float(m["lr"]))
        devmod.sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
        if auxes is not None:
            auxes.append([float(a) for a in m["aux_micro"]])
    return state, losses, ms, lrs


def _host_state(state, keep=("params", "m", "v")):
    """Copies on the host of an unsharded state's params, ``m`` and
    ``v`` (those ``keep`` names), with the leaf names."""
    from repro_torch.training.optimizer import tree_leaves
    trees = {"params": state.params, "m": state.opt["m"],
             "v": state.opt["v"]}
    return dict(names=_leaf_names(state.params), **{
        k: [x.detach().to("cpu", copy=True) for x in tree_leaves(trees[k])]
        for k in keep})


def _leaf_names(tree, prefix=""):
    """Leaf paths in ``tree_leaves`` order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in _leaf_names(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree)
                for n in _leaf_names(v, f"{prefix}/{i}")]
    return [prefix]


def _params_gap(names, got_leaves, want_leaves, extra=()):
    """(worst abs diff, the leaves outside PARAM_TOL) of two leaf lists;
    per leaf outside: its name, the elements outside, the worst gap and,
    at that element, both values and those of ``extra`` (pairs of leaf
    lists, such as the two runs' ``v``)."""
    import torch
    worst, bad = 0.0, []
    for j, (n, g, w) in enumerate(zip(names, got_leaves, want_leaves,
                                      strict=True)):
        g, w = g.detach(), w.detach().to(g.device)
        d = (g - w).abs()
        worst = max(worst, float(d.max()))
        out = ~torch.isclose(g, w, **PARAM_TOL)
        if out.any():
            i = int(d.flatten().argmax())
            bad.append(dict(leaf=n, shape=list(g.shape), numel=g.numel(),
                            outside=int(out.sum()), gap=float(d.max()),
                            at=[float(g.flatten()[i]), float(w.flatten()[i])]
                            + [[float(a[j].detach().flatten()[i]),
                                float(b[j].detach().flatten()[i])]
                               for a, b in extra]))
    return worst, bad


def _rounding_flips(got, want, got_v, want_v, lrs, b2, count) -> bool:
    """Every element of the param leaves ``got`` outside PARAM_TOL of
    ``want`` has sqrt(max(v) / bc2) < FLIP_GRAD in both runs' second
    moments and lies within 2 x the summed lr (``FLIP_GRAD``)."""
    import torch
    bc2 = 1 - b2 ** count
    for g, w, gv, wv in zip(got, want, got_v, want_v, strict=True):
        g, w = g.detach(), w.detach().to(g.device)
        bad = ~torch.isclose(g, w, **PARAM_TOL)
        if not bad.any():
            continue
        rms = torch.sqrt(torch.maximum(gv.detach(), wv.detach().to(
            g.device)) / bc2)[bad]
        if (rms >= FLIP_GRAD).any() or \
                ((g - w).abs()[bad] > 2 * sum(lrs)).any():
            return False
    return True


def _flips_only(bad, lrs) -> bool:
    """Every leaf outside PARAM_TOL has at most FLIP_SHARE of its elements
    there, each within 2 x the summed lr (``FLIP_SHARE``)."""
    return all(b["outside"] <= FLIP_SHARE * b["numel"]
               and b["gap"] <= 2 * sum(lrs) for b in bad)


def zero1_check(cfg, dev):
    """``SHARD_STEPS`` steps of ``cfg`` unsharded, then data-parallel over
    a (data 4, model 1) mesh on ``dev`` (``make_train_step(...,
    grad_specs=...)``) from the same init: losses within LOSS_RTOL, final
    params within PARAM_TOL (but for AdamW's sign flips, ``FLIP_SHARE``),
    every ZeRO-1-split leaf's grad block and
    ``m`` / ``v`` shards exactly 1/4 of the leaf (``shard_bytes`` and the
    tensors), the counted reduce-scatter / all-gather / all-reduce bytes
    equal to the dry-run's closed form, and on the card the sharded peak
    memory within one fp32 copy of the params of the unsharded one."""
    import numpy as np

    from repro_torch.distributed import collectives as CO
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import data_axes, make_debug_mesh
    from repro_torch.training import steps as TS
    from repro_torch.training.optimizer import tree_leaves

    _reset_peak(dev)
    state, opt, batch = _shard_setup(cfg, dev)
    param_bytes = sum(x.numel() * 4 for x in tree_leaves(state.params))
    step = TS.make_train_step(cfg, opt, accum=TRAIN_ACCUM)
    state, loss_plain, ms_plain, lrs = _steps(step, state, batch, dev)
    peak_plain = _peak(dev)
    plain = dict(_host_state(state), losses=loss_plain, ms=ms_plain,
                 lrs=lrs, peak=peak_plain)
    names, want, want_v = plain["names"], plain["params"], plain["v"]
    del state, step
    _reset_peak(dev)
    mesh = make_debug_mesh((SHARD_DP, 1), device=dev)
    shs = TS.train_shardings(cfg, mesh)
    state, opt, batch = _shard_setup(cfg, dev)
    sst = TS.shard_state(state, shs)
    del state
    step = TS.make_train_step(cfg, opt, accum=TRAIN_ACCUM,
                              grad_specs=shs["opt"]["m"])
    CO.reset_bytes()
    sst, loss_sh, ms_sh, _ = _steps(step, sst, batch, dev)
    peak_sh = _peak(dev)
    counted = dict(CO.BYTES)
    closed = {k: SHARD_STEPS * v for k, v in
              dryrun.zero1_collective_bytes(cfg, mesh, TRAIN_ACCUM).items()}
    worst, bad = _params_gap(
        names, [SH.unshard(st) for st in tree_leaves(sst.params)], want,
        extra=[([SH.unshard(st) for st in tree_leaves(sst.opt["v"])],
                want_v)])
    split = {"leaves": 0, "leaf_bytes": 0, "shard_bytes": 0}
    for st, g, m, v in zip(tree_leaves(sst.params),
                           tree_leaves(shs["opt"]["m"]),
                           tree_leaves(sst.opt["m"]),
                           tree_leaves(sst.opt["v"])):
        if SH.data_dim(g.spec, data_axes(mesh)) is None:
            continue
        per = SH.shard_bytes(st.shape, st.dtype, g)
        full = 4 * int(np.prod(st.shape))
        if per * SHARD_DP != full or any(
                x.numel() * 4 != per for x in list(m.shards.flat)
                + list(v.shards.flat)):
            raise RuntimeError(f"zero1: a shard of a {st.shape} leaf holds "
                               f"{per} of {full} bytes")
        split["leaves"] += 1
        split["leaf_bytes"] += full
        split["shard_bytes"] += per
    rel = float(np.max(np.abs(np.array(loss_sh) - loss_plain)
                       / np.abs(loss_plain)))
    out = dict(model=f"{cfg.name}/{cfg.num_layers}", dp=SHARD_DP,
               tokens=f"{SHARD_BATCH} x {SHARD_SEQ}", accum=TRAIN_ACCUM,
               losses_plain=loss_plain, losses_sharded=loss_sh,
               loss_rel_gap=rel, params_worst_abs=worst,
               params_outside_tol=bad, flip_bound=2 * sum(lrs),
               step_ms_plain=ms_plain,
               step_ms_sharded=ms_sh, peak_gb_plain=peak_plain and
               peak_plain / 1e9, peak_gb_sharded=peak_sh and peak_sh / 1e9,
               param_fp32_gb=param_bytes / 1e9, zero1_split=split,
               coll_bytes_counted=counted, coll_bytes_closed_form=closed)
    log(f"zero1 {out['model']} on a (data {SHARD_DP}, model 1) mesh: "
        + json.dumps(out))
    if rel > LOSS_RTOL or not _flips_only(bad, lrs):
        raise RuntimeError(f"zero1: sharded vs unsharded loss gap {rel:.3e}, "
                           f"leaves outside {PARAM_TOL}: {bad}")
    if split["shard_bytes"] * SHARD_DP != split["leaf_bytes"] or \
            not split["leaves"]:
        raise RuntimeError(f"zero1: shards are not 1/{SHARD_DP}: {split}")
    if counted != closed:
        raise RuntimeError(f"zero1: counted collective bytes {counted} != "
                           f"the closed form {closed}")
    if peak_sh is not None and peak_sh > peak_plain + param_bytes:
        raise RuntimeError(f"zero1: sharded peak {peak_sh / 1e9:.2f} GB > "
                           f"unsharded {peak_plain / 1e9:.2f} GB + one fp32 "
                           f"copy of the params ({param_bytes / 1e9:.2f})")
    return out, plain


def elastic_check(cfg, dev, tmp):
    """2 steps on (data 4, model 1), ``checkpoint.save``, then
    ``restore(shardings=...)`` onto (data 2, model 1): every restored
    shard equals its slice of the saved array byte for byte, and a 3rd
    step there matches a 3rd step on data 4 within LOSS_RTOL / PARAM_TOL
    (but for AdamW's sign flips, ``FLIP_SHARE``)."""
    import numpy as np
    import torch

    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training import steps as TS
    from repro_torch.training.optimizer import tree_leaves

    _reset_peak(dev)
    sh4, sh2 = (TS.train_shardings(cfg, make_debug_mesh((n, 1), device=dev))
                for n in (SHARD_DP, SHARD_DP // 2))
    state, opt, batch = _shard_setup(cfg, dev)
    st4 = TS.shard_state(state, sh4)
    del state
    step4 = TS.make_train_step(cfg, opt, accum=TRAIN_ACCUM,
                               grad_specs=sh4["opt"]["m"])
    st4, _, _, _ = _steps(step4, st4, batch, dev, n=2)
    t0 = time.perf_counter()
    ckpt.save(TS.state_to_tree(st4), tmp, 2)
    tree = ckpt.restore(tmp, shardings=sh2)
    io_s = time.perf_counter() - t0
    saved = ckpt.restore(tmp)
    shards = differ = 0
    for st, arr in zip(tree_leaves(tree), tree_leaves(saved)):
        for idx in np.ndindex(st.shards.shape):
            want = torch.from_numpy(np.array(
                arr[SH.shard_slices(arr.shape, st.sharding, idx)]))
            shards += 1
            differ += not torch.equal(st.shards[idx].detach().cpu(), want)
    del saved
    st2 = TS.sharded_state_from_tree(tree)
    step2 = TS.make_train_step(cfg, opt, accum=TRAIN_ACCUM,
                               grad_specs=sh2["opt"]["m"])
    st2, l2, _, lrs = _steps(step2, st2, batch, dev, first=2, n=1)
    st4, l4, _, _ = _steps(step4, st4, batch, dev, first=2, n=1)
    worst, bad = _params_gap(
        _leaf_names(st2.params),
        [SH.unshard(st) for st in tree_leaves(st2.params)],
        [SH.unshard(st) for st in tree_leaves(st4.params)])
    rel = abs(l2[0] - l4[0]) / abs(l4[0])
    out = dict(model=f"{cfg.name}/{cfg.num_layers}", saved_dp=SHARD_DP,
               restored_dp=SHARD_DP // 2, shards=shards,
               shards_differ=differ, save_restore_s=io_s,
               loss_dp2=l2[0], loss_dp4=l4[0], loss_rel_gap=rel,
               params_worst_abs=worst, params_outside_tol=bad,
               flip_bound=2 * sum(lrs))
    log("elastic restart: " + json.dumps(out))
    if differ or rel > LOSS_RTOL or not _flips_only(bad, lrs):
        raise RuntimeError(f"elastic restart: {out}")
    return out


def run_sharded(dev, card, training):
    """Phase 14: the ZeRO-1 data-parallel train step and the elastic
    restore on the card, the roofline figures of phase 5's llama3-8b/2
    step (``count_step`` on meta over the measured step time), and the
    dry-run's llama3-8b cells on the single production mesh, on meta in
    worker processes while the card works."""
    import concurrent.futures as cf
    import multiprocessing as mp

    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_debug_mesh
    rl = _roofline()
    t_phase = time.perf_counter()
    out = {}
    with cf.ProcessPoolExecutor(len(DRYRUN_CELLS),
                                mp_context=mp.get_context("spawn")) as pool:
        futs = [pool.submit(_dryrun_cell, s, cc) for s, cc in DRYRUN_CELLS]
        llama2 = get_config("llama3-8b").replace(num_layers=2)
        out["zero1"], plain = zero1_check(llama2, dev)
        with tempfile.TemporaryDirectory(prefix="chip-smoke-elastic-") \
                as tmp:
            out["elastic"] = elastic_check(
                get_config("mamba2-370m").replace(num_layers=2), dev, tmp)
        _free()
        # phase 5's llama3-8b/2 step (4 x 1024 tokens, accum 2, fp32):
        # its matrix-product FLOPs counted on meta, over its step time
        mesh = dryrun.meta_mesh(make_debug_mesh((1, 1), device="cpu"))
        flops, _ = dryrun.count_cell(llama2, "train", TRAIN_BATCH,
                                     TRAIN_SEQ, mesh, accum=TRAIN_ACCUM)
        t = training["llama3-8b/2"]
        out["roofline"] = dict(
            count_step_flops=flops,
            model_flops_6nd=rl.model_flops_6nd(llama2, "train",
                                               TRAIN_BATCH, TRAIN_SEQ),
            step_ms=t["step_ms"],
            achieved_tflops=flops / (t["step_ms"] / 1e3) / 1e12,
            share_of_fp32_peak=flops / (t["step_ms"] / 1e3)
            / rl.PEAK_FLOPS_BY_TYPE["float32"],
            mfu_fp32=t["mfu_fp32"])
        log(f"roofline of the llama3-8b/2 train step [{card}]: "
            + json.dumps(out["roofline"]))
        cells = [f.result(timeout=600) for f in futs]
    out["dryrun"] = {}
    for (shape, cc), rec in zip(DRYRUN_CELLS, cells):
        tag = shape + (" cc" if cc else "")
        if rec["status"] != "ok":
            raise RuntimeError(f"dry-run llama3-8b {tag}: {rec.get('error')}"
                               f"\n{rec.get('traceback')}")
        m, r = rec["memory"], rec["roofline"]
        out["dryrun"][tag] = dict(
            argument_gib=m["argument_gib"], resident_gib=m["resident_gib"],
            fits_80gb=m["fits_80gb"], dominant=r["dominant"],
            compute_s=r["compute_s"], memory_s=r["memory_s"],
            collective_s=r["collective_s"], count_s=rec["count_s"])
    log("dry-run llama3-8b, single production mesh (256 shards), meta, "
        "accounting with the H100 SXM constants: "
        + json.dumps(out["dryrun"]))
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 14 (sharded training and the dry-run): "
        f"{out['seconds']:.1f}s")
    return out, plain


# ---------------------------------------------------------------------------
# phase 15: tensor-parallel training and the MoE aux term from global means
# ---------------------------------------------------------------------------
# llama3-8b/2 on (data 2, model 4): heads 32/4, kv 8/4, d_ff 14336/4 and
# vocab 128256/4 all divide, so every Megatron route runs; granite-moe-1b
# on (data 4, model 1), the aux term alone, and (data 2, model 2): its 32
# experts, 16/8 heads and padded vocab split over 2
TP_MESH = (2, 4)
MOE_MESHES = ((4, 1), (2, 2))
# Top-k routing is discontinuous: a near tie that another order of the
# fp32 sums breaks the other way sends a token to other experts (a
# routing flip, ``Routes``); the change spreads through attention and,
# through AdamW's step (about lr whatever a grad's size), into the next
# steps. The unsharded step itself drifts so from an init whose
# embedding elements are scaled by 1 + MOE_CONTROL x N(0, 1), the noise
# drawn with each seed of MOE_SEEDS (the controls; PERF.md §6). So
# granite, at full width cut to MOE_CUT layers and whole, is held:
# * over the whole run to the parity standard where MOE_STRICT names
#   the run (no step of it flipped a route on the H100);
# * at MOE_CUT layers step by step: one sharded step from the unsharded
#   run's state before each of its steps, to the parity standard
#   wherever that step flips no route;
# * over the whole run on every mesh: its loss gap and its params
#   outside PARAM_TOL within MOE_DRIFT x the most of the controls' (or
#   within the parity standard), its params within twice the summed lr
MOE_CUT = 2
MOE_CONTROL = 2.0 ** -20
# the recurrent blocks split over "model" (rnn 4096 and 32 SSD heads of
# 64 divide 4): (arch, layers or None for all, mesh). recurrentgemma-9b
# at full width cut to its first group (rglru, rglru, local: ~2.7 B
# params, ~43 GB of fp32 train state with the grads), against its
# unsharded run kept on the host, to the parity standard. mamba2-370m's
# step drifts under any reordering of its fp32 sums: its clipped grads
# (the init's norm is ~1e5) leave many elements where AdamW's step turns
# on a near-cancelling sum (``FLIP_GRAD``), and the 48 random layers
# amplify rounding (the first forward's loss moves 2e-5 at 48 layers,
# none at 2; PERF.md §6). So it is held as granite is: at MOE_CUT layers
# one sharded step from each unsharded state to the parity standard
# (with FLIP_GRAD's allowance), and at 2 and 48 layers the free-running
# run within MOE_DRIFT x the most of the MOE_SEEDS controls' drift
RECURRENT_TP = (("recurrentgemma-9b", 3, (1, 4)),
                ("mamba2-370m", MOE_CUT, (2, 4)),
                ("mamba2-370m", None, (2, 4)))
MOE_SEEDS = (1, 2, 3)
MOE_STRICT = {(MOE_CUT, (4, 1))}
MOE_DRIFT = 4.0


class Routes:
    """Records the expert ids of every MoE layer's forward pass while it
    lives (``close`` ends it): per ``Ctx`` (a microbatch, or a data shard
    of one) in the order first seen, the sorted top-k ids [tokens, k] of
    each layer. The recomputation inside the backward pass is not read."""

    def __init__(self):
        from repro_torch.models import model as M
        from repro_torch.training import steps as TS
        self.rec, self.bwd = [], False
        route, grads = M._moe_route, TS._grads

        def rec_route(ctx, p, h):
            out = route(ctx, p, h)
            if not self.bwd:
                ids = out[3].detach()
                self.rec.append((ctx, ids.sort(-1).values.reshape(
                    -1, ids.shape[-1]).cpu()))
            return out

        def rec_grads(loss, leaves):
            self.bwd = True
            try:
                return grads(loss, leaves)
            finally:
                self.bwd = False

        def close():
            M._moe_route, TS._grads = route, grads
        self.close = close
        M._moe_route, TS._grads = rec_route, rec_grads

    def take(self, dp):
        """The ids recorded since the last ``take`` per (microbatch,
        layer) [tokens, k], the ``dp`` data shards' rows put together in
        shard order."""
        import torch
        by = []
        for ctx, ids in self.rec:
            for c, lst in by:
                if c is ctx:
                    lst.append(ids)
                    break
            else:
                by.append((ctx, [ids]))
        self.rec = []
        lists = [lst for _, lst in by]
        return [[torch.cat([lists[i + d][j] for d in range(dp)])
                 for j in range(len(lists[i]))]
                for i in range(0, len(lists), dp)]


def flips(a, b) -> int:
    """Tokens, over microbatches and layers, whose expert sets differ
    between two ``Routes.take``s."""
    return int(sum(int((x != y).any(-1).sum())
                   for ma, mb in zip(a, b, strict=True)
                   for x, y in zip(ma, mb, strict=True)))


def _snapshot(state):
    """A copy of an unsharded state on its device."""
    from repro_torch.training import steps as TS
    from repro_torch.training.optimizer import tree_leaves, tree_unflatten

    def cp(tree):
        return tree_unflatten(tree, [x.detach().clone()
                                     for x in tree_leaves(tree)])
    return TS.TrainState(step=state.step.clone(), params=cp(state.params),
                         opt={"m": cp(state.opt["m"]),
                              "v": cp(state.opt["v"]),
                              "count": state.opt["count"].clone()})


def _plain_run(cfg, dev, routes=None, noise=0.0, seed=1, snaps=False):
    """``SHARD_STEPS`` unsharded steps of ``cfg`` from ``_shard_setup``'s
    init, each embedding element scaled by 1 + ``noise`` x N(0, 1) (the
    noise drawn with ``seed``) where ``noise`` is given: ``_host_state``
    and the run's figures; with ``routes`` each step's routing ("ids"),
    with ``snaps`` copies on ``dev`` of the state before each step and
    after the last ("snaps")."""
    import torch

    from repro_torch.training import steps as TS
    _reset_peak(dev)
    state, opt, batch = _shard_setup(cfg, dev)
    if noise:
        e = state.params["embed"]
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        with torch.no_grad():
            e.mul_(1 + noise * torch.randn(e.shape, generator=gen,
                                           device=e.device))
    aux = [] if cfg.num_experts else None
    step = TS.make_train_step(cfg, opt, accum=TRAIN_ACCUM)
    out = dict(ids=[], snaps=[] if snaps else None, losses=[], ms=[],
               lrs=[])
    if routes is not None:
        routes.rec = []
    for t in range(SHARD_STEPS):
        if snaps:
            out["snaps"].append(_snapshot(state))
        state, loss, ms, lrs = _steps(step, state, batch, dev, first=t, n=1,
                                      auxes=aux)
        for k, v in (("losses", loss), ("ms", ms), ("lrs", lrs)):
            out[k] += v
        if routes is not None:
            out["ids"].append(routes.take(1))
    if snaps:
        out["snaps"].append(_snapshot(state))
    keep = ("params",) if noise else ("params", "m", "v")
    return dict(out, **_host_state(state, keep), peak=_peak(dev), aux=aux)


def _drift(run, plain):
    """An unsharded run's drift from ``plain``: its worst loss gap
    relative to ``plain``'s and each step's, its params outside PARAM_TOL
    and worst param gap, and its routing flips per step."""
    import numpy as np
    worst, bad = _params_gap(plain["names"], run["params"], plain["params"])
    gaps = np.abs(np.array(run["losses"]) - plain["losses"]) / np.abs(
        plain["losses"])
    return dict(loss_rel_gap=float(gaps.max()), loss_rel_gaps=gaps.tolist(),
                params_outside=sum(b["outside"] for b in bad),
                params_worst_abs=worst,
                flips=[flips(a, b) for a, b in zip(run["ids"],
                                                   plain["ids"])])


class _Unsharded:
    """The logical tensors of a list of ``ShardedTensor`` leaves, each put
    together only when it is read, so that a full-width sharded state
    and a whole copy of it need not fit the card together."""

    def __init__(self, leaves):
        self.leaves = leaves

    def __len__(self):
        return len(self.leaves)

    def __getitem__(self, j):
        from repro_torch.distributed import sharding as SH
        return SH.unshard(self.leaves[j])


def tp_check(cfg, dev, shape, plain, routes=None, controls=None):
    """``SHARD_STEPS`` steps of ``cfg`` on a ``shape`` (data, model) mesh
    on ``dev`` from ``_shard_setup``'s init, against the unsharded run
    ``plain`` (``_plain_run``): losses within LOSS_RTOL, params within
    PARAM_TOL (AdamW's sign flips aside, ``FLIP_SHARE``), ``m`` and ``v``
    within PARAM_TOL ("strict"), the counted collective bytes equal to
    ``tp_collective_bytes`` plus ``zero1_collective_bytes``, and what
    mesh position 0 holds of params, ``m`` and ``v`` equal to their
    layouts' ``shard_bytes``. With ``controls`` (``_drift``s of unsharded
    runs from perturbed inits, for a config with experts) the run's
    routing flips per step against ``plain`` (``routes``), and the
    parity standard only where ``MOE_STRICT`` names the run; else its
    loss gap and params outside PARAM_TOL within ``MOE_DRIFT`` x the
    controls' most, its params within twice the summed lr."""
    import numpy as np

    from repro_torch.distributed import collectives as CO
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.training import steps as TS
    from repro_torch.training.optimizer import tree_leaves

    _reset_peak(dev)
    mesh = make_debug_mesh(shape, device=dev)
    shs = TS.train_shardings(cfg, mesh)
    state, opt, batch = _shard_setup(cfg, dev)
    sst = TS.shard_state(state, shs)
    del state
    step = TS.make_train_step(cfg, opt, accum=TRAIN_ACCUM,
                              grad_specs=shs["opt"]["m"])
    CO.reset_bytes()
    aux = [] if cfg.num_experts else None
    losses, ms, lrs, ids = [], [], [], []
    if routes is not None:
        routes.rec = []
    for t in range(SHARD_STEPS):
        sst, loss, m_, lr = _steps(step, sst, batch, dev, first=t, n=1,
                                   auxes=aux)
        losses, ms, lrs = losses + loss, ms + m_, lrs + lr
        if routes is not None:
            ids.append(routes.take(shape[0]))
    peak = _peak(dev)
    counted = dict(CO.BYTES)
    z = dryrun.zero1_collective_bytes(cfg, mesh, TRAIN_ACCUM)
    t = dryrun.tp_collective_bytes(cfg, mesh, TRAIN_ACCUM, SHARD_BATCH,
                                   SHARD_SEQ)
    closed = {k: SHARD_STEPS * (z[k] + t[k]) for k in z}
    trees = {"params": sst.params, "m": sst.opt["m"], "v": sst.opt["v"]}
    pos = (0,) * len(shape)
    held = {k: sum(x.shards[pos].numel() * x.shards[pos].element_size()
                   for x in tree_leaves(tr)) for k, tr in trees.items()}
    layout = {k: sum(SH.shard_bytes(x.shape, x.dtype, x.sharding)
                     for x in tree_leaves(tr)) for k, tr in trees.items()}
    un = {k: _Unsharded(list(tree_leaves(tr))) for k, tr in trees.items()}
    del sst, step, trees
    worst, bad = _params_gap(plain["names"], un["params"], plain["params"],
                             extra=[(un["v"], plain["v"])])
    moments = {k: _params_gap(plain["names"], un[k], plain[k])
               for k in ("m", "v")}
    del un
    rel = float(np.max(np.abs(np.array(losses) - plain["losses"])
                       / np.abs(plain["losses"])))
    strict = rel <= LOSS_RTOL and _flips_only(bad, lrs) and \
        not moments["m"][1] and not moments["v"][1]
    outside = sum(b["outside"] for b in bad)
    out = dict(model=f"{cfg.name}/{cfg.num_layers}", mesh=list(shape),
               tokens=f"{SHARD_BATCH} x {SHARD_SEQ}", accum=TRAIN_ACCUM,
               losses_plain=plain["losses"], losses_sharded=losses,
               loss_rel_gap=rel, params_worst_abs=worst,
               params_outside_tol=bad if controls is None else outside,
               flip_bound=2 * sum(lrs),
               m_worst_abs=moments["m"][0], v_worst_abs=moments["v"][0],
               step_ms_plain=plain["ms"], step_ms_sharded=ms,
               peak_gb_plain=plain["peak"] and plain["peak"] / 1e9,
               peak_gb_sharded=peak and peak / 1e9,
               position0_bytes=held, layout_bytes=layout,
               coll_bytes_counted=counted, coll_bytes_closed_form=closed,
               strict=strict)
    if aux is not None:
        out.update(aux_plain=plain["aux"], aux_sharded=aux,
                   aux_rel_gap=float(np.max(np.abs(np.array(aux) - np.array(
                       plain["aux"])) / np.abs(plain["aux"]))))
    need_strict = controls is None or \
        (cfg.num_layers, tuple(shape)) in MOE_STRICT
    if controls is not None:
        out["flips"] = [flips(a, b) for a, b in zip(ids, plain["ids"])]
        out["control_loss_rel_gap"] = max(c["loss_rel_gap"]
                                          for c in controls)
        out["control_params_outside"] = max(c["params_outside"]
                                            for c in controls)
        out["control_flips"] = [c["flips"] for c in controls]
    log(f"tensor-parallel {out['model']} on a (data {shape[0]}, model "
        f"{shape[1]}) mesh: " + json.dumps(out))
    if need_strict and not strict:
        raise RuntimeError(
            f"tp {shape}: loss gap {rel:.3e}, leaves outside {PARAM_TOL}: "
            f"params {bad}, m {moments['m'][1]}, v {moments['v'][1]}")
    if controls is not None and not strict and (
            rel > MOE_DRIFT * out["control_loss_rel_gap"] or
            outside > MOE_DRIFT * out["control_params_outside"]):
        raise RuntimeError(
            f"tp {shape}: loss gap {rel:.3e}, {outside} params outside "
            f"{PARAM_TOL}, beyond {MOE_DRIFT} x the controls' most "
            f"({out['control_loss_rel_gap']:.3e}, "
            f"{out['control_params_outside']})")
    if worst > 2 * sum(lrs):
        raise RuntimeError(f"tp {shape}: a param moved {worst:.3e}, beyond "
                           f"twice the summed lr {2 * sum(lrs):.3e}")
    if counted != closed:
        raise RuntimeError(f"tp {shape}: counted collective bytes {counted}"
                           f" != the closed form {closed}")
    if held != layout:
        raise RuntimeError(f"tp {shape}: position 0 holds {held}, the "
                           f"layouts {layout}")
    if aux is not None and not all(a > 0 for s in aux for a in s):
        raise RuntimeError(f"tp {shape}: aux {aux}")
    return out


def one_step_check(cfg, dev, shape, plain, routes, flip_grad=False):
    """Before each of the unsharded run's steps, one sharded step on a
    ``shape`` mesh from the unsharded state (``plain["snaps"]``) on the
    same batch: per step its routing flips (with ``routes``; a config
    without experts flips none), loss gap, ``m`` / ``v`` and params
    against the unsharded step's; to the parity standard ("strict")
    wherever the step flips no route, its params with ``FLIP_GRAD``'s
    allowance in place of ``FLIP_SHARE``'s where ``flip_grad``."""
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.training import steps as TS
    from repro_torch.training.optimizer import tree_leaves

    mesh = make_debug_mesh(shape, device=dev)
    shs = TS.train_shardings(cfg, mesh)
    _, opt, batch = _shard_setup(cfg, dev)
    per = []
    for t in range(SHARD_STEPS):
        start = _snapshot(plain["snaps"][t])
        for x in tree_leaves(start.params):
            x.requires_grad_(True)
        sst = TS.shard_state(start, shs)
        del start
        step = TS.make_train_step(cfg, opt, accum=TRAIN_ACCUM,
                                  grad_specs=shs["opt"]["m"])
        if routes is not None:
            routes.rec = []
        sst, loss, _, lrs = _steps(step, sst, batch, dev, first=t, n=1)
        f = 0 if routes is None else flips(routes.take(shape[0]),
                                           plain["ids"][t])
        want = plain["snaps"][t + 1]
        pairs = {k: ([SH.unshard(x) for x in tree_leaves(g)],
                     list(tree_leaves(w)))
                 for k, g, w in (("params", sst.params, want.params),
                                 ("m", sst.opt["m"], want.opt["m"]),
                                 ("v", sst.opt["v"], want.opt["v"]))}
        gap = {k: _params_gap(plain["names"], *pw) for k, pw in pairs.items()}
        del sst, step
        rel = abs(loss[0] - plain["losses"][t]) / abs(plain["losses"][t])
        params_ok = _rounding_flips(*pairs["params"], *pairs["v"], lrs,
                                    opt.b2, t + 1) if flip_grad else \
            _flips_only(gap["params"][1], lrs)
        del pairs
        strict = rel <= LOSS_RTOL and params_ok and not gap["m"][1] and \
            not gap["v"][1]
        per.append(dict(step=t + 1, flips=f, loss_rel_gap=rel,
                        params_worst_abs=gap["params"][0],
                        params_outside=sum(b["outside"]
                                           for b in gap["params"][1]),
                        m_worst_abs=gap["m"][0], v_worst_abs=gap["v"][0],
                        strict=strict))
        if not f and not strict:
            raise RuntimeError(
                f"one step on {shape} from the unsharded state before step "
                f"{t + 1}: no route flipped, yet loss gap {rel:.3e}, "
                f"leaves outside {PARAM_TOL}: params {gap['params'][1]}, "
                f"m {gap['m'][1]}, v {gap['v'][1]}")
    log(f"one sharded step from the unsharded state, {cfg.name}/"
        f"{cfg.num_layers} on {list(shape)}: " + json.dumps(per))
    return per


def run_tp(dev, card, plain):
    """Phase 15: llama3-8b/2 on (data 2, model 4) against phase 14's
    unsharded steps (``plain``, emptied afterwards); the recurrent blocks
    split over "model" (``RECURRENT_TP``) against unsharded runs,
    mamba2-370m also against its controls and, cut, step by step on its
    mesh and on (data 2, model 1);
    granite-moe-1b-a400m
    at full width, cut to ``MOE_CUT`` layers and then whole, unsharded,
    its controls (``MOE_CONTROL``, ``MOE_SEEDS``), and on (data 4, model
    1) and (data 2, model 2), 8 x 512 tokens, accum 2, ``SHARD_STEPS``
    steps each (``tp_check``), at ``MOE_CUT`` layers also one sharded
    step from each unsharded state (``one_step_check``)."""
    from repro_torch.configs import get_config
    t_phase = time.perf_counter()
    llama2 = get_config("llama3-8b").replace(num_layers=2)
    out = {"llama3-8b/2": tp_check(llama2, dev, TP_MESH, plain)}
    plain.clear()
    for arch, layers, shape in RECURRENT_TP:
        t_case = time.perf_counter()
        cfg = get_config(arch)
        cfg = cfg.replace(num_layers=layers or cfg.num_layers)
        drifts = cfg.family == "ssm"
        cut = drifts and cfg.num_layers == MOE_CUT
        base = _plain_run(cfg, dev, snaps=cut)
        ctl = [_drift(_plain_run(cfg, dev, noise=MOE_CONTROL, seed=s), base)
               for s in MOE_SEEDS] if drifts else None
        r = tp_check(cfg, dev, shape, base, controls=ctl)
        if drifts:
            r["controls"] = ctl
        if cut:
            # and the data-parallel step alone beside it, which meets the
            # same allowance
            r["one_step"] = one_step_check(cfg, dev, shape, base, None,
                                           flip_grad=True)
            r["one_step_data_parallel"] = one_step_check(
                cfg, dev, (shape[0], 1), base, None, flip_grad=True)
        del base
        _free()
        r["seconds"] = time.perf_counter() - t_case
        out[f"{cfg.name}/{cfg.num_layers} {list(shape)}"] = r
    granite = get_config("granite-moe-1b-a400m")
    routes = Routes()
    try:
        for cfg in (granite.replace(num_layers=MOE_CUT), granite):
            cut = cfg.num_layers == MOE_CUT
            name = f"{cfg.name}/{cfg.num_layers}"
            base = _plain_run(cfg, dev, routes, snaps=cut)
            ctl = [_drift(_plain_run(cfg, dev, routes, MOE_CONTROL, seed=s),
                          base) for s in MOE_SEEDS]
            _free()
            out[f"{name} unsharded"] = dict(
                losses=base["losses"], aux=base["aux"], step_ms=base["ms"],
                peak_gb=base["peak"] and base["peak"] / 1e9, controls=ctl)
            for shape in MOE_MESHES:
                r = tp_check(cfg, dev, shape, base, routes, ctl)
                if cut:
                    r["one_step"] = one_step_check(cfg, dev, shape, base,
                                                   routes)
                out[f"{name} {list(shape)}"] = r
            del base
            _free()
    finally:
        routes.close()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 15 (tensor-parallel training, the MoE aux term) [{card}]: "
        f"{out['seconds']:.1f}s")
    return out


# phase 18: the serving steps over a (data, model) mesh
# ---------------------------------------------------------------------------
# (arch, layers or None for all, meshes). llama3-8b at full width and
# depth: 32/8 heads, d_ff and the vocab split over "model" on (1, 4) and
# (2, 2), its kv heads too (8 divides 4 and 2), each shard's q heads on
# its own kv heads and cache block; recurrentgemma-9b at full width cut
# to its first group (rglru, rglru, local): one kv head, so the prefill
# cache splits its D columns and the decode cache its sequence over
# "model", attention reading them put together; mamba2-370m: 32 SSD
# heads of 64 split, ``ssd_intra`` on each shard's heads, cut to MOE_CUT
# layers and whole. Its 48 random layers amplify rounding (phases 4 and
# 15): any reordering of its fp32 sums moves the logits and states of the
# whole model far past the parity standard, which its 2 layers meet. So
# the whole model (``SERVE_DRIFT``) is held as phase 15 holds its train
# step: its sharded gap within MOE_DRIFT x the most of MOE_SEEDS
# unsharded controls' from embeddings scaled by 1 + MOE_CONTROL N(0, 1)
TP_SERVE = (("llama3-8b", None, ((1, 4), (2, 2))),
            ("recurrentgemma-9b", 3, ((1, 4),)),
            ("mamba2-370m", MOE_CUT, ((1, 4),)),
            ("mamba2-370m", None, ((1, 4),)))
SERVE_DRIFT = {"mamba2-370m"}
SERVE_ROWS, SERVE_TOKENS, SERVE_DECODE = 4, 512, 8
# the Cache-Craft step's active tokens: 30% of the prompt's positions
SERVE_ACTIVE = 160
# the cache: the prompt and the decode steps, a multiple of 64 and of 4
SERVE_CACHE = 576
# sharded vs unsharded on one route: the parity standard's 2e-4 for
# logits and caches, as allclose (rtol = atol), the CPU tests' form
SHARD_TOL = 2e-4


class SsdRecorder:
    """Wraps the SSD wrapper during a run: counts the calls by the shape
    of ``xdt`` and keeps a copy of the first call's inputs for each. The
    wrapper counts its launches on the module's ``ssd_intra``, so the
    count moves to the stand-in and back."""

    def __init__(self, sops):
        self.sops, self.orig = sops, sops.ssd_intra
        self.shapes = collections.Counter()
        self.calls = {}

    def __enter__(self):
        orig = self.orig

        def rec(xdt, log_a, B_mat, C_mat):
            key = tuple(xdt.shape)
            self.shapes[key] += 1
            if key not in self.calls:
                self.calls[key] = tuple(t.clone() for t in
                                        (xdt, log_a, B_mat, C_mat))
            return orig(xdt, log_a, B_mat, C_mat)
        rec.launches = orig.launches
        rec.launches_by_type = orig.launches_by_type
        self.sops.ssd_intra = rec
        return self

    def __exit__(self, *exc):
        self.orig.launches = self.sops.ssd_intra.launches
        self.sops.ssd_intra = self.orig

    def most_frequent(self):
        return max(self.shapes, key=lambda k: (self.shapes[k], k)) \
            if self.shapes else None


class PlainSsd:
    """Routes the model's SSD calls to the plain version
    (``ssd_intra_ref``, on the card's tensors) while entered: the plain
    routes of phase 20 for a config with SSD layers, whose SSD takes the
    one fp32 instantiation on every route (the model widens its inputs),
    so that those routes share nothing with the kernel under test."""

    def __init__(self, sops):
        self.sops, self.orig = sops, sops.ssd_intra

    def __enter__(self):
        from repro_torch.kernels.ssd.ref import ssd_intra_ref

        def plain(xdt, log_a, B_mat, C_mat):
            lead = xdt.shape[:-4]
            y, st = ssd_intra_ref(*(t.flatten(0, 1) if lead else t
                                    for t in (xdt, log_a, B_mat, C_mat)))
            if lead:
                y, st = (t.unflatten(0, (lead[0], -1)) for t in (y, st))
            return y, st
        self.sops.ssd_intra = plain
        return self

    def __exit__(self, *exc):
        self.sops.ssd_intra = self.orig


def _serve_inputs(cfg, dev, seed=3, tokens=None):
    """The prompt [4, ``tokens`` or SERVE_TOKENS], the Cache-Craft step's
    160 active positions of each row (sorted; at most the prompt's) and
    their tokens, and 8 decode steps' tokens, from a numpy seed."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    B, T = SERVE_ROWS, tokens or SERVE_TOKENS
    A = min(SERVE_ACTIVE, T)

    def t(x):
        return torch.from_numpy(x.astype(np.int32)).to(dev)
    pos = np.sort(np.stack([rng.choice(T, A, replace=False)
                            for _ in range(B)]), 1)
    return ({"tokens": t(rng.integers(0, cfg.vocab_size, (B, T)))},
            {"tokens": t(rng.integers(0, cfg.vocab_size, (B, A))),
             "positions": t(pos)},
            [{"tokens": t(rng.integers(0, cfg.vocab_size, (B,))),
              "positions": torch.full((B,), T + i, dtype=torch.int32,
                                      device=dev)}
             for i in range(SERVE_DECODE)])


def _serve_steps(cfg, params, inp, impl, dev, mesh=None, sparams=None,
                 cache_len=None, with_cc=True):
    """The three serving steps on ``impl``: the prefill of the prompt
    into a cache of ``cache_len`` (SERVE_CACHE) slots at ``cfg.dtype``,
    the Cache-Craft step (``with_cc``) on a copy of
    that cache and the decode steps on another; unsharded, or on ``mesh``
    with ``sparams`` (the params laid out) and each cache laid out by the
    step's layout. Returns {step: (logits, the whole cache)}."""
    import torch

    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import dryrun as DR
    from repro_torch.models import model as M
    from repro_torch.training import steps as TS

    pre, cc, dec = inp
    cache_len = cache_len or SERVE_CACHE

    def run(mode, maker, cache, batches):
        if mesh is None:
            step, p, c = maker(cfg, impl), params, cache
        else:
            shs = DR.serving_shardings(cfg, mode, SERVE_ROWS, cache_len,
                                       mesh)
            step, p = maker(cfg, impl, shardings=shs), sparams
            c = SH.shard_tree(cache, shs[1]["cache"])
            del cache
        lgs = []
        for b in batches:
            lg, c = step(p, dict(b, cache=c))
            lgs.append(lg)
        torch.cuda.synchronize()
        return torch.cat(lgs, 1), (c if mesh is None
                                   else SH.unshard_tree(c))
    out = {"prefill": run("prefill", TS.make_prefill_step, M.init_cache(
        cfg, SERVE_ROWS, cache_len, device=dev), [pre])}
    base = out["prefill"][1]
    if with_cc:
        out["cc"] = run("partial", TS.make_cachecraft_prefill_step,
                        _clone_cache(base), [cc])
    out["decode"] = run("decode", TS.make_decode_step, _clone_cache(base),
                        dec)
    return out


def _serve_gap(got, want, tol):
    """The worst ratio of the steps' logits and cache leaves to the
    allclose bound ``tol`` (1 + 1 |want|), and the largest abs difference;
    positions must be equal."""
    import torch
    ratio = diff = 0.0
    for what, (lg, cache) in want.items():
        pairs = [(got[what][0], lg)]
        for part in ("groups", "tail"):
            for g, w in zip(got[what][1][part], cache[part]):
                for n, x in w.items():
                    if x.is_floating_point():
                        pairs.append((g[n], x))
                    elif not torch.equal(g[n], x):
                        raise RuntimeError(f"{what} {part} {n}: the cache "
                                           "positions differ")
        for a, b in pairs:
            d = (a.float() - b.float()).abs()
            diff = max(diff, float(d.max()))
            ratio = max(ratio, float((d / (tol + tol * b.float().abs()))
                                     .max()))
    return ratio, diff


def measure_ssd_call(label, args, unsharded):
    """ssd_intra on ``args`` (the recorded inputs of a per-shard call) in
    fp32: held against its plain version to the reference's allclose
    bound, two launches byte for byte, kernel / plain times, the bound
    (``_ssd_bound``) and the kernel's time on ``unsharded`` (the
    unsharded call of the same step and layer)."""
    import torch

    from repro_torch.kernels.ssd import ops as sops
    from repro_torch.kernels.ssd.ref import ssd_intra_ref

    # a batched call's rows folded into its chunks, as the wrapper folds
    args, unsharded = ([t.flatten(0, 1) if t.dim() == n + 1 else t
                        for t, n in zip(a, (4, 3, 3, 3))]
                       for a in (args, unsharded))
    y, st = sops.ssd_intra(*args)
    y2, st2 = sops.ssd_intra(*args)
    torch.cuda.synchronize()
    if not (torch.equal(y, y2) and torch.equal(st, st2)):
        raise RuntimeError(f"ssd_intra {label}: two launches differ")
    yr, sr = ssd_intra_ref(*args)
    tol = TOL["float32"]
    e = max(float((a - b).abs().max()) for a, b in ((y, yr), (st, sr)))
    ratio = max(float(((a - b).abs() / (tol + tol * b.abs())).max())
                for a, b in ((y, yr), (st, sr)))
    if not ratio <= 1.0:
        raise RuntimeError(f"ssd_intra {label}: {ratio:.3f}x the allclose "
                           f"bound (rtol = atol = {tol})")
    nC, L, H, P = args[0].shape
    N = args[2].shape[-1]
    t_k = cuda_ms(lambda: sops.ssd_intra(*args))
    t_u = cuda_ms(lambda: sops.ssd_intra(*unsharded))
    t_p = cuda_ms(lambda: ssd_intra_ref(*args), iters=5)
    nbytes = (nC * L * H * P + nC * L * H + 2 * nC * L * N) * 4 + \
        4 * (nC * L * H * P + nC * H * P * N)
    b_ms, b_by, b_cores, _ = _ssd_bound(nC, L, H, P, N, nbytes, "float32")
    log(f"kernel ssd_intra {label} nC={nC} L={L} H={H} P={P} N={N}: "
        f"max_abs_err={e:.3e} ({ratio:.4f}x the allclose bound) two "
        f"launches identical ms={t_k:.4f} unsharded_ms={t_u:.4f} "
        f"(H {unsharded[0].shape[-2]}) plain_ms={t_p:.4f} library_ms=none "
        f"bound_ms={b_ms:.4f} ({b_by}; CUDA cores {b_cores:.4f}) "
        f"share={b_ms / t_k:.1%}")
    return {"float32": dict(err=e, worst_ratio=ratio, ms=t_k, unsharded_ms=t_u,
                            plain_ms=t_p, library_ms=None, bound_ms=b_ms,
                            bound_by=b_by, bound_ms_cuda_cores=b_cores)}


def run_tp_serving(dev, card):
    """Phase 18: the prefill, Cache-Craft and decode steps (``shardings=``)
    over (data, model) meshes (``TP_SERVE``), fp32 with TF32 off, 4 rows:
    a 512-token prefill, the Cache-Craft step of 160 active positions
    against its cache, 8 decode steps after it. Unsharded and sharded on
    ``kernel`` and on ``dense``: sharded within SHARD_TOL of unsharded on
    the same route (whole mamba2 within MOE_DRIFT x its controls' drift,
    ``SERVE_DRIFT``), ``kernel`` within LOGIT_TOL of ``dense``; the chunk,
    decode and SSD launches counted from 0 around each sharded kernel
    run, exactly once per model shard, data shard and layer; each kernel
    held and timed on the recorded inputs of llama3-8b's (mamba2's for
    SSD) most frequent per-shard call on (1, 4), beside the unsharded
    call of the same shape and SDPA on the shard's slice."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as SH
    from repro_torch.kernels.chunk_attention import ops as cops
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.ssd import ops as sops
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch.mesh import make_debug_mesh

    t_phase = time.perf_counter()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    out, launches, rec = {}, collections.Counter(), {}
    try:
        with torch.no_grad():
            for arch, layers, meshes in TP_SERVE:
                t_case = time.perf_counter()
                cfg = get_config(arch)
                cfg = cfg.replace(num_layers=layers or cfg.num_layers)
                name = f"{cfg.name}/{cfg.num_layers}"
                params = _params(cfg, dev)
                inp = _serve_inputs(cfg, dev)
                n_attn = sum(k in ("attn", "local") for k in cfg.layer_kinds)
                n_ssd = cfg.layer_kinds.count("ssd")
                with ChunkRecorder(cops) as ucc, DecodeRecorder(dops) as udc, \
                        SsdRecorder(sops) as usc:
                    plain = {impl: _serve_steps(cfg, params, inp, impl, dev)
                             for impl in ("kernel", "dense")}
                kd = _serve_gap(plain["kernel"], plain["dense"], LOGIT_TOL)
                log(f"{name} unsharded: kernel vs dense max abs diff "
                    f"{kd[1]:.3e} ({kd[0]:.3f}x the bound, rtol = atol = "
                    f"{LOGIT_TOL})")
                if not kd[0] <= 1.0:
                    raise RuntimeError(f"{name} unsharded: kernel vs dense "
                                       f"{kd[0]:.3f}x the bound")
                r = {"kernel_vs_dense": kd}
                # the drift of unsharded runs from perturbed embeddings
                bound = 1.0
                if arch in SERVE_DRIFT and layers is None:
                    ctl = []
                    for seed in MOE_SEEDS:
                        gen = torch.Generator(device=dev)
                        gen.manual_seed(seed)
                        emb = params["embed"]
                        noisy = dict(params, embed=emb * (1 + MOE_CONTROL *
                                     torch.randn(emb.shape, generator=gen,
                                                 device=dev)))
                        ctl.append(_serve_gap(_serve_steps(
                            cfg, noisy, inp, "dense", dev), plain["dense"],
                            SHARD_TOL))
                        del noisy
                    bound = max(1.0, MOE_DRIFT * max(c[0] for c in ctl))
                    r["controls"] = ctl
                    log(f"{name} unsharded from perturbed embeddings "
                        f"(controls): " + ", ".join(
                            f"{c[1]:.3e} ({c[0]:.1f}x)" for c in ctl)
                        + f"; the sharded runs are held within {bound:.1f}x"
                        " the allclose bound")
                for shape in meshes:
                    mesh = make_debug_mesh(shape, device=dev)
                    psh = DR.serving_shardings(cfg, "prefill", SERVE_ROWS,
                                               SERVE_CACHE, mesh)[0]
                    sparams = SH.shard_tree(params, psh)
                    dp, nm = shape
                    res, dense = {}, None
                    for impl in ("dense", "kernel"):
                        cops.chunk_attention.launches = 0
                        dops.decode_attention.launches = 0
                        sops.ssd_intra.launches = 0
                        with ChunkRecorder(cops) as cc, \
                                DecodeRecorder(dops) as dc, \
                                SsdRecorder(sops) as sc:
                            t0 = time.perf_counter()
                            got = _serve_steps(cfg, params, inp, impl, dev,
                                               mesh, sparams)
                            secs = time.perf_counter() - t0
                        n = {"chunk_attention": cops.chunk_attention.launches,
                             "decode_attention":
                                 dops.decode_attention.launches,
                             "ssd_intra": sops.ssd_intra.launches}
                        # attention reaches its kernels on ``kernel``, the
                        # SSD block outside training on every route
                        on = impl == "kernel"
                        want = {"chunk_attention": 2 * n_attn * nm * dp * on,
                                "decode_attention":
                                    SERVE_DECODE * n_attn * nm * dp * on,
                                "ssd_intra": 2 * n_ssd * nm * dp}
                        _expect_launches(f"{name} {list(shape)} {impl}", n,
                                         want)
                        launches.update(n)
                        gap = _serve_gap(got, plain[impl], SHARD_TOL)
                        res[impl] = dict(ratio=gap[0], max_abs=gap[1],
                                         seconds=secs, launches=n)
                        log(f"{name} {list(shape)} {impl}: sharded vs "
                            f"unsharded logits and caches max abs diff "
                            f"{gap[1]:.3e}, {gap[0]:.3f}x the allclose "
                            f"bound (rtol = atol = {SHARD_TOL}); steps "
                            f"{secs:.2f}s")
                        if not gap[0] <= bound:
                            raise RuntimeError(
                                f"{name} {list(shape)} {impl}: sharded vs "
                                f"unsharded {gap[0]:.3f}x the bound (held "
                                f"within {bound:.3f}x)")
                        if impl == "dense":
                            dense = got
                            continue
                        kd = _serve_gap(got, dense, LOGIT_TOL)
                        del got, dense
                        log(f"{name} {list(shape)}: kernel vs dense max abs "
                            f"diff {kd[1]:.3e} ({kd[0]:.3f}x the bound, "
                            f"rtol = atol = {LOGIT_TOL})")
                        if not kd[0] <= 1.0:
                            raise RuntimeError(f"{name} {list(shape)}: kernel "
                                               f"vs dense {kd[0]:.3f}x the "
                                               "bound")
                        res["kernel_vs_dense"] = kd
                        if (arch, shape) == (TP_SERVE[0][0],
                                             TP_SERVE[0][2][0]) or n_ssd:
                            rec[arch] = (cc, dc, sc, ucc, udc, usc, shape)
                    r[str(list(shape))] = res
                    del sparams
                    _free()
                del params, plain
                _free()
                r["seconds"] = time.perf_counter() - t_case
                out[name] = r
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    # each kernel on the recorded inputs of its most frequent per-shard
    # call, beside the unsharded call of the same shape
    cc, dc, _, ucc, udc, _, shape = rec[TP_SERVE[0][0]]
    ck = max(cc.shapes, key=lambda k: (cc.shapes[k], k))
    dk = dc.most_frequent("dense")
    ci, di = cc.calls[ck], dc.calls[dk]
    uci, udi = ucc.calls[ck], udc.calls[dk]
    rows = {}
    for kname, fn, rec_in, un_in, key in (
            ("chunk_attention", measure_chunk, ci, uci, ck),
            ("decode_attention", measure_decode, di, udi, dk[1:])):
        r = fn(f"per model shard {list(shape)} path{list(key)}", rec_in)
        if kname == "chunk_attention":
            args = (un_in["q"], un_in["k"], un_in["v"], un_in["q_pos"],
                    un_in["k_pos"], un_in["k_chunk"])
            kw = dict(q_seg=un_in["q_seg"], k_seg=un_in["k_seg"],
                      num_chunks=un_in["C"], window=un_in["window"])
            r["float32"]["unsharded_ms"] = cuda_ms(
                lambda: cops.chunk_attention(*args, **kw))
            H, Hu = rec_in["q"].shape[2], un_in["q"].shape[2]
        else:
            args = (un_in["q"], un_in["k"], un_in["v"], un_in["q_pos"],
                    un_in["k_pos"])
            r["float32"]["unsharded_ms"] = cuda_ms(
                lambda: dops.decode_attention(*args,
                                              window=un_in["window"]))
            H, Hu = rec_in["q"].shape[1], un_in["q"].shape[1]
        log(f"kernel {kname} per model shard: {r['float32']['ms']:.4f} ms "
            f"(H {H}) against the unsharded call's "
            f"{r['float32']['unsharded_ms']:.4f} ms (H {Hu})")
        r["shape"] = (f"{TP_SERVE[0][0]} on {list(shape)}, {kname} call "
                      f"{list(key)}, H {H} of {Hu}")
        r["calls"] = (cc if kname == "chunk_attention" else dc).shapes[
            ck if kname == "chunk_attention" else dk]
        rows[kname] = r
    _, _, sc, _, _, usc, shape = rec[TP_SERVE[-1][0]]
    sk = sc.most_frequent()
    uk = next(k for k in usc.calls if k[:-2] == sk[:-2])
    rows["ssd_intra"] = measure_ssd_call(
        f"per model shard {list(shape)} xdt{list(sk)}", sc.calls[sk],
        usc.calls[uk])
    rows["ssd_intra"]["shape"] = (f"{TP_SERVE[-1][0]} on {list(shape)}, "
                                  f"xdt {list(sk)} of {list(uk)}")
    rows["ssd_intra"]["calls"] = sc.shapes[sk]
    out["kernels"] = rows
    out["launches"] = dict(launches)
    for k, v in launches.items():
        if v <= 0:
            raise RuntimeError(f"phase 18: {k} never launched per shard")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 18 (the serving steps over a (data, model) mesh) [{card}]: "
        f"launches {json.dumps(out['launches'])}, {out['seconds']:.1f}s")
    return out


# ---------------------------------------------------------------------------
# phase 19: bf16 serving through the engine's kernel route
# ---------------------------------------------------------------------------
def _leaves(params):
    return [params["embed"], params["unembed"], params["final_norm"]] + \
        [x for g in params["groups"] + params["tail"] for x in g.values()]


def bf16_copy(params):
    """Rounds fp32 ``params`` to bf16 values in place and returns a bf16
    copy of them: the same weights in both dtypes."""
    import torch
    with torch.no_grad():
        for x in _leaves(params):
            x.copy_(x.to(torch.bfloat16))
        p16 = {k: params[k].to(torch.bfloat16)
               for k in ("embed", "unembed", "final_norm")}
        for part in ("groups", "tail"):
            p16[part] = [{n: x.to(torch.bfloat16) for n, x in g.items()}
                         for g in params[part]]
    torch.cuda.synchronize()
    return p16


# A16 against A32: their decode logits within BF16_FORWARD_FACTOR times the
# bf16-vs-fp32 gap of the plain train-mode forward (dense attention, no
# kernel and no cache) on the same weights, read in the same run over
# FORWARD_TOKENS of random prompts. The engine rounds in more stages than
# that forward (stored chunks computed in bf16, partial recompute, decode
# over the generated tokens), and fewer per stage (its K/V stay fp32, its
# kernels work in fp32). On tiny llama3-8b on the CPU the engine's gap is
# 0.64x the forward's for the reference and 0.80x for the port on the
# same weights and trace (tests/test_torch_bf16_serving.py), 1.69x in
# this phase's rehearsal (its workload, its seed-0 weights); 4x leaves
# 2.4x above the highest. One layer's bf16 decode output zeroed (a planted
# fault of the bf16 path alone) read 50x there, and this bound refuses it
BF16_FORWARD_FACTOR = 4.0
FORWARD_TOKENS = (2, 256)            # (prompts, tokens each)


def forward_gap(cfg, params, cfg16, params16, dev, seed=4):
    """The plain train-mode forward on ``dense`` in bf16 (``cfg16``,
    ``params16``) against fp32 (``cfg``, ``params``) on FORWARD_TOKENS of
    random tokens: (max |logit gap|, the fp32 logits' max |value|)."""
    import numpy as np
    import torch

    from repro_torch.models import model as M
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, FORWARD_TOKENS).astype(np.int32)).to(dev)
    with torch.no_grad():
        lo32 = M.forward(cfg, params, tokens=toks, attn_impl="dense").logits
        lo16 = M.forward(cfg16, params16, tokens=toks,
                         attn_impl="dense").logits
        gap = float((lo16.float() - lo32.float()).abs().max())
        scale = float(lo32.float().abs().max())
    return gap, scale


def _bf16_gap(trace16, tok16, trace32, tok32, rids, tag="phase 19"):
    """A16 against A32 on the requests ``rids`` (those whose plans agree:
    another plan recomputes other tokens, which is not rounding), request
    by request over the decode steps whose inputs agree (tokens equal so
    far): the largest logit gap over them
    all (``gap``), the largest over the steps where the greedy tokens stay
    equal (``kept``), each step where they part (rid, step, A32's top-two
    gap there), the steps compared and A32's largest |logit| over them."""
    import numpy as np

    mine, ref = _per_rid(trace16), _per_rid(trace32)
    if set(mine) != set(ref):
        raise RuntimeError(f"{tag}: the bf16 and fp32 runs decoded other "
                           "requests")
    gap = kept = scale = 0.0
    parts, steps = [], 0
    for rid in sorted(set(ref) & set(rids)):
        for i, (a, b) in enumerate(zip(mine[rid], ref[rid])):
            if tok16[rid][:i + 1] != tok32[rid][:i + 1]:
                break
            if not (a.shape == b.shape and np.isfinite(a).all()):
                raise RuntimeError(f"{tag}: rid {rid} step {i}: bad logits")
            d = float(np.abs(a - b).max())
            gap = max(gap, d)
            scale = max(scale, float(np.abs(b).max()))
            steps += 1
            if int(a.argmax()) != int(b.argmax()):
                top2 = np.sort(b)[-2:]
                parts.append((rid, i, float(top2[1] - top2[0])))
                break
            kept = max(kept, d)
    return dict(gap=gap, kept=kept, parts=parts, steps=steps, scale=scale)


def run_bf16(cfg, params, tmp):
    """Phase 19: full-width llama3-8b served in bf16 on ``kernel`` (bf16
    weights and activations over the engine's fp32 caches, the mixed
    chunk and decode instantiations), engine A16, beside engine A32, the
    same route in fp32 on the same bf16-rounded weights, so that their gap
    measures the bf16 activations alone. ``params`` (fp32) is rounded to
    bf16 values in place, then copied to bf16 (16 GB beside its 32). The
    smoke workload, TF32 off. A16's launches counted from 0: every chunk
    and decode launch the mixed one, as many as its plans imply (a chunk
    launch per layer and prefill pass, a decode launch per layer and
    step); each mixed kernel held and timed on the recorded inputs of
    A16's most frequent call shape."""
    import torch

    from repro_torch.kernels.chunk_attention import ops as cops
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.rope import ops as rops

    t_phase = time.perf_counter()
    dev = params["embed"].device
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    p16 = bf16_copy(params)
    cfg16 = cfg.replace(dtype="bfloat16", param_dtype="bfloat16")
    w_gb = sum(x.numel() * x.element_size() for x in _leaves(params)
               + _leaves(p16)) / 1e9
    log(f"phase 19: llama3-8b weights rounded to bf16 in place, bf16 copy "
        f"made: {w_gb:.2f} GB of weights on the card")
    # first-use costs of the bf16 products and the mixed kernels land in
    # an untimed warm-up, not in A16
    run_engine("warmup16", cfg16, p16, tmp, attn_impl="kernel",
               num_requests=4, max_new_tokens=2)
    counts = {}
    for f in (cops.chunk_attention, dops.decode_attention):
        f.launches = 0
        f.launches_by_type.clear()
    rops.rope.launches = 0
    with ChunkRecorder(cops) as cc, DecodeRecorder(dops) as dc:
        a16, tr16, tok16, plan16, _c16 = run_engine(
            "A16", cfg16, p16, tmp, attn_impl="kernel")
    for name, f in (("chunk_attention", cops.chunk_attention),
                    ("decode_attention", dops.decode_attention)):
        counts[name] = dict(f.launches_by_type)
    counts["rope"] = rops.rope.launches
    a32, tr32, tok32, plan32, _c32 = run_engine("A32", cfg, params, tmp,
                                                attn_impl="kernel")
    L = cfg.num_layers
    want = {"chunk_attention": a16["prefill_batches"] * L,
            "decode_attention": a16["decode_steps"] * L}
    log(f"phase 19: A16 launches by instantiation {json.dumps(counts)}; "
        f"its plans imply {json.dumps(want)} (A32's "
        f"{a32['prefill_batches'] * L} / {a32['decode_steps'] * L})")
    for name, n in want.items():
        if counts[name] != {MIXED: n}:
            raise RuntimeError(f"phase 19: A16's {name} launches "
                               f"{counts[name]}, want {{{MIXED!r}: {n}}}")
    plan_diff = sum(plan16[r] != plan32[r] for r in plan32)
    g = _bf16_gap(tr16, tok16, tr32, tok32,
                  [r for r in plan32 if plan16[r] == plan32[r]])
    fwd, fwd_scale = forward_gap(cfg, params, cfg16, p16, dev)
    limit = BF16_FORWARD_FACTOR * fwd
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    same = sum(tok16[r] == tok32[r] for r in tok32)
    log(f"phase 19: A16 vs A32 decode logits {g['gap']:.3e} over "
        f"{g['steps']} request-steps of the requests whose plans agree "
        f"(A32's logits up to {g['scale']:.3f}), "
        f"{g['kept']:.3e} over the steps whose tokens stay equal; the plain "
        f"forward's bf16 vs fp32 gap {fwd:.3e} (logits up to "
        f"{fwd_scale:.3f}), limit {BF16_FORWARD_FACTOR:g}x = {limit:.3e}; "
        f"greedy tokens part at {len(g['parts'])} step(s) (rid, step, "
        f"A32's top-two gap) {g['parts']}; identical token streams "
        f"{same}/{len(tok32)}; plans differ for {plan_diff}/{len(plan32)} "
        f"requests; peak memory {peak:.2f} GB")
    if g["steps"] == 0 or not g["gap"] <= limit:
        raise RuntimeError(f"phase 19: A16 vs A32 decode logit gap "
                           f"{g['gap']} beyond {BF16_FORWARD_FACTOR:g}x the "
                           f"plain forward's bf16 gap {fwd}")
    # a parting's tolerance is read off the other steps: the greedy tokens
    # may part only where A32's top-two gap is within the gap of the steps
    # whose tokens stayed equal
    beyond = [p for p in g["parts"] if not p[2] <= g["kept"]]
    if beyond:
        raise RuntimeError(f"phase 19: greedy tokens part where A32's "
                           f"top-two gap exceeds the A16-A32 logit gap "
                           f"{g['kept']} of the steps that agree: {beyond}")
    ck = max(cc.shapes, key=lambda k: (cc.shapes[k], k))
    dk = dc.most_frequent("dense")
    rows = {"chunk_attention": dict(
                calls=cc.shapes[ck], **measure_chunk(
                    f"A16 path{list(ck)}", cc.calls[ck], MIXED_TYPES)[MIXED]),
            "decode_attention": dict(
                calls=dc.shapes[dk], **measure_decode(
                    f"A16 path{list(dk[1:])}", dc.calls[dk],
                    MIXED_TYPES)[MIXED])}
    del cc, dc
    _free()
    out = dict(A16=a16, A32=a32, launches=counts, want=want,
               logit_gap=g["gap"], logit_gap_kept=g["kept"],
               logit_scale=g["scale"], forward_gap=fwd,
               forward_scale=fwd_scale, logit_limit=limit,
               greedy_parts=g["parts"], compared_steps=g["steps"],
               identical_streams=same, plan_diff=plan_diff, tokens16=tok16,
               weights_gb=w_gb, peak_gb=peak, kernels=rows,
               seconds=time.perf_counter() - t_phase)
    log(f"phase 19 (bf16 serving on kernel): {out['seconds']:.1f}s")
    # the bf16 copy, for phase 20 (popped there)
    out["params16"] = p16
    return out


# ---------------------------------------------------------------------------
# phase 21: the bf16 engine surface (after phase 19, on its weights)
# ---------------------------------------------------------------------------
# the bf16 serving tests' factor (tests/test_torch_bf16_serving.py,
# BF16_GAP_FACTOR): two runs' choices differ only at a near tie when the
# tokens that differ sit within twice the two runs' own score gap of the
# boundary
BF16_GAP_FACTOR = 2.0


class Bf16Launches:
    """The chunk and decode launches by instantiation, the paged decode
    launches and the RoPE launches with the dtypes they rotate, of the
    runs made under ``counted()``: each counted from 0 and summed. Beside
    them ``want``, what the runs' plans imply, added by the caller."""

    def __init__(self):
        self.got = dict(chunk_attention=collections.Counter(),
                        decode_attention=collections.Counter(),
                        paged_decode_attention=0, rope=0,
                        rope_dtypes=collections.Counter())
        self.want = dict(chunk_attention=0, decode_attention=0)

    @contextlib.contextmanager
    def counted(self):
        from repro_torch.kernels.chunk_attention import ops as cops
        from repro_torch.kernels.decode_attention import ops as dops
        from repro_torch.kernels.rope import ops as rops

        fs = dict(chunk_attention=cops.chunk_attention,
                  decode_attention=dops.decode_attention)
        for f in fs.values():
            f.launches = 0
            f.launches_by_type.clear()
        dops.paged_decode_attention.launches = 0
        rops.rope.launches = 0
        with RopeRecorder(rops) as rc:
            yield
        for name, f in fs.items():
            self.got[name].update(f.launches_by_type)
        self.got["paged_decode_attention"] += \
            dops.paged_decode_attention.launches
        self.got["rope"] += rops.rope.launches
        self.got["rope_dtypes"].update(rc.dtypes)

    def engine(self, eng, fn):
        """``fn()`` counted, with the launches ``eng``'s plans imply: a
        chunk launch per layer and prefill pass, a decode launch per layer
        and decode step."""
        L = eng.cfg.num_layers
        b0, d0 = eng.stats.prefill_batches, eng.stats.decode_steps
        with self.counted():
            out = fn()
        self.want["chunk_attention"] += (eng.stats.prefill_batches - b0) * L
        self.want["decode_attention"] += (eng.stats.decode_steps - d0) * L
        return out

    def check(self, tag):
        got = {k: dict(v) if isinstance(v, collections.Counter) else v
               for k, v in self.got.items()}
        log(f"{tag}: launches {json.dumps(got)}; the plans imply "
            f"{json.dumps(self.want)}")
        for name, n in self.want.items():
            if n <= 0 or got[name] != {MIXED: n}:
                raise RuntimeError(f"{tag}: {name} launches {got[name]}, "
                                   f"want {{{MIXED!r}: {n}}}")
        if got["paged_decode_attention"] or got["rope"] <= 0 or \
                set(got["rope_dtypes"]) != {"float32"}:
            raise RuntimeError(f"{tag}: paged launches "
                               f"{got['paged_decode_attention']}, rope "
                               f"{got['rope']} over {got['rope_dtypes']}")
        return got


def _bf16_strategies(cfg, params, cfg16, p16, tmp, limit, counts, device):
    """Phase 21's executor half: phase 17's cases on ``kernel`` in bf16
    over one store warmed on ``kernel`` in bf16 by the smoke workload's 12
    prompts and then only read, each beside the same case in fp32 on the
    same rounded weights replaying the bf16 run's choices. Plans equal
    (the fp32 run's own choices differ from the bf16 run's only at near
    ties, counted), the last logits within ``limit``; the identities of
    phase 17 in bf16 and streamed == eager; ``blend``'s probe calls kept
    for the probe row."""
    import numpy as np
    import torch

    from repro_torch.core.chunkstore import ChunkStore
    from repro_torch.core.prefill import CacheCraftExecutor
    from repro_torch.core.tiers import TieredStore
    from repro_torch.kernels.chunk_attention import ops as cops
    from repro_torch.serving.metrics import relative_deviation

    warm, evals = _strategy_prompts(cfg)
    store = ChunkStore(TieredStore(1 << 33, 1 << 33,
                                   os.path.join(tmp, "bf16-strategies")),
                       n_chunks=64, m_variants=3)
    L, P = cfg.num_layers, len(cfg.pattern)
    res = {"runs": {}}

    def executor(c, p, **kw):
        return CacheCraftExecutor(
            c, p, store, attn_impl="kernel", use_focus=False,
            rng=np.random.default_rng(STRATEGY_SEED), device=device, **kw)

    def run(c, p, replay=None, **kw):
        ex = executor(c, p, store_new_chunks=False,
                      store_fixed_variants=False, **kw)
        sel = record_selections(ex)
        ex.strategy_obj.replay = None if replay is None else list(replay)
        with ChunkRecorder(cops) as cc:
            t0 = time.perf_counter()
            out = ex.process_batch(evals)
            if device != "cpu":
                torch.cuda.synchronize()
            sec = time.perf_counter() - t0
        # blend's probe: one window of P layers for each prompt with a hit
        probes = sum(ex.strategy_obj.needs_deviation
                     and any(d.is_hit for d in r.plan.decisions)
                     for r in out)
        return dict(results=out, selections=sel, order=list(cc.order),
                    calls=cc.calls, seconds=sec, probes=probes)

    def bf16_run(**kw):
        with counts.counted():
            r = run(cfg16, p16, **kw)
        counts.want["chunk_attention"] += L + P * r["probes"]
        return r

    def plan(r):
        return [[(bool(d.is_hit), float(d.cfo),
                  np.asarray(d.recompute_idx).tolist())
                 for d in x.plan.decisions]
                + [x.plan.num_active_tokens, x.plan.total_len,
                   x.active_rows_layers] for x in r["results"]]

    def gap(a, b, what="logits_last"):
        return max(float(np.abs(np.asarray(getattr(x, what), np.float32)
                                - np.asarray(getattr(y, what), np.float32))
                         .max())
                   for x, y in zip(a["results"], b["results"]))

    def same(a, b):
        return all(np.array_equal(getattr(x, w), getattr(y, w))
                   for x, y in zip(a["results"], b["results"])
                   for w in ("logits_last", "k_layers", "v_layers"))

    try:
        t0 = time.perf_counter()
        warm_ex = executor(cfg16, p16)
        with counts.counted():
            for prompt in warm:
                warm_ex.process_batch([prompt])
        counts.want["chunk_attention"] += len(warm) * L
        res["warm"] = dict(seconds=time.perf_counter() - t0,
                           variants=store.num_variants())
        runs = {}
        for name, kw in strategy_cases():
            r16 = runs[name] = bf16_run(**kw)
            r32 = run(cfg, params, replay=r16["selections"], **kw)
            if plan(r16) != plan(r32):
                raise RuntimeError(f"phase 21 {name}: the fp32 run on the "
                                   "bf16 run's choices plans differently")
            key = ranked_by(kw.get("strategy", "cachecraft"))
            floor = BF16_GAP_FACTOR * score_gap(r32["selections"],
                                                r16["selections"], key)
            ties = selection_ties(f"phase 21 {name}", r32["selections"],
                                  r16["selections"], key, floor)
            lg = gap(r16, r32)
            row = dict(bf16_vs_fp32=lg, ratio=lg / limit,
                       bf16_vs_fp32_kv=max(gap(r16, r32, "k_layers"),
                                           gap(r16, r32, "v_layers")),
                       near_tie_calls=ties[0], near_tie_tokens=ties[1],
                       score_floor=floor, seconds=r16["seconds"],
                       seconds_fp32=r32["seconds"],
                       computed_tokens=sum(x.plan.num_active_tokens
                                           for x in r16["results"]),
                       total_tokens=sum(x.plan.total_len
                                        for x in r16["results"]))
            if not (lg <= limit and all(np.isfinite(np.asarray(
                    x.logits_last, np.float32)).all()
                    for x in r16["results"])):
                raise RuntimeError(f"phase 21 {name}: bf16 vs fp32 logits "
                                   f"{lg} beyond {limit}")
            res["runs"][name] = row
            del r32
        runs["streamed"] = bf16_run(force_recompute_fraction=STRATEGY_FRAC,
                                    layerwise_load=True)

        # phase 17's identities, in bf16
        idn = {}
        for got, want in (("blend 1.0", "all"), ("blend 0.0", "none")):
            a, b = runs[got], runs[want]
            main = a["order"][len(evals):] if a["probes"] else a["order"]
            shapes_same = collections.Counter(main) == \
                collections.Counter(b["order"])
            eq = same(a, b)
            g = max(gap(a, b), gap(a, b, "k_layers"), gap(a, b, "v_layers"))
            idn[f"{got} == {want}"] = dict(bit_equal=eq, max_abs=g,
                                           shapes_same=shapes_same)
            if not eq and (shapes_same or g > limit):
                raise RuntimeError(f"phase 21: {got} vs {want}: max abs {g}")
        fg = gap(runs["forced 1.0"], runs["all"])
        idn["forced 1.0 vs all"] = fg
        if fg > FORCED_TOL:
            raise RuntimeError(f"phase 21: forced full recompute {fg} from "
                               f"all (tol {FORCED_TOL})")
        dv = {n: float(np.mean([relative_deviation(
            np.asarray(x.logits_last, np.float32),
            np.asarray(y.logits_last, np.float32))
            for x, y in zip(runs[n]["results"], runs["all"]["results"])]))
            for n in ("frac 0.0", "cachecraft", "frac 0.7", "none",
                      "no_rpe", "no_causal")}
        idn["deviation"] = dv
        if not (dv["frac 0.7"] < dv["frac 0.0"]
                and dv["no_rpe"] > dv["none"]):
            raise RuntimeError(f"phase 21: deviations from all {dv}")
        s, e = runs["streamed"], runs["cachecraft"]
        hits = sum(d.is_hit for r in s["results"] for d in r.plan.decisions)
        layers = sum(r.load_blocked_layers + r.load_hidden_layers
                     for r in s["results"])
        if not (all(r.streamed for r in s["results"])
                and layers == cfg.num_layers * hits and same(s, e)):
            raise RuntimeError(f"phase 21: streamed vs eager: {layers} layer "
                               f"loads for {hits} hits, bit-equal "
                               f"{same(s, e)}")
        idn["streamed == eager"] = dict(bit_equal=True, layer_loads=layers,
                                        hits=hits)
        res["identities"] = idn
        log("phase 21 strategies: bf16 vs fp32 on the bf16 choices "
            f"(limit {limit:.3e}): " + ", ".join(
                f"{n} {r['bf16_vs_fp32']:.3e} ({r['ratio']:.2f}, ties "
                f"{r['near_tie_calls']}/{r['near_tie_tokens']})"
                for n, r in res["runs"].items())
            + "; identities " + json.dumps(idn))
        # blend's probe (every row active, A = S), the mixed instantiation
        b = runs["blend"]
        keys = [k for k in b["order"][:len(evals)] if k[1] == k[2]]
        if len(keys) != b["probes"] or not keys:
            raise RuntimeError(f"phase 21: blend's probe calls "
                               f"{b['order'][:len(evals)]}")
        pk = max(set(keys), key=lambda k: (keys.count(k), k))
        res["probe"] = dict(
            shape=f"(B, A, S) {list(pk)}", calls=keys.count(pk),
            probe_calls=len(keys),
            **measure_chunk(f"bf16 probe{list(pk)}", b["calls"][pk],
                            MIXED_TYPES + (("float32", "float32"),)))
        del runs, b
    finally:
        store.tiers.close()
    return res


def _prefill_groups(eng):
    """Log the rids of every packed prefill pass of ``eng``."""
    groups, orig = [], eng._run_prefills

    def run_prefills(reqs):
        groups.append([r.rid for r in reqs])
        return orig(reqs)
    eng._run_prefills = run_prefills
    return groups


def _bf16_pressure(cfg, params, cfg16, p16, tmp, limit, counts):
    """Phase 21's pressure half, on ``kernel``: phase 16's churn workload
    in fp32 at pool 512 (the yardstick) and in bf16 at pool 512 and pool
    20. bf16 against fp32 by phase 19's rule; pressured against
    unpressured: preemptions, every request done, the pool settled, the
    decode logits within ``limit`` while the tokens agree and the tokens
    equal up to a step whose unpressured top-two gap is within ``limit``
    (ROADMAP C3: a preempted request is re-prefilled beside another
    partner). A request that parts is run again without pressure, packed
    with its pressured partners (logged: the control reproduces the
    pressured run or not). Then zero-copy against copy and incremental
    against rebuild, byte for byte."""
    import numpy as np

    res = {}

    def churn(c, p, pool, after, count=True, keep=None):
        eng = churn_engine(c, p, pool, after, attn_impl="kernel")
        groups = _prefill_groups(eng)
        reqs = _churn_requests(cfg, (18, 18, 3, 5, 4, 6), 17)
        if keep is not None:
            reqs = [r for r in reqs if r.rid in keep]
            for r in reqs:
                r.arrival_time = 0.0
        tag = f"bf16 pool {pool}" if c is cfg16 else f"fp32 pool {pool}"
        run = (lambda: pressure_run(tag, eng, reqs))
        out = counts.engine(eng, run) if count else run()
        return out + (groups,)

    f32 = churn(cfg, params, 512, 0, count=False)
    unp = churn(cfg16, p16, 512, 0)
    prs = churn(cfg16, p16, 20, 4)
    if not (prs[0]["preemptions"] > 0 and prs[0]["burn_requeues"] == 0
            and unp[0]["preemptions"] == 0):
        raise RuntimeError(f"phase 21 pressure: preemptions "
                           f"{prs[0]['preemptions']}, burn requeues "
                           f"{prs[0]['burn_requeues']}")
    g = _bf16_gap(unp[1], unp[2], f32[1], f32[2], list(f32[2]),
                  tag="phase 21 pressure")
    beyond = [pt for pt in g["parts"] if not pt[2] <= g["kept"]]
    if g["steps"] == 0 or not g["gap"] <= limit or beyond:
        raise RuntimeError(f"phase 21 pressure: bf16 vs fp32 decode logits "
                           f"{g['gap']} (limit {limit}), partings beyond "
                           f"{g['kept']}: {beyond}")
    lg, lsame, cut = attempt_gap("phase 21 pressure", prs[1], prs[2], unp[1],
                                 unp[2], limit)
    # the final KV of the requests that did not part (logged)
    kg, ksame = kv_gap("phase 21 pressure",
                       {r: x for r, x in prs[3].items() if r not in cut},
                       {r: x for r, x in unp[3].items() if r not in cut})
    if lg > limit:
        raise RuntimeError(f"phase 21 pressure: pool 20 vs 512 logits {lg} "
                           f"(limit {limit})")
    controls = {}
    for rid in cut:
        grp = next(gr for gr in prs[4][::-1] if rid in gr)
        ctl = churn(cfg16, p16, 512, 0, keep=grp)
        mine = _per_rid(ctl[1])[rid]
        theirs = _per_rid(prs[1])[rid][-len(mine):]
        controls[rid] = dict(partners=grp, tokens=ctl[2][rid],
                             pressured_tokens=prs[2][rid],
                             unpressured_tokens=unp[2][rid],
                             reproduces=ctl[2][rid] == prs[2][rid] and all(
                                 np.array_equal(a, b)
                                 for a, b in zip(mine, theirs)))
    res["preempt"] = dict(
        unpressured=unp[0], pressured=prs[0], fp32=f32[0],
        bf16_vs_fp32=dict(gap=g["gap"], kept=g["kept"], parts=g["parts"],
                          steps=g["steps"], ratio=g["gap"] / limit),
        logit_gap=lg, logit_bit_equal=lsame, kv_gap=kg, kv_bit_equal=ksame,
        near_tie_cut=cut, controls=controls,
        prefill_groups=dict(unpressured=unp[4], pressured=prs[4]))
    log(f"phase 21 pressure: bf16 vs fp32 at pool 512 {g['gap']:.3e} "
        f"(limit {limit:.3e}), partings {g['parts']}; pool 20 vs 512: "
        f"{prs[0]['preemptions']} preemptions, logits {lg:.3e} (bit-equal "
        f"{lsame}), parted at a near tie {cut}, controls packed with the "
        f"pressured partners {json.dumps(controls)}; prefill passes "
        f"{unp[4]} / {prs[4]}")
    del f32, unp, prs

    runs = zero_copy_runs("bf16", cfg16, p16, tmp, counted=counts.engine,
                          attn_impl="kernel")
    (fc, trc, tokc, _kc), (fz, trz, tokz, _kz) = runs[False], runs[True]
    zgap, zsame = _trace_gap(trz, trc)
    if not (tokc == tokz and zsame and fz["shared_seg_hits"] > 0
            and fc["shared_seg_hits"] == 0):
        raise RuntimeError(f"phase 21: zero-copy vs copy: tokens equal "
                           f"{tokc == tokz}, logits {zgap}, shared "
                           f"{fz['shared_seg_hits']}")
    runs = incremental_runs("bf16", cfg16, p16, counted=counts.engine,
                            attn_impl="kernel")
    (fi, tri, toki, kvi), (fr, trr, tokr, kvr) = runs[True], runs[False]
    igap, isame = _trace_gap(tri, trr)
    ikg, iksame = kv_gap("phase 21 incremental", kvi, kvr)
    if not (toki == tokr and isame and iksame and fi["decode_rebuilds"] == 1
            and fr["decode_rebuilds"] > 1):
        raise RuntimeError(f"phase 21: incremental vs rebuild: tokens equal "
                           f"{toki == tokr}, logits {igap}, KV {ikg}, "
                           f"rebuilds {fi['decode_rebuilds']} vs "
                           f"{fr['decode_rebuilds']}")
    res["zero_copy"] = dict(bit_equal=zsame, logit_gap=zgap,
                            shared_seg_hits=fz["shared_seg_hits"],
                            cow_clones=fz["cow_clones"])
    res["incremental"] = dict(bit_equal=isame, kv_bit_equal=iksame,
                              rebuilds=[fi["decode_rebuilds"],
                                        fr["decode_rebuilds"]])
    log(f"phase 21: zero-copy == copy and incremental == rebuild byte for "
        f"byte in bf16: {json.dumps([res['zero_copy'], res['incremental']])}")
    return res


def run_bf16_engine(cfg, params, bf16, tmp, device="cuda"):
    """Phase 21: the rest of the bf16 engine on the card, full-width
    llama3-8b on phase 19's weights (``params`` rounded to bf16 values,
    ``bf16["params16"]`` their bf16 copy), ``kernel``, TF32 off: the
    executor's cases in bf16 beside fp32 (``_bf16_strategies``), the
    engine under pool pressure (``_bf16_pressure``) and the HTTP server
    around a bf16 engine (``run_server``; its survivors' tokens against
    A16's offline ones from phase 19, logged). ``limit`` is phase 19's:
    BF16_FORWARD_FACTOR times the plain forward's bf16-vs-fp32 gap read
    in that run. Every chunk and decode launch of the bf16 runs, counted
    from 0 around each, must be the mixed instantiation and as many as
    their plans imply; RoPE stays fp32; no paged launch. ``blend``'s
    probe call (A = S) is held and timed in the mixed instantiation beside
    its fp32 call."""
    import torch

    t_phase = time.perf_counter()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg16 = cfg.replace(dtype="bfloat16", param_dtype="bfloat16")
    p16 = bf16["params16"]
    limit = bf16["logit_limit"]
    counts = Bf16Launches()
    try:
        strat = _bf16_strategies(cfg, params, cfg16, p16, tmp, limit, counts,
                                 device)
        pressure = _bf16_pressure(cfg, params, cfg16, p16, tmp, limit, counts)
        with counts.counted():
            served = run_server(cfg16, p16, tmp, bf16["tokens16"],
                                tag="server bf16")
        counts.want["chunk_attention"] += \
            served["prefill_batches"] * cfg.num_layers
        counts.want["decode_attention"] += \
            served["decode_steps"] * cfg.num_layers
        launches = counts.check("phase 21")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    out = dict(strategies=strat, pressure=pressure, server=served,
               launches=launches, want=dict(counts.want), limit=limit,
               seconds=time.perf_counter() - t_phase)
    log(f"phase 21 (the bf16 engine: strategies, pressure, server): "
        f"{out['seconds']:.1f}s")
    return out


# ---------------------------------------------------------------------------
# phase 20: the reference's bf16 deployment through the step roots and the
# train step (bf16 params and activations over bf16 caches)
# ---------------------------------------------------------------------------
# The bf16 rule on the card (PERF.md §2). The reference's own form
# (tests/test_torch_bf16_steps.py, on the CPU) holds the port's bf16 value
# within twice the reference's bf16-vs-fp32 gap. No reference runs here,
# so the plain route stands in for it: the yardstick gap of a value is
# the ``dense`` route in bf16 against the ``kernel`` route in fp32 on the
# same bf16-rounded weights (fp32 caches, TF32 off). A bf16 value (the
# ``kernel`` route against that fp32 route, ``kernel`` against ``dense``
# in bf16, sharded against unsharded in bf16) holds when, for each step
# and each kind of floating leaf (the logits; ``k``, ``v``, ``h``,
# ``conv``, ``s`` over every layer), its rms gap is within
# BF16_GAP_FACTOR x the yardstick's rms gap and its largest within
# BF16_GAP_FACTOR x the yardstick's largest plus one bf16 ulp of the
# value's largest magnitude (two bf16 roundings of nearly equal values
# land up to one ulp apart); positions equal. The bf16 train step: each
# step's loss within BF16_GAP_FACTOR x the mean per-token NLL gap of the
# plain train-mode forward (bf16 against fp32) at the initial params on
# the first batch, its grad norm within BF16_GAP_FACTOR x the norm of
# that forward's grad gap (a mean and a norm cancel their elements'
# rounding by chance, so their own gaps are no scale), at the first step,
# where both runs hold the same params; the bf16 losses falling.
BF16_GAP_FACTOR = 2.0
# the families whose bf16 model roots run whole beside llama3-8b
BF16_FAMILIES = ("recurrentgemma-9b", "gemma3-4b", "mamba2-370m")
BF16_MESH = (1, 4)
BF16_TRAIN_STEPS = 3
# the bf16 params after the first AdamW step: at least this share of them
# bit-equal to the update written out in fp32 and rounded to nearest (the
# same fp32 operations in the same order give the same bits; a rounding
# other than to nearest parts about half of them), none beyond one ulp
BF16_UPDATE_EQUAL = 0.999
BF16_PAIR = (("bfloat16", "bfloat16"),)


def _leaf_gaps(got, want):
    """{(step, leaf kind): [sum of squares, count, max abs, max |want|]}
    of ``got`` against ``want`` (``_serve_steps``' results) over the
    logits and every floating cache leaf; positions must be equal."""
    import torch
    gaps = {}
    for what, (lg, cache) in want.items():
        pairs = [("logits", got[what][0], lg)]
        for part in ("groups", "tail"):
            for g, w in zip(got[what][1][part], cache[part]):
                for n, x in w.items():
                    if x.is_floating_point():
                        pairs.append((n, g[n], x))
                    elif not torch.equal(g[n], x):
                        raise RuntimeError(f"phase 20: {what} {part} {n}: "
                                           "the cache positions differ")
        for n, a, b in pairs:
            d = a.float() - b.float()
            acc = gaps.setdefault((what, n), [0.0, 0, 0.0, 0.0])
            acc[0] += float(d.double().square().sum())
            acc[1] += d.numel()
            acc[2] = max(acc[2], float(d.abs().max()))
            acc[3] = max(acc[3], float(b.float().abs().max()))
    return gaps


def _ulp16(x):
    """One bf16 ulp at magnitude ``x``."""
    return 2.0 ** (math.floor(math.log2(max(x, 2.0 ** -126))) - 7)


def hold_bf16(tag, got, want, yard):
    """``got`` against ``want`` by the bf16 rule of ``yard`` (the
    yardstick's ``_leaf_gaps``): raises beyond it; returns the worst
    ratios of the rms and the largest gap to their limits."""
    worst, bad = [0.0, 0.0], []
    for key, (ss, n, mx, top) in _leaf_gaps(got, want).items():
        ys, yn, ymx, _ = yard[key]
        rms, yrms = math.sqrt(ss / n), math.sqrt(ys / yn)
        r = (rms / (BF16_GAP_FACTOR * yrms) if yrms else
             (0.0 if rms == 0 else math.inf),
             mx / (BF16_GAP_FACTOR * ymx + _ulp16(top)))
        worst = [max(worst[0], r[0]), max(worst[1], r[1])]
        if not (r[0] <= 1.0 and r[1] <= 1.0):
            bad.append((key, rms, yrms, mx, ymx))
    log(f"phase 20: {tag}: worst {worst[0]:.3f} (rms) and {worst[1]:.3f} "
        f"(largest) of the bf16 rule's limits")
    if bad:
        raise RuntimeError(f"phase 20: {tag} beyond the bf16 rule "
                           f"(step, leaf, rms, yardstick rms, max, "
                           f"yardstick max): {bad}")
    return dict(worst_rms_ratio=worst[0], worst_max_ratio=worst[1])


def _counted(run):
    """Runs ``run()`` with the chunk, decode and SSD counts (by
    instantiation) set to 0 just before it and their calls recorded;
    returns its result, {kernel: {instantiation: launches}} and the
    recorders."""
    from repro_torch.kernels.chunk_attention import ops as cops
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.ssd import ops as sops

    fns = {"chunk_attention": cops.chunk_attention,
           "decode_attention": dops.decode_attention,
           "ssd_intra": sops.ssd_intra}
    for f in fns.values():
        f.launches = 0
        f.launches_by_type.clear()
    with ChunkRecorder(cops) as cc, DecodeRecorder(dops) as dc, \
            SsdRecorder(sops) as sc:
        res = run()
    return res, {k: dict(f.launches_by_type) for k, f in fns.items()}, \
        (cc, dc, sc)


def _expect_types(tag, got, cfg, shards=1, decode=SERVE_DECODE,
                  with_cc=True, dtype="bfloat16", ssd=True):
    """Launch counts from 0: a chunk launch per attention layer, model
    shard and prefill pass (the Cache-Craft step one more), a decode
    launch per attention layer, shard and step, an SSD launch per SSD
    layer and shard in the prefill (none where ``ssd`` is false, the SSD
    on its plain version); the chunk and decode ones all of ``dtype``'s
    instantiation, the SSD ones fp32 (the model widens its inputs)."""
    n_attn = sum(k in ("attn", "local") for k in cfg.layer_kinds)
    n_ssd = cfg.layer_kinds.count("ssd") if ssd else 0
    want = {"chunk_attention": (1 + with_cc) * n_attn * shards,
            "decode_attention": decode * n_attn * shards,
            "ssd_intra": n_ssd * shards}
    want = {k: {("float32" if k == "ssd_intra" else dtype): n}
            if n else {} for k, n in want.items()}
    log(f"phase 20: {tag}: launches by instantiation {json.dumps(got)} "
        f"(expected {json.dumps(want)})")
    if got != want:
        raise RuntimeError(f"phase 20: {tag}: launches {got}, expected "
                           f"{want}")


def _bf16_routes(name, cfg, params, p16, inp, dev, cache_len, mesh=None):
    """The three steps of ``cfg`` on ``kernel`` in bf16 (counted), on
    ``dense`` in bf16 and on ``kernel`` in fp32 on the same bf16-rounded
    weights, and with ``mesh`` on ``kernel`` in bf16 sharded (counted);
    each held by the bf16 rule. Where ``cfg`` has SSD layers, the
    ``dense`` and fp32 routes run the SSD through its plain version
    (``PlainSsd``): its one fp32 instantiation would else make ``dense``
    and ``kernel`` one computation and the yardstick the kernel's own.
    Returns the figures and the bf16 kernel run's recorders."""
    import contextlib

    import torch

    from repro_torch.distributed import sharding as SH
    from repro_torch.kernels.ssd import ops as sops
    from repro_torch.launch import dryrun as DR

    cfg16 = cfg.replace(dtype="bfloat16", param_dtype="bfloat16")
    cc_on = cfg.supports_chunk_cache
    kw = dict(cache_len=cache_len, with_cc=cc_on)
    has_ssd = "ssd" in cfg.layer_kinds

    def plain(c, p, impl):
        with (PlainSsd(sops) if has_ssd else contextlib.nullcontext()):
            return _serve_steps(c, p, inp, impl, dev, **kw)
    out, t0 = {}, time.perf_counter()
    k16, n, rec = _counted(lambda: _serve_steps(cfg16, p16, inp, "kernel",
                                                dev, **kw))
    out["kernel_seconds"] = time.perf_counter() - t0
    _expect_types(f"{name} kernel bf16", n, cfg, with_cc=cc_on)
    out["launches"] = n
    d16, nd, _ = _counted(lambda: plain(cfg16, p16, "dense"))
    if any(nd.values()):
        raise RuntimeError(f"phase 20: {name}: the dense route launched "
                           f"{nd}")
    k32, n32, _ = _counted(lambda: plain(cfg, params, "kernel"))
    _expect_types(f"{name} kernel fp32", n32, cfg, with_cc=cc_on,
                  dtype="float32", ssd=not has_ssd)
    yard = _leaf_gaps(d16, k32)
    out["yardstick"] = {f"{w} {k}": dict(rms=math.sqrt(v[0] / v[1]),
                                         max=v[2])
                        for (w, k), v in yard.items()}
    out["plain_ssd"] = has_ssd
    log(f"phase 20: {name}: the yardstick (dense bf16 vs kernel fp32"
        f"{', both with the plain SSD' if has_ssd else ''}): "
        + json.dumps({k: f"rms {v['rms']:.3e} max {v['max']:.3e}"
                      for k, v in out["yardstick"].items()}))
    out["kernel_vs_fp32"] = hold_bf16(f"{name} kernel bf16 vs fp32", k16,
                                      k32, yard)
    out["kernel_vs_dense"] = hold_bf16(f"{name} kernel vs dense in bf16",
                                       k16, d16, yard)
    del d16, k32
    _free()
    if mesh is not None:
        psh = DR.serving_shardings(cfg16, "prefill", SERVE_ROWS, cache_len,
                                   mesh)[0]
        sp16 = SH.shard_tree(p16, psh)
        shards = mesh.devices.size
        t0 = time.perf_counter()
        ks, ns, _ = _counted(lambda: _serve_steps(
            cfg16, p16, inp, "kernel", dev, mesh, sp16, **kw))
        out["mesh_seconds"] = time.perf_counter() - t0
        _expect_types(f"{name} kernel bf16 on {list(mesh.devices.shape)}",
                      ns, cfg, shards=shards, with_cc=cc_on)
        out["mesh_launches"] = ns
        out["sharded_vs_unsharded"] = hold_bf16(
            f"{name} on {list(mesh.devices.shape)} vs unsharded", ks, k16,
            yard)
        del sp16, ks
    del k16
    _free()
    return out, rec


def _kernel_rows(tag, rec, decode_b1=False):
    """The pure-bf16 chunk and decode kernels held and timed on the
    recorded inputs of the run's most frequent call of each (and the
    decode call's first row, ``decode_b1``); the SSD kernel (fp32, the
    model widens its inputs) likewise, against ``ssd_intra_ref``."""
    cc, dc, sc = rec
    rows = {}
    sk = sc.most_frequent()
    if sk is not None:
        rows["ssd_intra"] = dict(
            calls=sc.shapes[sk], shape=list(sk), **measure_ssd_call(
                f"{tag} bf16 step roots path", sc.calls[sk],
                sc.calls[sk])["float32"])
    if cc.shapes:
        ck = max(cc.shapes, key=lambda k: (cc.shapes[k], k))
        rows["chunk_attention"] = dict(
            calls=cc.shapes[ck], **measure_chunk(
                f"{tag} bf16 step roots path{list(ck)}", cc.calls[ck],
                BF16_PAIR)["bfloat16"])
    dk = dc.most_frequent("dense")
    if dk is not None:
        di = dc.calls[dk]
        rows["decode_attention"] = dict(
            calls=dc.shapes[dk], **measure_decode(
                f"{tag} bf16 step roots path{list(dk[1:])}", di,
                BF16_PAIR)["bfloat16"])
        if decode_b1:
            one = {k: (v[:1] if hasattr(v, "dim") else v)
                   for k, v in di.items()}
            rows["decode_attention_b1"] = dict(
                calls=0, **measure_decode(f"{tag} bf16 step roots B 1 "
                                          f"(row 0 of {list(dk[1:])})", one,
                                          BF16_PAIR)["bfloat16"])
    return rows


def run_bf16_steps(cfg, params, p16, dev, card):
    """Phase 20, llama3-8b: the reference's bf16 deployment (bf16 params
    and activations, bf16 caches from ``init_cache`` at ``cfg.dtype``)
    through the prefill, Cache-Craft and decode step roots at full width
    and depth, on phase 19's weights (``params`` rounded to bf16 values,
    ``p16`` their bf16 copy), phase 18's inputs (4 rows, a 512-token
    prefill into 576 slots, 160 active positions, 8 decode steps), TF32
    off: unsharded on ``kernel`` and ``dense``, on ``kernel`` over
    (data 1, model 4), and on ``kernel`` in fp32 as the yardstick; the
    pure-bf16 chunk and decode kernels counted from 0 and held and timed
    on the recorded inputs of their most frequent calls."""
    import torch

    from repro_torch.launch.mesh import make_debug_mesh

    t_phase = time.perf_counter()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            inp = _serve_inputs(cfg, dev)
            out, rec = _bf16_routes(cfg.name, cfg, params, p16, inp, dev,
                                    SERVE_CACHE,
                                    make_debug_mesh(BF16_MESH, device=dev))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    out["kernels"] = _kernel_rows(cfg.name, rec)
    del rec
    _free()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 20 (bf16 step roots, {cfg.name}) [{card}]: "
        f"{out['seconds']:.1f}s")
    return out


def _nll_tokens(cfg, params, b):
    """Per-token NLL of the plain train-mode forward (fp32 [B, T])."""
    import torch
    import torch.nn.functional as F

    from repro_torch.models import model as M
    logits = M.forward(cfg, params, tokens=b["tokens"], mode="train",
                       attn_impl="dense").logits.float()
    return -F.log_softmax(logits, -1).gather(
        -1, b["labels"].long()[..., None])[..., 0]


def _ulp16_t(b):
    """One bf16 ulp at each |b| (the smallest normal's at 0), fp32."""
    import torch
    return torch.exp2(torch.floor(torch.log2(
        b.float().abs().clamp_min(2.0 ** -126))) - 7)


def _beyond_ulp(got, want):
    """Elements of ``got`` more than one bf16 ulp of ``want`` from it
    (a count), and those bit-equal."""
    import torch
    d = (got.float() - want.float()).abs()
    return int((d > _ulp16_t(want)).sum()), int(torch.eq(got, want).sum())


def bf16_train(dev, card):
    """The bf16 train step of llama3-8b cut to 2 layers (phase 5's cut,
    4 x 1024 tokens in 2 microbatches, TF32 off): BF16_TRAIN_STEPS steps
    from a seed-0 init rounded to bf16, beside the fp32 step from the
    same bf16-rounded init; step ms (events, after the first), tokens/s,
    peak memory (the largest of the steps'), MFU against the bf16 peak;
    the bf16 losses falling; the first step (the same params in both)
    held by the bf16 rule's train part (the plain forward's per-token NLL
    and grad gaps at the init); and the first update itself: the bf16
    params after it equal AdamW's fp32 update of the initial params from
    the run's own fp32 moments, rounded to nearest bf16 (BF16_UPDATE_EQUAL
    of them bit for bit, every one within one ulp), and leave one ulp of the fp32 run's params rounded
    to bf16 at no more than BF16_GAP_FACTOR x the share of elements
    whose grad at the init changes sign between bf16 and fp32 (the first
    AdamW step moves each param by lr x sign(grad), so two runs part by
    2 lr only where the signs part)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.training import steps as TS
    from repro_torch.training.data import DataConfig, SyntheticLM
    from repro_torch.training.optimizer import (AdamWConfig, adamw_init,
                                                global_norm, tree_leaves)
    rl = _roofline()
    cfg = get_config("llama3-8b").replace(num_layers=2)
    cfg16 = cfg.replace(dtype="bfloat16", param_dtype="bfloat16")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    p32 = TS._trainable(M.init_params(cfg, gen))
    p16 = TS._trainable(bf16_copy(p32))
    # the initial bf16 params, on the host (both runs update in place)
    p0 = [x.detach().to("cpu", copy=True) for x in tree_leaves(p16)]
    data = SyntheticLM(DataConfig(seq_len=TRAIN_SEQ,
                                  global_batch=TRAIN_BATCH,
                                  vocab_size=cfg.vocab_size))

    def batch(i):
        return {k: torch.from_numpy(v).to(dev)
                for k, v in data.batch(i).items()}
    b0 = batch(0)
    # the yardsticks: the plain forward's per-token NLL gap, the norm of
    # its grad gap and the share of its grads that change sign, bf16
    # against fp32, at the init
    with torch.no_grad():
        nll_gap = float((_nll_tokens(cfg16, p16, b0) -
                         _nll_tokens(cfg, p32, b0)).abs().mean())
    grads = {}
    for name, c, p in (("bf16", cfg16, p16), ("fp32", cfg, p32)):
        loss = TS.loss_fn(c, p, b0)[0]
        grads[name] = [g.float() for g in torch.autograd.grad(
            loss, list(tree_leaves(p)))]
        del loss
    gn_gap = float(global_norm([a - b for a, b in zip(grads["bf16"],
                                                      grads["fp32"])]))
    n_el = sum(g.numel() for g in grads["fp32"])
    sign_share = sum(int((torch.sign(a) != torch.sign(b)).sum()) for a, b
                     in zip(grads["bf16"], grads["fp32"])) / n_el
    del grads
    _free()
    opt = AdamWConfig(**_train_opt(cfg))
    runs, upd = {}, {}
    for name, c, p in (("fp32", cfg, p32), ("bf16", cfg16, p16)):
        state = TS.TrainState(step=torch.zeros((), dtype=torch.int32,
                                               device=dev),
                              params=p, opt=adamw_init(p))
        step = TS.make_train_step(c, opt, accum=TRAIN_ACCUM)
        losses, gnorms, ms, peaks = [], [], [], []
        for i in range(BF16_TRAIN_STEPS):
            b = batch(i)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            state, m = step(state, b)
            e1.record()
            torch.cuda.synchronize()
            ms.append(e0.elapsed_time(e1))
            peaks.append(torch.cuda.max_memory_allocated(dev))
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
            if i == 0 and name == "fp32":
                # the fp32 run's params after the first step, rounded
                r32 = [x.to(torch.bfloat16).cpu()
                       for x in tree_leaves(state.params)]
            elif i == 0:
                upd = _first_update(opt, state, p0, r32, dev)
        step_ms = float(np.mean(ms[1:]))
        flops = rl.model_flops_6nd(cfg, "train", TRAIN_BATCH, TRAIN_SEQ)
        runs[name] = dict(
            losses=losses, grad_norms=gnorms, step_ms=step_ms,
            step_ms_all=ms, tokens_per_s=TRAIN_BATCH * TRAIN_SEQ /
            (step_ms / 1e3), peak_mem_gb=max(peaks) / 1e9,
            mfu=flops / (step_ms / 1e3) / rl.PEAK_FLOPS_BY_TYPE[c.dtype],
            param_dtype=str(next(tree_leaves(state.params)).dtype),
            moment_dtype=str(next(tree_leaves(state.opt["m"])).dtype))
        del state, step, m
        if name == "fp32":
            del p32
        _free()
    del p0, r32
    a, b = runs["bf16"], runs["fp32"]
    loss_gaps = [abs(x - y) for x, y in zip(a["losses"], b["losses"])]
    gnorm_gaps = [abs(x - y) for x, y in zip(a["grad_norms"],
                                             b["grad_norms"])]
    out = dict(runs, nll_gap=nll_gap, grad_gap_norm=gn_gap,
               loss_gaps=loss_gaps, grad_norm_gaps=gnorm_gaps,
               grad_sign_share=sign_share, first_update=upd)
    log(f"phase 20: train {cfg.name}/{cfg.num_layers} bf16 vs fp32 from "
        f"one bf16-rounded init [{card}]: " + json.dumps(out))
    if not (all(np.isfinite(a["losses"])) and a["param_dtype"] ==
            "torch.bfloat16" and a["moment_dtype"] == "torch.float32"
            and a["losses"][-1] < a["losses"][0]):
        raise RuntimeError(f"phase 20: bf16 train step: {a}")
    # the first step runs both on the same params: the rule holds its
    # loss and grad norm; after it the bf16 params take rounded updates
    # (an update below half an ulp is lost), the fp32 ones do not, so the
    # later gaps are the two trainings', logged beside; the first update
    # is held element by element instead
    if not (loss_gaps[0] <= BF16_GAP_FACTOR * nll_gap and
            gnorm_gaps[0] <= BF16_GAP_FACTOR * gn_gap):
        raise RuntimeError(f"phase 20: bf16 train step beyond the bf16 "
                           f"rule at the first step: loss gap "
                           f"{loss_gaps[0]} (limit "
                           f"{BF16_GAP_FACTOR * nll_gap}), grad norm gap "
                           f"{gnorm_gaps[0]} (limit "
                           f"{BF16_GAP_FACTOR * gn_gap})")
    if not (upd["beyond_ulp_of_adamw"] == 0 and
            upd["equal_to_adamw_share"] >= BF16_UPDATE_EQUAL and
            upd["moved_share"] > 0 and
            upd["beyond_ulp_of_fp32_share"] <= BF16_GAP_FACTOR * sign_share):
        raise RuntimeError(f"phase 20: the bf16 train step's first update: "
                           f"{upd}, grad sign share {sign_share} (limit of "
                           f"the share beyond one ulp of the fp32 run's "
                           f"{BF16_GAP_FACTOR * sign_share})")
    return out


def _first_update(opt, state, p0, r32, dev):
    """The bf16 run's params after its first step (``state``) against
    AdamW's update of the initial params ``p0`` (host copies) written out
    in fp32 from the run's own moments, rounded to bf16 (elements beyond
    one ulp of it, and bit-equal), and against ``r32``, the fp32 run's
    params after its first step rounded to bf16 (the share beyond one ulp
    of it); the share of params the step moved."""
    import torch

    from repro_torch.training.optimizer import adamw_scalars, tree_leaves
    # the step's lr and bias corrections, as fp32 scalars on the card
    _, lr, _, bc1, bc2 = adamw_scalars(
        opt, torch.zeros((), dtype=torch.int32, device=dev),
        torch.ones((), device=dev))
    n = beyond = equal = beyond32 = moved = 0
    for p1, m, v, x0, x32 in zip(tree_leaves(state.params),
                                 tree_leaves(state.opt["m"]),
                                 tree_leaves(state.opt["v"]), p0, r32):
        x0 = x0.to(dev).float()
        want = (x0 - lr * ((m / bc1) / (torch.sqrt(v / bc2) + opt.eps) +
                           opt.weight_decay * x0)).to(torch.bfloat16)
        k, e = _beyond_ulp(p1, want)
        k32, _ = _beyond_ulp(p1, x32.to(dev))
        n += p1.numel()
        beyond, equal, beyond32 = beyond + k, equal + e, beyond32 + k32
        moved += int((p1.float() != x0).sum())
        del x0, want
    return dict(beyond_ulp_of_adamw=beyond, equal_to_adamw_share=equal / n,
                beyond_ulp_of_fp32_share=beyond32 / n, moved_share=moved / n,
                elements=n, lr=float(lr))


def run_bf16_families(dev, card):
    """Phase 20, the families and training: recurrentgemma-9b (its
    2048-slot ``local`` ring filled by a 2048-token prompt, so decode
    runs G.D 4096 over it and wraps), gemma3-4b (D 256 on its local and
    global layers) and mamba2-370m (its SSD launches fp32, as the
    reference widens) whole in bf16, as phase 20's llama3-8b runs
    (``_bf16_routes``; no Cache-Craft step where the config takes no
    chunk cache, as the reference's dry-run applies it); then the bf16
    train step (``bf16_train``)."""
    import torch

    from repro_torch.configs import get_config

    t_phase = time.perf_counter()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    try:
        for arch in BF16_FAMILIES:
            t_case = time.perf_counter()
            cfg = get_config(arch)
            params = _params(cfg, dev)
            p16 = bf16_copy(params)
            # recurrentgemma's prompt fills its ring; the others take
            # phase 18's
            rg = arch == "recurrentgemma-9b"
            tokens = cfg.window if rg else SERVE_TOKENS
            with torch.no_grad():
                inp = _serve_inputs(cfg, dev, tokens=tokens)
                r, rec = _bf16_routes(cfg.name, cfg, params, p16, inp, dev,
                                      tokens + SERVE_DECODE if rg
                                      else SERVE_CACHE)
            del params, p16, inp
            _free()
            r["kernels"] = _kernel_rows(cfg.name, rec, decode_b1=rg)
            del rec
            _free()
            r["seconds"] = time.perf_counter() - t_case
            out[arch] = r
        out["train"] = bf16_train(dev, card)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 20 (bf16 families and the bf16 train step) [{card}]: "
        f"{out['seconds']:.1f}s")
    return out


# ---------------------------------------------------------------------------
# phase 23: the port's examples at llama3-8b's full width
# ---------------------------------------------------------------------------
# the tiny main() of each example, run as a user runs it (no --device: the
# card); serve_rag on fewer requests
EXAMPLE_MAINS = (("quickstart", ()), ("cache_analysis", ()),
                 ("serve_rag", ("--requests", "4")))
EXAMPLE_REQUESTS = 16        # serve_rag's own default, as is its pool
EXAMPLE_FULL_RECOMPUTE = 2e-4   # cache_analysis's 100% recompute row


def _example_env():
    """The environment without ``PYTHONPATH``: each example finds the
    package from its own place in the checkout."""
    return {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}


def _example(name):
    """``examples/torch_<name>.py`` as a module."""
    import importlib.util
    path = os.path.join(ROOT, "examples", f"torch_{name}.py")
    spec = importlib.util.spec_from_file_location(f"torch_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_examples(cfg, params, dev, card, tmp, mains_argv=()):
    """Phase 23: ``run`` of the quickstart, cache_analysis and serve_rag
    examples on full-width llama3-8b's fp32 weights (serve_rag at its 16
    requests and 4,096-block pool), the kernel launches of each counted
    from 0 (the Cache-Craft engine's apart from full recompute's, read
    when serve_rag builds its second engine); each example's tiny
    ``main()`` in a subprocess beside the first two (``mains_argv`` added
    to each one's arguments: ``--device cpu`` in the CPU rehearsal).
    Raises unless every
    request completes in both strategies, Cache-Craft computes fewer
    prefill tokens than the total and full recompute all of them,
    quickstart's second request has two hits or more and computes fewer
    tokens than it holds, cache_analysis's 100% row is within
    ``EXAMPLE_FULL_RECOMPUTE``, the RoPE kernel ran in quickstart and
    in the Cache-Craft engine, and the recorded inputs of each example's
    most frequent RoPE call hold against the plain RoPE (``measure_rope``;
    the examples' own shapes). Returns the figures."""
    from repro_torch import device as devmod
    from repro_torch.kernels.chunk_attention import ops as cops
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.rope import ops as rops

    # by name: while a RopeRecorder wraps rope, its stand-in holds the count
    counters = {"chunk_attention": cops, "decode_attention": dops,
                "paged_decode_attention": dops, "rope": rops}

    def zero():
        for n, mod in counters.items():
            getattr(mod, n).launches = 0

    def read():
        return {n: getattr(mod, n).launches for n, mod in counters.items()}

    t_all = time.perf_counter()
    _reset_peak(dev)
    figs = {}
    procs = {}
    recs = {}
    try:
        for name, argv in EXAMPLE_MAINS:
            out = open(os.path.join(tmp, f"example-{name}.log"), "w+")
            procs[name] = (subprocess.Popen(
                [sys.executable, os.path.join(ROOT, "examples",
                                              f"torch_{name}.py"), *argv,
                 *mains_argv],
                env=_example_env(), cwd=ROOT, stdout=out,
                stderr=subprocess.STDOUT, text=True), out, time.perf_counter())

        for name in ("quickstart", "cache_analysis"):
            mod = _example(name)
            zero()
            t0 = time.perf_counter()
            with RopeRecorder(rops) as recs[name]:
                figs[name] = mod.run(cfg, params, dev)
                devmod.sync(dev)
            figs[name]["seconds"] = time.perf_counter() - t0
            figs[name]["launches"] = read()
            log(f"example {name} ({cfg.name}, beside the tiny mains): "
                + json.dumps(figs[name]))

        mains = {}
        for name, (proc, out, t0) in procs.items():
            rc = proc.wait(timeout=600)
            out.seek(0)
            text = out.read()
            out.close()
            # waited on in order, so this is when it was reaped, not how
            # long it ran
            mains[name] = dict(exit=rc, reaped_s=time.perf_counter() - t0)
            cmd = " ".join((f"examples/torch_{name}.py",
                            *dict(EXAMPLE_MAINS)[name], *mains_argv))
            log(f"{cmd} (tiny, exit {rc}, reaped "
                f"{mains[name]['reaped_s']:.1f}s after its start, beside "
                "the other mains and the first two examples): "
                + " | ".join(text.strip().splitlines()[-4:]))
            want = {"quickstart": ["Cache-Craft:"],
                    "cache_analysis": ["recompute 100%: deviation"],
                    "serve_rag": ["== full-recompute ==", "== cache-craft ==",
                                  "completed 4,"]}[name]
            if rc != 0 or any(w not in text for w in want):
                raise RuntimeError(f"examples/torch_{name}.py failed: "
                                   f"{text[-3000:]}")
        figs["tiny_mains"] = mains
    finally:
        for proc, out, _t in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            out.close()

    mod = _example("serve_rag")
    builds = []
    build_engine = mod.build_engine

    def counted_build(*a, **kw):
        builds.append(read())
        return build_engine(*a, **kw)

    mod.build_engine = counted_build
    zero()
    t0 = time.perf_counter()
    with RopeRecorder(rops) as recs["serve_rag cache-craft"]:
        figs["serve_rag"] = mod.run(cfg, params, dev, EXAMPLE_REQUESTS)
    figs["serve_rag"]["seconds"] = time.perf_counter() - t0
    end = read()
    figs["serve_rag"]["full-recompute"]["launches"] = builds[1]
    figs["serve_rag"]["cache-craft"]["launches"] = {
        n: end[n] - builds[1][n] for n in end}
    log("example serve_rag (" + cfg.name + "): "
        + json.dumps(figs["serve_rag"]))
    figs["peak_gb"] = _peak(dev) / 1e9 if dev.type == "cuda" else None
    figs["seconds"] = time.perf_counter() - t_all

    q, a, sr = figs["quickstart"], figs["cache_analysis"], figs["serve_rag"]
    log(f"examples [{card}]: quickstart deviation from full recompute: "
        f"naive reuse {q['dev_naive']:.6f}, Cache-Craft "
        f"{q['dev_cachecraft']:.6f} ({q['hits']} hits, computed "
        f"{q['r2_computed']}/{q['r2_total']})")
    log(f"examples [{card}]: cache_analysis CCI by chunk "
        + json.dumps(a["chunks"]) + "; Fig. 7 " + json.dumps(a["fig7"])
        + "; Fig. 15 " + json.dumps(a["fig15"]))
    for name in ("full-recompute", "cache-craft"):
        r = sr[name]
        log(f"examples [{card}]: serve_rag {name}: TTFT mean "
            f"{r['ttft_mean_ms']:.1f} ms, throughput "
            f"{r['throughput_rps']:.3f} rps on the engine clock "
            f"{r['clock_s']:.3f} s, prefill tokens computed "
            f"{r['prefill_tokens_computed']}/{r['prefill_tokens_total']}")
    log(f"examples [{card}]: peak memory {figs['peak_gb']} GB; phase "
        f"{figs['seconds']:.1f}s")

    for name in ("full-recompute", "cache-craft"):
        r = sr[name]
        if r["completed"] != r["requests"] or r["failed"]:
            raise RuntimeError(f"serve_rag {name}: {r['completed']}/"
                               f"{r['requests']} completed, {r['failed']} "
                               "failed")
    if sr["full-recompute"]["prefill_tokens_computed"] != \
            sr["full-recompute"]["prefill_tokens_total"]:
        raise RuntimeError("serve_rag full-recompute skipped prefill tokens")
    if sr["cache-craft"]["prefill_tokens_computed"] >= \
            sr["cache-craft"]["prefill_tokens_total"]:
        raise RuntimeError("serve_rag cache-craft: no prefill token saved")
    if q["hits"] < 2 or q["r2_computed"] >= q["r2_total"]:
        raise RuntimeError(f"quickstart: {q['hits']} hits, computed "
                           f"{q['r2_computed']}/{q['r2_total']}")
    if a["fig15"][-1]["deviation"] > EXAMPLE_FULL_RECOMPUTE:
        raise RuntimeError(f"cache_analysis: the 100% row reads "
                           f"{a['fig15'][-1]['deviation']}")
    if q["launches"]["rope"] <= 0 or \
            sr["cache-craft"]["launches"]["rope"] <= 0:
        raise RuntimeError("examples: no rope launch in quickstart or in "
                           "the Cache-Craft engine")
    # RoPE at the examples' own shapes: the recorded inputs of each run's
    # most frequent call against the plain version (``measure_rope``; not
    # path launches). Full recompute calls no RoPE, so serve_rag's calls
    # are all the Cache-Craft engine's.
    figs["rope_replay"] = {}
    for name, rc in recs.items():
        rk = rc.most_frequent()
        if rk is None:
            raise RuntimeError(f"examples: {name} recorded no rope call")
        x, pos, theta = rc.calls[rk]
        figs["rope_replay"][name] = dict(
            shape=list(rk[0]), calls=rc.shapes[rk],
            **measure_rope(f"example {name}", x, pos, theta))
    del recs, rc
    _free()
    return figs


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: this smoke "
              "test needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: {SRC}/repro_torch not found: run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)

    import numpy as np

    from repro_torch import device as devmod
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels.chunk_attention import ops as cops
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.rope import ops as rops
    from repro_torch.kernels.ssd import ops as sops
    from repro_torch.models import model as M

    t_all = time.perf_counter()
    dev = devmod.resolve("cuda")
    # phase 1: the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() \
        else "nvidia-smi gave no output"
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")

    # phase 2: build every kernel from the checkout's sources
    t0 = time.perf_counter()
    blog = build.build_all()
    regs = {n: [ln.split("Used ")[1].split(",")[0]
                for ln in r["log"].splitlines() if "Used " in ln]
            for n, r in blog.items()}
    log(f"build: {time.perf_counter() - t0:.2f}s wall, per kernel "
        + json.dumps({n: round(r["seconds"], 2) for n, r in blog.items()})
        + " ptxas " + json.dumps(regs))
    # the chunk kernel's resources per CTA at llama3-8b's D 128, C 16
    clib = build.load("chunk_attention")
    clib.chunk_attention_smem_bytes.restype = ctypes.c_longlong
    # D 128, C 16, a key range of 32 tiles (S 1024 in fp32, 2048 in bf16)
    occ = {dt: dict(
        smem_bytes=clib.chunk_attention_smem_bytes(128, 16, bf, 32),
        ctas_per_sm=clib.chunk_attention_occupancy(128, 16, bf, 32))
        for dt, bf in (("float32", 0), ("bfloat16", 1), (MIXED, 2))}
    log("chunk_attention D=128 C=16 per CTA: " + json.dumps(occ)
        + "; ptxas:\n  " + "\n  ".join(
            ln.strip() for ln in blog["chunk_attention"]["log"].splitlines()
            if "Used" in ln or "Compiling entry" in ln or "spill" in ln))
    if min(o["ctas_per_sm"] for o in occ.values()) < 2:
        raise RuntimeError(f"chunk_attention: fewer than 2 CTAs per SM: "
                           f"{occ}")
    # gemma3-4b's D 256 (two warps per query block): one CTA per SM; a
    # key range of 64 tiles in fp32, 32 in bf16 (S 2048)
    occ256 = {dt: dict(
        smem_bytes=clib.chunk_attention_smem_bytes(256, 16, bf, tiles),
        ctas_per_sm=clib.chunk_attention_occupancy(256, 16, bf, tiles))
        for dt, bf, tiles in (("float32", 0, 64), ("bfloat16", 1, 32))}
    log("chunk_attention D=256 C=16 per CTA: " + json.dumps(occ256))
    if min(o["ctas_per_sm"] for o in occ256.values()) < 1:
        raise RuntimeError(f"chunk_attention: D 256 does not fit an SM: "
                           f"{occ256}")
    # the decode kernels' resources per CTA at llama3-8b's G 4, D 128
    dlib = dops.bind(build.load("decode_attention"))
    docc = {f"{kind} {dt}": dict(
        smem_bytes=dlib.decode_attention_smem_bytes(128, 4, bf, paged),
        ctas_per_sm=dlib.decode_attention_occupancy(128, 4, bf, paged))
        for kind, paged in (("dense", 0), ("paged", 1))
        for dt, bf in (("float32", 0), ("bfloat16", 1))}
    docc[f"dense {MIXED}"] = dict(
        smem_bytes=dlib.decode_attention_smem_bytes(128, 4, 2, 0),
        ctas_per_sm=dlib.decode_attention_occupancy(128, 4, 2, 0))
    log("decode_attention G=4 D=128 per CTA: " + json.dumps(docc)
        + "; ptxas:\n  " + "\n  ".join(
            ln.strip() for ln in blog["decode_attention"]["log"].splitlines()
            if "Used" in ln or "Compiling entry" in ln or "spill" in ln))
    if min(o["ctas_per_sm"] for o in docc.values()) < 1:
        raise RuntimeError(f"decode_attention: does not fit an SM: {docc}")

    # the SSD kernel's resources per CTA at mamba2-370m's prefill shape,
    # with the heads per CTA the rule picks there
    slib = sops.bind(build.load("ssd"))
    socc = {}
    for dt, bf in (("float32", 0), ("bfloat16", 1)):
        hg = sops.heads_per_cta(60, 128, 32, 64, 128, getattr(torch, dt))
        socc[dt] = dict(
            heads_per_cta=hg,
            smem_bytes=slib.ssd_intra_smem_bytes(128, 128, 64, hg, bf),
            ctas_per_sm=slib.ssd_intra_occupancy(128, 128, 64, hg, bf))
    log("ssd_intra L=128 N=128 P=64 per CTA: " + json.dumps(socc)
        + "; ptxas:\n  " + "\n  ".join(
            ln.strip() for ln in blog["ssd"]["log"].splitlines()
            if "Used" in ln or "Compiling entry" in ln or "spill" in ln))
    if min(o["ctas_per_sm"] for o in socc.values()) < 1:
        raise RuntimeError(f"ssd_intra: does not fit an SM: {socc}")

    # phase 3: kernels vs plain versions
    krows, decode_tables = check_kernels(dev)
    krows["ssd_intra"] = check_ssd(dev)
    ssd_sweep = sweep_ssd_heads()
    rope_rows = check_rope(dev)
    krows["rope"] = rope_rows["path"]

    # phase 4: mamba2-370m prefill and decode
    mamba, ssd_launches = run_mamba2(dev)

    # phase 5: training, and serving what it wrote
    training = run_training(dev, card)

    # phases 6-8: engines on full-width llama3-8b
    cfg = get_config("llama3-8b")
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = M.init_params(cfg, gen)
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in [params["embed"], params["unembed"],
                                        params["final_norm"]]
                   + [x for g in params["groups"] for x in g.values()])
    log(f"params: {cfg.name} {n_params / 1e9:.3f}B fp32 on {dev} in "
        f"{time.perf_counter() - t0:.1f}s ({cfg.num_layers} layers, "
        f"d_model {cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads, "
        f"head_dim {cfg.head_dim_}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size})")
    launches = {"ssd_intra": ssd_launches}
    engines = {}
    with tempfile.TemporaryDirectory(prefix="chip-smoke-") as tmp:
        # warm-up (untimed, not compared): first-use costs of cuBLAS, the
        # caching allocator and the kernels' libraries land here, not in A
        t0 = time.perf_counter()
        run_engine("warmup", cfg, params, tmp, attn_impl="kernel",
                   num_requests=4, max_new_tokens=2)
        log(f"warm-up engine: {time.perf_counter() - t0:.1f}s")
        cops.chunk_attention.launches = 0
        dops.decode_attention.launches = 0
        dops.paged_decode_attention.launches = 0
        rops.rope.launches = 0
        with ChunkRecorder(cops) as chunk_calls, \
                DecodeRecorder(dops) as dec_calls:
            engines["A"], tr_a, tok_a, plan_a, c_a = run_engine(
                "A", cfg, params, tmp, attn_impl="kernel")
        launches["chunk_attention"] = cops.chunk_attention.launches
        hist = sorted(chunk_calls.shapes.items(),
                      key=lambda kv: (-kv[1], -kv[0][1] * kv[0][2]))
        log("engine A chunk_attention calls by (B, A, S): " + ", ".join(
            f"{k}: {n}" for k, n in hist))
        launches["decode_attention"] = dops.decode_attention.launches
        log("engine A decode_attention calls by (B, S): " + ", ".join(
            f"{k[1:]}: {n}" for k, n in dec_calls.shapes.most_common()))
        # de-rope of every stored miss, re-rope of every injected hit and
        # every zero-copy pool-run load
        launches["rope"] = rops.rope.launches
        if engines["A"]["prefill_tokens_computed"] >= \
                engines["A"]["prefill_tokens_total"]:
            raise RuntimeError("engine A: no chunk reuse happened")

        dops.paged_decode_attention.launches = 0
        with DecodeRecorder(dops) as paged_calls:
            engines["B"], tr_b, tok_b, _plan_b, c_b = run_engine(
                "B", cfg, params, tmp, attn_impl="paged_kernel",
                paged_decode=True)
        launches["paged_decode_attention"] = \
            dops.paged_decode_attention.launches
        log("engine B paged_decode_attention calls by (B, NBmax, bs): "
            + ", ".join(f"{k[1:]}: {n}"
                        for k, n in paged_calls.shapes.most_common()))
        if c_b.decode_gather_bytes != 0:
            raise RuntimeError("engine B gathered KV: "
                               f"{c_b.decode_gather_bytes} bytes")

        engines["C"], tr_c, tok_c, plan_c, _c = run_engine(
            "C", cfg, params, tmp, attn_impl="dense")

        # phase 9: the HTTP server around a fresh kernel engine
        served = run_server(cfg, params, tmp, tok_a)

        # phase 12, while llama3-8b's weights are loaded: the serving mesh
        mesh = run_mesh(cfg, params, dev, tmp, (engines["C"], tr_c, tok_c,
                                                plan_c),
                        paged_calls.calls[paged_calls.most_frequent("paged")],
                        tr_b, tok_b)

        # phase 16, while llama3-8b's weights are loaded: the engine under
        # pool pressure (preemption, zero-copy sharing, incremental batch)
        pressure = run_pressure(cfg, params, tmp)

        # phase 17, while llama3-8b's weights are loaded: every recompute
        # strategy, the ablations, focus and streamed loads on both routes
        strategies = run_strategies(cfg, params, tmp)

        # phase 23, while llama3-8b's fp32 weights are loaded: the port's
        # examples at full width, and each one's tiny main() as a user
        # runs it
        examples = run_examples(cfg, params, dev, card, tmp)

        # phase 10: the families. First the paper's model once more, on
        # a prompt past auto's 2^21 score elements, then its weights go
        long_gap = run_long_prompt(cfg, params, dev)
        # phase 19: bf16 serving on kernel, engines A16 and A32; it rounds
        # the fp32 weights to bf16 values in place, their last use
        bf16 = run_bf16(cfg, params, tmp)
        # phase 21: the rest of the bf16 engine on phase 19's weights: the
        # executor's cases beside fp32, pool pressure, the HTTP server
        bf16_engine = run_bf16_engine(cfg, params, bf16, tmp)
        # phase 20: the reference's bf16 deployment through the step
        # roots, llama3-8b on phase 19's weights, then the families and
        # the bf16 train step once its weights are freed
        bf16_steps = run_bf16_steps(cfg, params, bf16.pop("params16"), dev,
                                    card)
        del params
        _free()
        bf16_fams = run_bf16_families(dev, card)
        families = run_families(dev, tmp)
    # phase 11: the recurrent and vision families through the model roots
    recvis = run_recurrent_vision(dev)
    # phase 13: context-parallel flash and the EF gradient all-reduce
    cp_ef = run_cp_ef(dev)
    # phase 14: sharded training, the elastic restore and the dry-run
    sharded, plain = run_sharded(dev, card, training)
    # phase 15: tensor-parallel training and the MoE aux term, against
    # phase 14's unsharded llama3-8b/2 steps
    tp = run_tp(dev, card, plain)
    # phase 18: the prefill, Cache-Craft and decode steps over (data,
    # model) meshes, the chunk, decode and SSD kernels once per model shard
    tp_serving = run_tp_serving(dev, card)
    # chunk_attention at the path's most frequent shape, on the inputs of
    # engine A's first call of that shape
    path_shape = hist[0][0]
    path_rows = measure_chunk(f"path{list(path_shape)}",
                              chunk_calls.calls[path_shape])
    # the key-split rule against the other counts, at the table's shape
    # and every shape engine A launched (not counted as path launches)
    sweep_chunk_splits(
        {"table": chunk_inputs(np.random.default_rng(0), dev)}
        | {f"path{list(k)}": chunk_calls.calls[k] for k, _ in hist})
    del chunk_calls
    # the decode kernels at the path's most frequent shapes, on the inputs
    # of the first call of each, and the key-split rule against the other
    # counts there and at the table's shapes (not counted as path launches)
    dkey = dec_calls.most_frequent("dense")
    pkey = paged_calls.most_frequent("paged")
    dec_path = measure_decode(f"path{list(dkey[1:])}", dec_calls.calls[dkey])
    paged_path = measure_paged(f"path{list(pkey[1:])}",
                               paged_calls.calls[pkey])
    sweep_decode_splits(
        decode_tables
        | {f"dense path{list(k[1:])}": ("dense", d)
           for k, d in dec_calls.calls.items()}
        | {f"paged path{list(k[1:])}": ("paged", d)
           for k, d in paged_calls.calls.items()})
    del dec_calls, paged_calls
    log(f"launches on the main path: {json.dumps(launches)}")
    for name, n in launches.items():
        if n <= 0:
            raise RuntimeError(f"{name}: no launch on the main path")
    same_plans = sum(plan_a[r] == plan_c[r] for r in plan_a)
    log(f"plans A vs C (hits, computed tokens) identical for "
        f"{same_plans}/{len(plan_a)} requests")
    err_a = compare_logits("A(kernel)", tr_a, tok_a, tr_c, tok_c)
    err_b = compare_logits("B(paged_kernel)", tr_b, tok_b, tr_c, tok_c)

    # phase 22: the kernels line, the mamba2, training, engine, family,
    # recurrent / vision, mesh, pressure, strategies, sharded-training and
    # sharded-serving figures
    sources = {
        "chunk_attention": (
            "src/repro_torch/kernels/chunk_attention/csrc/chunk_attention.cu",
            "src/repro/kernels/chunk_attention/kernel.py:92"),
        "decode_attention": (
            "src/repro_torch/kernels/decode_attention/csrc/"
            "decode_attention.cu",
            "src/repro/kernels/decode_attention/kernel.py:175"),
        "paged_decode_attention": (
            "src/repro_torch/kernels/decode_attention/csrc/"
            "decode_attention.cu",
            "src/repro/kernels/decode_attention/kernel.py:116"),
        "ssd_intra": (
            "src/repro_torch/kernels/ssd/csrc/ssd.cu",
            "src/repro/kernels/ssd/kernel.py:51"),
        "rope": (
            "src/repro_torch/kernels/rope/csrc/rope.cu",
            "src/repro/kernels/rope/kernel.py:38"),
    }
    kernels = []
    for name, (src, rep) in sources.items():
        f32, b16 = krows[name]["float32"], krows[name]["bfloat16"]
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=rep,
            launches=launches[name], max_abs_err=f32["err"], ms=f32["ms"],
            plain_ms=f32["plain_ms"], bound_ms=f32["bound_ms"],
            bound_by=f32["bound_by"], library_ms=f32["library_ms"],
            max_abs_err_bf16=b16["err"], ms_bf16=b16["ms"],
            plain_ms_bf16=b16["plain_ms"], bound_ms_bf16=b16["bound_ms"],
            library_ms_bf16=b16["library_ms"]))
    # chunk_attention's row is at the kernel table's shape; the path's most
    # frequent shape and the fp32 CUDA-core bound beside it
    kernels[0]["shape"] = ("table: B 1, A 256, S 1024, H 32/8, D 128, C 16; "
                           f"path: (B, A, S) {list(path_shape)}")
    kernels[0]["bound_note"] = ("fp32 operations counted as 3xTF32: three "
                                "TF32 products per fp32 product at 495 "
                                "TFLOP/s")
    kernels[0]["bound_ms_cuda_cores"] = \
        krows["chunk_attention"]["float32"]["bound_ms_cuda_cores"]
    for dt, sfx in (("float32", ""), ("bfloat16", "_bf16")):
        r = path_rows[dt]
        kernels[0].update({f"max_abs_err_path{sfx}": r["err"],
                           f"ms_path{sfx}": r["ms"],
                           f"plain_ms_path{sfx}": r["plain_ms"],
                           f"library_ms_path{sfx}": r["library_ms"],
                           f"bound_ms_path{sfx}": r["bound_ms"]})
    # the decode rows are at the kernel table's shapes; the path's most
    # frequent shape beside them
    for name, kind, shape, key, path in (
            ("decode_attention", "dense", "table: B 4, S 1024, H 32/8, "
             "D 128", "(B, S)", (dkey, dec_path)),
            ("paged_decode_attention", "paged", "table: NB 512, bs 16, B 4, "
             "NBmax 64, H 32/8, D 128", "(B, NBmax, bs)",
             (pkey, paged_path))):
        row = next(r for r in kernels if r["name"] == name)
        row["shape"] = f"{shape}; path: {key} {list(path[0][1:])}"
        for dt, sfx in (("float32", ""), ("bfloat16", "_bf16")):
            r = path[1][dt]
            row.update({f"max_abs_err_path{sfx}": r["err"],
                        f"ms_path{sfx}": r["ms"],
                        f"plain_ms_path{sfx}": r["plain_ms"],
                        f"library_ms_path{sfx}": r["library_ms"],
                        f"bound_ms_path{sfx}": r["bound_ms"],
                        f"device_ms_path{sfx}": r["device_ms"],
                        f"library_device_ms_path{sfx}":
                            r["library_device_ms"],
                        f"device_ms{sfx}": krows[name][dt]["device_ms"],
                        f"library_device_ms{sfx}":
                            krows[name][dt]["library_device_ms"],
                        f"splits{sfx}": krows[name][dt]["splits"],
                        f"splits_path{sfx}": r["splits"]})
        row.update({f"smem_bytes_{dt}": docc[f"{kind} {dt}"]["smem_bytes"]
                    for dt in ("float32", "bfloat16")})
    # gemma3-4b's D 256 shapes beside the chunk and decode rows (the
    # decode ones also by the card's clock)
    for name in ("chunk_attention", "decode_attention",
                 "paged_decode_attention"):
        row = next(r for r in kernels if r["name"] == name)
        for dt, sfx in (("float32", ""), ("bfloat16", "_bf16")):
            r = krows[f"{name}_d256"][dt]
            row.update({f"{k}_d256{sfx}": r[k] for k in (
                "err", "ms", "plain_ms", "library_ms", "bound_ms",
                "bound_by", "device_ms", "library_device_ms",
                "ms_d128_half") if k in r})
    kernels[0]["shape_d256"] = ("A 512, S 2048, H 8/4, D 256, C 16, "
                                "window 1024")
    kernels[0]["ctas_per_sm_d256"] = {dt: o["ctas_per_sm"]
                                      for dt, o in occ256.items()}
    kernels[1]["shape_d256"] = "B 4, S 2048, H 8/4, D 256, window 1024"
    kernels[2]["shape_d256"] = ("NB 512, bs 16, B 4, NBmax 128, H 8/4, "
                                "D 256, window 1024")
    # the paged kernel once per head shard of the serving mesh: its
    # launches on engine B with the mesh installed, and the per-shard call
    # on engine B's recorded inputs against the one unsharded launch
    kernels[2]["mesh"] = dict(
        shards=mesh["shards"], launches=mesh["B"]["launches"],
        shape=f"path: (B, NBmax, bs) {list(pkey[1:])}, per shard H "
        f"{cfg.num_heads // mesh['shards']}/"
        f"{cfg.num_kv_heads // mesh['shards']}",
        **{f"{k}{sfx}": mesh["kernel"][dt][k]
           for dt, sfx in (("float32", ""), ("bfloat16", "_bf16"))
           for k in ("err", "gathered_vs_unsharded", "gathered_bit_equal",
                     "ms", "device_ms", "unsharded_ms",
                     "unsharded_device_ms", "plain_ms", "library_ms",
                     "library_device_ms", "bound_ms", "splits")})
    # each family's engine A (and the recurrent and vision model roots):
    # its launches, and the kernel held and timed on the recorded inputs
    # of its most frequent call shape
    paths = {tag: families[tag] for tag in ("gemma3-4b",
                                            "granite-moe-1b-a400m")}
    paths.update({tag: v for tag, v in recvis.items() if tag != "seconds"})
    for row in kernels:
        fam = {}
        for tag, run in paths.items():
            r = run["path"].get(row["name"])
            if r is None:
                continue
            fam[tag] = dict(shape=r["shape"], calls_at_shape=r["calls"],
                            launches=run["launches"][row["name"]])
            for dt, sfx in (("float32", ""), ("bfloat16", "_bf16")):
                fam[tag].update({f"{k}{sfx}": r[dt][k] for k in (
                    "err", "ms", "device_ms", "plain_ms", "library_ms",
                    "bound_ms", "bound_by") if k in r[dt]})
        if fam:
            row["families"] = fam
    # the pressure phase: each kernel's launches there, and the kernel
    # held and timed on the recorded inputs of its most frequent shape
    for row in kernels:
        r = pressure["kernels"].get(row["name"])
        if r is None:
            continue
        row["pressure"] = dict(
            launches=pressure["launches"][row["name"]], shape=r["shape"],
            calls_at_shape=r["calls"],
            **{f"{k}{sfx}": r[dt][k]
               for dt, sfx in (("float32", ""), ("bfloat16", "_bf16"))
               for k in ("err", "ms", "device_ms", "plain_ms", "library_ms",
                         "bound_ms", "bound_by") if k in r[dt]})
    # the strategies phase: the chunk and RoPE launches there, and the
    # chunk kernel held and timed on blend's probe call (A = S)
    for row in kernels:
        n = strategies["launches"].get(row["name"])
        if n is None:
            continue
        row["strategies"] = dict(launches=n)
        if row["name"] == "chunk_attention":
            r = strategies["probe"]
            row["strategies"]["probe"] = dict(
                shape=r["shape"], calls_at_shape=r["calls"],
                **{f"{k}{sfx}": r[dt][k]
                   for dt, sfx in (("float32", ""), ("bfloat16", "_bf16"))
                   for k in ("err", "ms", "plain_ms", "library_ms",
                             "bound_ms", "bound_by") if k in r[dt]})
    # rope's row is at the path's shape; the 1024-token span beside it
    kernels[-1]["shape"] = "[32, 48, 8, 128]; span1024 [32, 1024, 8, 128]"
    # its launches in the examples of phase 23
    kernels[-1]["examples"] = {
        "quickstart": examples["quickstart"]["launches"]["rope"],
        "cache_analysis": examples["cache_analysis"]["launches"]["rope"],
        "serve_rag cache-craft":
            examples["serve_rag"]["cache-craft"]["launches"]["rope"]}
    # and held at each example's most frequent shape, on its own inputs
    kernels[-1]["examples_replay"] = {
        name: dict(shape=r["shape"], calls_at_shape=r["calls"],
                   **{f"{k}{sfx}": r[dt][k]
                      for dt, sfx in (("float32", ""), ("bfloat16", "_bf16"))
                      for k in ("err", "ms", "device_ms", "plain_ms",
                                "bound_ms", "bound_by")})
        for name, r in examples["rope_replay"].items()}
    kernels[-1]["host_ms"] = rope_rows["path"]["float32"]["host_ms"]
    kernels[-1]["device_ms"] = rope_rows["path"]["float32"]["device_ms"]
    kernels[-1]["device_ms_bf16"] = \
        rope_rows["path"]["bfloat16"]["device_ms"]
    for dt, sfx in (("float32", ""), ("bfloat16", "_bf16")):
        r = rope_rows["span1024"][dt]
        kernels[-1].update({f"max_abs_err_span1024{sfx}": r["err"],
                            f"ms_span1024{sfx}": r["ms"],
                            f"plain_ms_span1024{sfx}": r["plain_ms"],
                            f"bound_ms_span1024{sfx}": r["bound_ms"]})
    # ssd_intra's row: device time, the bound's CUDA-core figure, the
    # heads per CTA the rule picks and the sweep over every count
    srow = next(r for r in kernels if r["name"] == "ssd_intra")
    srow["shape"] = "nC 60, L 128, H 32, P 64, N 128"
    srow["bound_note"] = ("per-head products counted as three tensor-core "
                          "passes (3xTF32 at 495 TFLOP/s; bf16 hi + mid + "
                          "lo at 989), C B^T and the decay at 67 TFLOP/s")
    for dt, sfx in (("float32", ""), ("bfloat16", "_bf16")):
        r = krows["ssd_intra"][dt]
        srow.update({f"device_ms{sfx}": r["device_ms"],
                     f"bound_ms_cuda_cores{sfx}": r["bound_ms_cuda_cores"],
                     f"heads_per_cta{sfx}": r["heads_per_cta"],
                     f"worst_ratio{sfx}": r["worst_ratio"],
                     f"ctas_per_sm{sfx}": socc[dt]["ctas_per_sm"],
                     f"smem_bytes{sfx}": socc[dt]["smem_bytes"],
                     f"heads_sweep_ms{sfx}": {
                         str(k): v["ms"]
                         for k, v in ssd_sweep[dt]["times"].items()}})
    log(f"mamba2-370m: prefill {mamba['prefill_ms']:.1f} ms per call "
        f"(4 x 1920 tokens), decode step {mamba['decode_step_ms']:.2f} ms, "
        f"{mamba['decode_tokens_per_s']:.1f} tokens/s at batch 4 [{card}]")
    for name in ("mamba2-370m", "llama3-8b/2"):
        t = training[name]
        log(f"train {name}: step {t['step_ms']:.1f} ms "
            f"({t['step_ms_min']:.1f}-{t['step_ms_max']:.1f}), "
            f"{t['tokens_per_s']:.0f} tokens/s, peak "
            f"{t['peak_mem_gb']:.2f} GB, loss {t['losses'][0]:.4f} -> "
            f"{t['losses'][-1]:.4f}, held-out {t['held_before']:.4f} -> "
            f"{t['held_after']:.4f} (batches spread "
            f"{t['init_spread']:.4f} at init), grad norm at init card "
            f"{t['grad_norm_witness']['card']:.6g} / CPU "
            f"{t['grad_norm_witness']['cpu']:.6g} [{card}]")
    log(f"engines: " + json.dumps({
        k: {m: v[m] for m in ("ttft_mean_ms", "ttft_p99_ms",
                              "prefill_pass_ms", "decode_step_ms",
                              "decode_tokens_per_s", "wall_s")}
        for k, v in engines.items()}))
    log(f"server [{card}]: {served['survivors_done']} survivors done, "
        f"cancelled after {served['cancelled_tokens']} tokens, TTFT (wall) "
        f"mean {served['ttft_wall_mean_ms']:.1f} ms p99 "
        f"{served['ttft_wall_p99_ms']:.1f} ms, wall {served['wall_s']:.1f} s")
    log(f"families [{card}]: " + json.dumps({
        k: {"A": {m: v["A"][m] for m in ("ttft_mean_ms", "decode_step_ms",
                                         "prefill_tokens_computed",
                                         "prefill_tokens_total",
                                         "prompt_tokens_max")},
            "C_decode_step_ms": v["C"]["decode_step_ms"],
            "launches": v["launches"], "logit_err": v["logit_err"],
            "window_masked": v["window_masked"]}
        for k, v in families.items()
        if k in ("gemma3-4b", "gemma3-4b long", "granite-moe-1b-a400m")}))
    log(f"long prompts vs their twins: llama3-8b 4096 auto vs kernel "
        f"{long_gap:.3e}; gemma3-4b roots {families['gemma3-4b roots']}; "
        f"phi3.5-moe/2 {families['phi3.5-moe-42b-a6.6b/2']}; families "
        f"{families['seconds']:.1f}s")
    rg = recvis["recurrentgemma-9b"]
    log(f"recurrent and vision [{card}]: recurrentgemma-9b prefill "
        f"{rg['prefill_ms']:.1f} ms ({RG_TOKENS} tokens), decode step "
        f"{rg['decode_step_ms']:.2f} ms, rglru_scan {rg['rglru_scan_ms']:.3f} "
        "ms; " + json.dumps({
            tag: {k: v for k, v in r.items()
                  if k not in ("path", "prefill_ms", "decode_step_ms",
                               "rglru_scan_ms")}
            for tag, r in recvis.items() if tag != "seconds"})
        + f"; phase {recvis['seconds']:.1f}s")
    # the per-shard launches' device time against the one unsharded
    # launch is in mesh["kernel"]
    log(f"serving mesh and context parallel [{card}]: " + json.dumps(mesh)
        + "; " + json.dumps(cp_ef))
    log(f"engine under pressure [{card}]: " + json.dumps({
        "preempt": {route: {
            "pressured": {m: r["pressured"][m] for m in (
                "wall_s", "ttft_mean_ms", "ttft_p99_ms", "decode_step_ms",
                "head_stall_iters_max", "preemptions",
                "preempt_block_recovered", "burn_requeues")},
            "unpressured": {m: r["unpressured"][m] for m in (
                "wall_s", "ttft_mean_ms", "ttft_p99_ms", "decode_step_ms",
                "head_stall_iters_max")},
            **{m: r[m] for m in ("logit_gap", "logit_bit_equal", "kv_gap",
                                 "kv_bit_equal", "vs_default") if m in r}}
            for route, r in pressure["preempt"].items()},
        "zero_copy": {route: {
            "logit_gap": r["logit_gap"], "bit_equal": r["bit_equal"],
            **{m: r["zero_copy"][m] for m in (
                "shared_seg_hits", "shared_blocks_peak", "cow_clones",
                "wall_s", "ttft_mean_ms", "ttft_p99_ms", "decode_step_ms")}}
            for route, r in pressure["zero_copy"].items()},
        "incremental": {m: pressure["incremental"][m] for m in (
            "logit_gap", "bit_equal", "kv_gap", "kv_bit_equal")},
        "rebuilds": [pressure["incremental"]["incremental"][
            "decode_rebuilds"], pressure["incremental"]["rebuild"][
            "decode_rebuilds"]],
        "launches": pressure["launches"],
        "seconds": pressure["seconds"]}))
    log(f"strategies [{card}]: " + json.dumps({
        "runs": strategies["runs"], "identities": strategies["identities"],
        "streamed": strategies["streamed"], "focus": strategies["focus"],
        "warm": strategies["warm"], "launches": strategies["launches"],
        "chunk_calls": strategies["chunk_calls"],
        "seconds": strategies["seconds"]}))
    log(f"sharded training and the dry-run [{card}]: "
        + json.dumps(sharded))
    log(f"tensor-parallel training [{card}]: " + json.dumps({
        k: v if k == "seconds" or "mesh" not in v else {
            m: v[m] for m in (
                "mesh", "loss_rel_gap", "params_worst_abs", "m_worst_abs",
                "v_worst_abs", "step_ms_plain", "step_ms_sharded",
                "peak_gb_plain", "peak_gb_sharded", "position0_bytes",
                "coll_bytes_counted", "strict", "one_step",
                "one_step_data_parallel", "flips", "aux_rel_gap",
                "control_loss_rel_gap", "control_params_outside",
                "control_flips", "controls", "seconds")
            if m in v}
        for k, v in tp.items()}))
    # the chunk, decode and SSD kernels once per model shard of the
    # serving steps (phase 18): their launches there, and each held and
    # timed on the recorded inputs of its most frequent per-shard call,
    # beside the unsharded call of that shape
    for name, (src, rep) in sources.items():
        r = tp_serving["kernels"].get(name)
        if r is None:
            continue
        f32 = r["float32"]
        row = dict(
            name=f"{name} per model shard", route="cuda", source=src,
            replaces=rep, launches=tp_serving["launches"][name],
            max_abs_err=f32["err"], ms=f32["ms"], plain_ms=f32["plain_ms"],
            bound_ms=f32["bound_ms"], bound_by=f32["bound_by"],
            library_ms=f32["library_ms"], unsharded_ms=f32["unsharded_ms"],
            shape=r["shape"], calls_at_shape=r["calls"])
        if "bfloat16" in r:
            b16 = r["bfloat16"]
            row.update(max_abs_err_bf16=b16["err"], ms_bf16=b16["ms"],
                       plain_ms_bf16=b16["plain_ms"],
                       bound_ms_bf16=b16["bound_ms"],
                       library_ms_bf16=b16["library_ms"])
        kernels.append(row)
    log(f"sharded serving [{card}]: " + json.dumps({
        k: v for k, v in tp_serving.items() if k != "kernels"}))
    # the mixed instantiations on the bf16 engine's path (phase 19): A16's
    # launches of each, and each held and timed on the recorded inputs of
    # A16's most frequent call shape
    for name in ("chunk_attention", "decode_attention"):
        r = bf16["kernels"][name]
        src, rep = sources[name]
        kernels.append(dict(
            name=f"{name} {MIXED}", route="cuda", source=src, replaces=rep,
            launches=bf16["launches"][name][MIXED], max_abs_err=r["err"],
            worst_ratio_to_one_rounding=r["ratio"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
            library_note="two calls: q upcast to fp32, then SDPA with the "
                         "same mask", shape=r["shape"],
            calls_at_shape=r["calls"],
            **{k: r[k] for k in ("mass_err", "bound_ms_cuda_cores",
                                 "device_ms", "library_device_ms", "splits")
               if k in r}))
    log(f"bf16 serving [{card}]: " + json.dumps({
        "A16": {m: bf16["A16"][m] for m in (
            "ttft_mean_ms", "ttft_p99_ms", "prefill_pass_ms",
            "decode_step_ms", "decode_tokens_per_s", "prefill_tokens_computed",
            "prefill_tokens_total", "wall_s")},
        "A32": {m: bf16["A32"][m] for m in (
            "ttft_mean_ms", "ttft_p99_ms", "prefill_pass_ms",
            "decode_step_ms", "decode_tokens_per_s", "prefill_tokens_computed",
            "prefill_tokens_total", "wall_s")},
        **{k: bf16[k] for k in ("launches", "want", "logit_gap",
                                "greedy_parts", "compared_steps",
                                "identical_streams", "plan_diff",
                                "weights_gb", "peak_gb", "seconds")}}))
    # blend's probe call (A = S) in the mixed instantiation on the bf16
    # engine's path (phase 21): the phase's mixed chunk launches, the
    # probe calls, and the probe held and timed beside its fp32 call
    r = bf16_engine["strategies"]["probe"]
    m, f = r[MIXED], r["float32"]
    src, rep = sources["chunk_attention"]
    kernels.append(dict(
        name=f"chunk_attention {MIXED} bf16 probe", route="cuda",
        source=src, replaces=rep,
        launches=bf16_engine["launches"]["chunk_attention"][MIXED],
        probe_calls=r["probe_calls"], max_abs_err=m["err"],
        worst_ratio_to_one_rounding=m["ratio"], mass_err=m["mass_err"],
        ms=m["ms"], plain_ms=m["plain_ms"], bound_ms=m["bound_ms"],
        bound_by=m["bound_by"], bound_ms_cuda_cores=m["bound_ms_cuda_cores"],
        library_ms=m["library_ms"],
        library_note="two calls: q upcast to fp32, then SDPA with the same "
                     "mask", splits=m["splits"], shape=r["shape"],
        calls_at_shape=r["calls"], ms_float32=f["ms"],
        max_abs_err_float32=f["err"], plain_ms_float32=f["plain_ms"],
        library_ms_float32=f["library_ms"], bound_ms_float32=f["bound_ms"]))
    log(f"bf16 engine [{card}]: " + json.dumps({
        "strategies": {k: bf16_engine["strategies"][k]
                       for k in ("runs", "identities", "warm")},
        "pressure": bf16_engine["pressure"],
        "server": bf16_engine["server"],
        "launches": bf16_engine["launches"], "want": bf16_engine["want"],
        "limit": bf16_engine["limit"], "seconds": bf16_engine["seconds"]}))
    # the pure-bf16 chunk and decode instantiations on the step roots'
    # path (phase 20): llama3-8b's launches and its most frequent call of
    # each, the families' beside them
    for name in ("chunk_attention", "decode_attention"):
        r = bf16_steps["kernels"][name]
        src, rep = sources[name]
        fams = {}
        for tag, fr in bf16_fams.items():
            if not isinstance(fr, dict) or "kernels" not in fr:
                continue
            for key, k in fr["kernels"].items():
                if key.startswith(name):
                    # a row cut from another call (calls 0) was never
                    # launched at its own shape on the path
                    fams[f"{tag}{key[len(name):]}"] = dict(
                        launches=(fr["launches"][name].get("bfloat16", 0)
                                  if k["calls"] else 0),
                        **{m: k[m] for m in (
                            "shape", "calls", "err", "ms", "device_ms",
                            "plain_ms", "library_ms", "library_device_ms",
                            "bound_ms", "bound_by") if m in k})
        kernels.append(dict(
            name=f"{name} bfloat16 step roots", route="cuda", source=src,
            replaces=rep,
            launches=bf16_steps["launches"][name]["bfloat16"],
            launches_mesh=bf16_steps["mesh_launches"][name]["bfloat16"],
            max_abs_err=r["err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"],
            library_note="SDPA in bf16 with the same mask",
            shape=r["shape"], calls_at_shape=r["calls"], families=fams,
            **{k: r[k] for k in ("device_ms", "library_device_ms",
                                 "splits") if k in r}))
    # the SSD kernel on the bf16 step roots' path: fp32, as the model
    # widens a bf16 model's inputs (mamba2-370m's prefill)
    src, rep = sources["ssd_intra"]
    for tag, fr in bf16_fams.items():
        r = fr.get("kernels", {}).get("ssd_intra") \
            if isinstance(fr, dict) else None
        if r is None:
            continue
        kernels.append(dict(
            name=f"ssd_intra float32 bf16 step roots ({tag})", route="cuda",
            source=src, replaces=rep,
            launches=fr["launches"]["ssd_intra"]["float32"],
            max_abs_err=r["err"], worst_ratio_to_allclose=r["worst_ratio"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
            bound_ms_cuda_cores=r["bound_ms_cuda_cores"], shape=r["shape"],
            calls_at_shape=r["calls"]))
    log(f"bf16 step roots and train step [{card}]: " + json.dumps({
        cfg.name: {k: v for k, v in bf16_steps.items() if k != "kernels"},
        **{k: ({m: x for m, x in v.items() if m != "kernels"}
               if isinstance(v, dict) else v)
           for k, v in bf16_fams.items()}}))
    log(f"examples [{card}]: " + json.dumps({
        k: v for k, v in examples.items()
        if k in ("tiny_mains", "peak_gb", "seconds")}))
    log(f"end-to-end vs dense: A max abs logit diff {err_a:.3e}, "
        f"B {err_b:.3e}; total {time.perf_counter() - t_all:.1f}s")
    log(card)    # nvidia-smi's name, power.limit line, verbatim
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
