#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA card: the quickest proof that the port builds and serves.

    python3 chip_smoke.py

Phases (each prints its own line; any failure raises and exits non-zero):

1. the card's name and power limit (``nvidia-smi``);
2. build every CUDA kernel from ``src/repro_torch/kernels/*/csrc`` (one
   ``nvcc`` per source, all at once) and print the build seconds;
3. hold each kernel against its plain PyTorch version on the card at the
   main path's shapes, in fp32 (tolerance 3e-5, the reference's) and
   bf16 (3e-2), and time kernel, plain version and one PyTorch library
   call (``scaled_dot_product_attention`` with the same boolean mask, a
   yardstick only) with CUDA events; compute each kernel's bound from
   the bytes and operations these inputs need;
4. engine A: full-width llama3-8b (random weights from a seed, fp32),
   ``cachecraft`` with a chunk store, ``attn_impl="kernel"``: chunk
   attention in the prefill windows, decode attention over the arena;
5. engine B: the same weights and workload with ``paged_decode=True,
   attn_impl="paged_kernel"``: the paged kernel reads the pool in place;
6. engine C: the same with ``attn_impl="dense"`` (plain PyTorch
   attention); A's and B's per-step decode logits are held against C's;
7. a ``kernels`` JSON line (launches on the main path, error, times,
   bound) and per-engine TTFT / decode-step figures;
8. last line: ``{"ok": true, "device": {...}}``.

Launch counts are set to 0 just before engines A and B run and read just
after; the comparison launches of phase 3 do not count. Without CUDA, or
without the repository's ``src/`` beside it, the script exits non-zero
and prints no result.
"""
from __future__ import annotations

import gc
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s and the rate
# for each operand type (fp32 outside the tensor cores; bf16 tensor core)
HBM_BPS = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
TOL = {"float32": 3e-5, "bfloat16": 3e-2}
# A/B vs C decode logits: fp32 attention summed in another order (online
# softmax over 64-key tiles vs one dense softmax), carried through 32
# layers; logits are O(1) (unit-variance unembedding)
LOGIT_TOL = 2e-3


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


def bound(nbytes, flops, dtype):
    t_b = nbytes / HBM_BPS
    t_f = flops / PEAK_FLOPS[dtype]
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


# ---------------------------------------------------------------------------
# phase 3: kernels vs plain versions at the main path's shapes
# ---------------------------------------------------------------------------
def chunk_inputs(rng, dev):
    """A 256 query rows x S 1024 keys, H 32 / Hkv 8 / D 128, C 16: two
    packed requests (segments 0 / 1, request-local positions), padding
    rows and slots (pos -1 / seg -1) as the executor lays them out."""
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
                k_seg=i(kseg), C=C)


def decode_inputs(rng, dev):
    """B 4 requests over an arena of S 1024 slots, H 32 / Hkv 8 / D 128;
    per-request lengths 1000 / 800 / 600 / 300, slots past them -1."""
    import numpy as np
    import torch
    B, S, H, Hkv, D = 4, 1024, 32, 8, 128
    lens = np.array([1000, 800, 600, 300])
    kpos = np.where(np.arange(S)[None] < lens[:, None],
                    np.arange(S)[None], -1).astype(np.int32)
    f = lambda *s: torch.from_numpy(  # noqa: E731
        rng.normal(size=s).astype(np.float32)).to(dev)
    return dict(q=f(B, H, D), k=f(B, S, Hkv, D), v=f(B, S, Hkv, D),
                q_pos=torch.from_numpy((lens - 1).astype(np.int32)).to(dev),
                k_pos=torch.from_numpy(kpos).to(dev))


def paged_inputs(rng, dev):
    """Pool of NB 512 blocks x bs 16 slots (H 32 / Hkv 8 / D 128), B 4
    requests with 64 / 50 / 30 / 10 blocks (-1 padded to NBmax 64),
    request 1 sharing request 0's first 10 blocks, each request's last
    block half empty and 5% dead interior slots (pos -1)."""
    import numpy as np
    import torch
    NB, bs, B, NBmax, H, Hkv, D = 512, 16, 4, 64, 32, 8, 128
    nblk = [64, 50, 30, 10]
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
                q_pos=torch.from_numpy(qpos).to(dev))


def check_kernels(dev):
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.chunk_attention import ops as cops
    from repro_torch.kernels.chunk_attention.ref import chunk_attention_ref
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.decode_attention.ref import (
        decode_attention_ref, paged_decode_attention_ref)

    rng = np.random.default_rng(0)
    rows = {}

    def cast(d, dt):
        return {n: (x.to(dt) if isinstance(x, torch.Tensor)
                    and x.is_floating_point() else x) for n, x in d.items()}

    def err(a, b):
        return float((a.float() - b.float()).abs().max())

    # ---- chunk attention ----
    ci = chunk_inputs(rng, dev)
    C = ci["C"]
    qp, kp = ci["q_pos"][0], ci["k_pos"][0]
    mask = (qp[:, None] >= kp[None]) & (qp[:, None] >= 0) & \
        (kp[None] >= 0) & (ci["q_seg"][0][:, None] == ci["k_seg"][0][None])
    n_pairs = int(mask.sum())
    A, H, D = ci["q"].shape[1:]
    S, Hkv = ci["k"].shape[1:3]
    res = {}
    for dt_name in ("float32", "bfloat16"):
        x = cast(ci, getattr(torch, dt_name))
        args = (x["q"], x["k"], x["v"], x["q_pos"], x["k_pos"], x["k_chunk"])
        kw = dict(q_seg=x["q_seg"], k_seg=x["k_seg"], num_chunks=C)
        o, m = cops.chunk_attention(*args, **kw)
        torch.cuda.synchronize()

        def plain():
            return chunk_attention_ref(
                x["q"][0], x["k"][0], x["v"][0], x["q_pos"][0],
                x["k_pos"][0], x["k_chunk"][0], num_chunks=C,
                q_seg=x["q_seg"][0], k_seg=x["k_seg"][0])
        orf, mrf = plain()
        e = max(err(o[0], orf), err(m[0], mrf))
        if not (e <= TOL[dt_name] and torch.isfinite(o).all()):
            raise RuntimeError(f"chunk_attention {dt_name}: max abs err "
                               f"{e} > {TOL[dt_name]}")
        qh = x["q"].transpose(1, 2)                    # [1, H, A, D]
        kh = x["k"].transpose(1, 2).contiguous()
        vh = x["v"].transpose(1, 2).contiguous()
        qh = qh.contiguous()
        t_k = cuda_ms(lambda: cops.chunk_attention(*args, **kw))
        t_p = cuda_ms(plain, iters=5)
        t_l = cuda_ms(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=mask, enable_gqa=True))
        el = x["q"].element_size()
        nbytes = (2 * A * H * D + 2 * S * Hkv * D) * el + \
            4 * (2 * A + 3 * S) + 4 * A * C
        b_ms, b_by = bound(nbytes, 4 * D * H * n_pairs, dt_name)
        res[dt_name] = dict(err=e, ms=t_k, plain_ms=t_p, library_ms=t_l,
                            bound_ms=b_ms, bound_by=b_by)
        log(f"kernel chunk_attention {dt_name} A={A} S={S} H={H} Hkv={Hkv} "
            f"D={D} C={C} pairs={n_pairs}: max_abs_err={e:.3e} "
            f"(tol {TOL[dt_name]}) ms={t_k:.4f} plain_ms={t_p:.4f} "
            f"library_ms={t_l:.4f} bound_ms={b_ms:.4f} ({b_by})")
    rows["chunk_attention"] = res

    # ---- decode attention ----
    di = decode_inputs(rng, dev)
    B, H, D = di["q"].shape
    S, Hkv = di["k"].shape[1:3]
    live = (di["k_pos"] >= 0) & (di["k_pos"] <= di["q_pos"][:, None])
    n_keys = int(live.sum())
    res = {}
    for dt_name in ("float32", "bfloat16"):
        x = cast(di, getattr(torch, dt_name))
        args = (x["q"], x["k"], x["v"], x["q_pos"], x["k_pos"])
        o = dops.decode_attention(*args)
        torch.cuda.synchronize()
        e = err(o, decode_attention_ref(*args))
        if not (e <= TOL[dt_name] and torch.isfinite(o).all()):
            raise RuntimeError(f"decode_attention {dt_name}: max abs err "
                               f"{e} > {TOL[dt_name]}")
        qh = x["q"][:, :, None]                          # [B, H, 1, D]
        kh = x["k"].transpose(1, 2).contiguous()
        vh = x["v"].transpose(1, 2).contiguous()
        lmask = live[:, None, None, :]
        t_k = cuda_ms(lambda: dops.decode_attention(*args))
        t_p = cuda_ms(lambda: decode_attention_ref(*args))
        t_l = cuda_ms(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=lmask, enable_gqa=True))
        el = x["q"].element_size()
        nbytes = (2 * B * H * D + 2 * n_keys * Hkv * D) * el + \
            4 * (B + B * S)
        b_ms, b_by = bound(nbytes, 4 * D * H * n_keys, dt_name)
        res[dt_name] = dict(err=e, ms=t_k, plain_ms=t_p, library_ms=t_l,
                            bound_ms=b_ms, bound_by=b_by)
        log(f"kernel decode_attention {dt_name} B={B} S={S} H={H} "
            f"Hkv={Hkv} D={D} live_keys={n_keys}: max_abs_err={e:.3e} "
            f"(tol {TOL[dt_name]}) ms={t_k:.4f} plain_ms={t_p:.4f} "
            f"library_ms={t_l:.4f} bound_ms={b_ms:.4f} ({b_by})")
    rows["decode_attention"] = res

    # ---- paged decode attention ----
    pi = paged_inputs(rng, dev)
    B, H, D = pi["q"].shape
    NB, bs, Hkv = pi["k_blocks"].shape[:3]
    brows = pi["block_rows"].long()
    safe = brows.clamp(min=0)
    gpos = pi["kpos_blocks"][safe].reshape(B, -1)
    gpos = torch.where((brows >= 0).repeat_interleave(bs, 1), gpos,
                       torch.full_like(gpos, -1))
    live = (gpos >= 0) & (gpos <= pi["q_pos"][:, None])
    n_keys = int(live.sum())
    ref_blocks = torch.unique(brows[brows >= 0])
    n_slots_needed = int(((pi["kpos_blocks"][ref_blocks] >= 0)).sum())
    res = {}
    for dt_name in ("float32", "bfloat16"):
        x = cast(pi, getattr(torch, dt_name))
        args = (x["q"], x["k_blocks"], x["v_blocks"], x["kpos_blocks"],
                x["block_rows"], x["q_pos"])
        o = dops.paged_decode_attention(*args)
        torch.cuda.synchronize()
        e = err(o, paged_decode_attention_ref(*args))
        if not (e <= TOL[dt_name] and torch.isfinite(o).all()):
            raise RuntimeError(f"paged_decode_attention {dt_name}: max abs "
                               f"err {e} > {TOL[dt_name]}")
        # yardstick: SDPA over the same keys gathered densely beforehand
        # (the gather itself is not timed)
        kg = x["k_blocks"][safe].reshape(B, -1, Hkv, D).transpose(1, 2) \
            .contiguous()
        vg = x["v_blocks"][safe].reshape(B, -1, Hkv, D).transpose(1, 2) \
            .contiguous()
        qh = x["q"][:, :, None]
        lmask = live[:, None, None, :]
        t_k = cuda_ms(lambda: dops.paged_decode_attention(*args))
        t_p = cuda_ms(lambda: paged_decode_attention_ref(*args))
        t_l = cuda_ms(lambda: F.scaled_dot_product_attention(
            qh, kg, vg, attn_mask=lmask, enable_gqa=True))
        el = x["q"].element_size()
        nbytes = (2 * B * H * D + 2 * n_slots_needed * Hkv * D) * el + \
            4 * (B + B * brows.shape[1] + int(ref_blocks.numel()) * bs)
        b_ms, b_by = bound(nbytes, 4 * D * H * n_keys, dt_name)
        res[dt_name] = dict(err=e, ms=t_k, plain_ms=t_p, library_ms=t_l,
                            bound_ms=b_ms, bound_by=b_by)
        log(f"kernel paged_decode_attention {dt_name} NB={NB} bs={bs} B={B} "
            f"NBmax={brows.shape[1]} live_keys={n_keys}: max_abs_err={e:.3e}"
            f" (tol {TOL[dt_name]}) ms={t_k:.4f} plain_ms={t_p:.4f} "
            f"library_ms={t_l:.4f} bound_ms={b_ms:.4f} ({b_by})")
    rows["paged_decode_attention"] = res
    return rows


# ---------------------------------------------------------------------------
# phases 4-6: the engine on full-width llama3-8b
# ---------------------------------------------------------------------------
def run_engine(tag, cfg, params, tmp, num_requests=12, max_new_tokens=8,
               **spec_kw):
    import numpy as np

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
    kb = KnowledgeBase(num_chunks=24, vocab_size=cfg.vocab_size, seed=0)
    reqs = generate(kb, WorkloadConfig(num_requests=num_requests, qpm=1e9,
                                       k_chunks=5,
                                       max_new_tokens=max_new_tokens))
    t0 = time.perf_counter()
    stats = eng.run(reqs)
    wall = time.perf_counter() - t0
    store.tiers.close()
    ttft = np.array([r.ttft for r in reqs if r.ttft is not None])
    dec_tokens = sum(len(r.output_tokens) for r in reqs) - stats.prefills
    out = dict(
        completed=stats.completed, failed=stats.failed,
        prefill_tokens_total=stats.prefill_tokens_total,
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
        paged_block_syncs=eng.counters.paged_block_syncs)
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


def compare_logits(tag, trace, tokens, ref_trace, ref_tokens):
    """Per-request decode logits of ``tag`` vs the dense engine, step by
    step: compared while the request's tokens agree; where greedy tokens
    diverge, the dense logits' top-2 gap at that step must be within
    tolerance (a near tie), and the request is not compared past it. A
    request whose first (prefill) token differs is not compared."""
    import numpy as np

    def per_rid(tr):
        out = {}
        for step in tr:
            for rid, lg in step.items():
                out.setdefault(rid, []).append(lg)
        return out

    mine, ref = per_rid(trace), per_rid(ref_trace)
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

    from repro_torch import device as devmod
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels.chunk_attention import ops as cops
    from repro_torch.kernels.decode_attention import ops as dops
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

    # phase 3: kernels vs plain versions
    krows = check_kernels(dev)

    # phases 4-6: engines on full-width llama3-8b
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
    launches = {}
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
        engines["A"], tr_a, tok_a, plan_a, c_a = run_engine(
            "A", cfg, params, tmp, attn_impl="kernel")
        launches["chunk_attention"] = cops.chunk_attention.launches
        launches["decode_attention"] = dops.decode_attention.launches
        if engines["A"]["prefill_tokens_computed"] >= \
                engines["A"]["prefill_tokens_total"]:
            raise RuntimeError("engine A: no chunk reuse happened")

        dops.paged_decode_attention.launches = 0
        engines["B"], tr_b, tok_b, _plan_b, c_b = run_engine(
            "B", cfg, params, tmp, attn_impl="paged_kernel",
            paged_decode=True)
        launches["paged_decode_attention"] = \
            dops.paged_decode_attention.launches
        if c_b.decode_gather_bytes != 0:
            raise RuntimeError("engine B gathered KV: "
                               f"{c_b.decode_gather_bytes} bytes")

        engines["C"], tr_c, tok_c, plan_c, _c = run_engine(
            "C", cfg, params, tmp, attn_impl="dense")
    log(f"launches on the main path: {json.dumps(launches)}")
    for name, n in launches.items():
        if n <= 0:
            raise RuntimeError(f"{name}: no launch on the main path")
    same_plans = sum(plan_a[r] == plan_c[r] for r in plan_a)
    log(f"plans A vs C (hits, computed tokens) identical for "
        f"{same_plans}/{len(plan_a)} requests")
    err_a = compare_logits("A(kernel)", tr_a, tok_a, tr_c, tok_c)
    err_b = compare_logits("B(paged_kernel)", tr_b, tok_b, tr_c, tok_c)

    # phase 7: the kernels line and the engine figures
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
    log(f"engines: " + json.dumps({
        k: {m: v[m] for m in ("ttft_mean_ms", "ttft_p99_ms",
                              "prefill_pass_ms", "decode_step_ms",
                              "decode_tokens_per_s", "wall_s")}
        for k, v in engines.items()}))
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
