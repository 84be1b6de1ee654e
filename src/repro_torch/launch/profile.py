"""Where the serving time goes: run one batch-replay workload through the
port's engine under ``torch.profiler`` and print the device's busy share
and its device time by name and by class (the port's attention kernels,
matrix products, host<->device copies, everything else)::

    python -m repro_torch.launch.profile --full --attn-impl kernel
    python -m repro_torch.launch.profile --full --attn-impl paged_kernel \\
        --paged-decode

A short warm-up run of the same engine comes first (not profiled). The
profiled run is the ``chip_smoke.py`` workload: 12 requests arriving at
once, 5 chunks each, 8 new tokens. Needs a GPU unless ``--device cpu``
(then only host time is shown).
"""
from __future__ import annotations

import argparse
import json
import tempfile
import time

import torch

from repro_torch.serving.api import EngineSpec, StoreSpec, build_cfg, \
    build_engine, build_params, build_store
from repro_torch.serving.rag import KnowledgeBase
from repro_torch.serving.scheduler import SchedulerConfig
from repro_torch.serving.workload import WorkloadConfig, generate

_ATTENTION = ("chunk_attention", "mass_reduce", "decode_kernel")
_MATMUL = ("gemm", "gemv", "cutlass", "cublas", "matmul", "dot_kernel")


def _kernel_class(name: str) -> str:
    low = name.lower()
    if low.startswith("memcpy"):
        return "host<->device copies"
    if any(k in low for k in _ATTENTION):
        return "port attention kernels"
    if any(k in low for k in _MATMUL):
        return "matrix products"
    return "other device work"


def run(args) -> dict:
    spec = EngineSpec(arch=args.arch, tiny=not args.full, seed=args.seed,
                      strategy="cachecraft", attn_impl=args.attn_impl,
                      paged_decode=args.paged_decode,
                      pool_blocks=args.pool_blocks, device=args.device,
                      sched=SchedulerConfig(max_decode_batch=4))
    cfg = build_cfg(spec)
    params = build_params(spec, cfg)

    def one(tmp, tag, n, max_new):
        store = build_store(StoreSpec(ssd_dir=f"{tmp}/{tag}"))
        eng = build_engine(spec, cfg=cfg, params=params, store=store)
        kb = KnowledgeBase(num_chunks=24, vocab_size=cfg.vocab_size,
                           seed=0)
        reqs = generate(kb, WorkloadConfig(num_requests=n, qpm=1e9,
                                           k_chunks=5,
                                           max_new_tokens=max_new))
        return eng, store, reqs

    acts = [torch.profiler.ProfilerActivity.CPU]
    if eng_device_is_cuda(args.device):
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with tempfile.TemporaryDirectory(prefix="cc-profile-") as tmp:
        eng, store, reqs = one(tmp, "warm", 4, 2)
        eng.run(reqs)
        store.tiers.close()
        eng, store, reqs = one(tmp, "run", args.requests, args.max_new)
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            stats = eng.run(reqs)
            if eng_device_is_cuda(args.device):
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        store.tiers.close()

    by_name, by_class = {}, {}
    device_us = 0.0
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = float(ev.self_device_time_total)
        if us <= 0:
            continue
        device_us += us
        by_name[ev.key] = (by_name.get(ev.key, (0.0, 0))[0] + us,
                           by_name.get(ev.key, (0.0, 0))[1] + ev.count)
        c = _kernel_class(ev.key)
        by_class[c] = by_class.get(c, 0.0) + us
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:args.top]
    out = {
        "attn_impl": args.attn_impl, "paged_decode": args.paged_decode,
        "model": cfg.name, "device": str(eng.device),
        "kind": torch.cuda.get_device_name(0)
        if eng_device_is_cuda(args.device) else "cpu",
        "wall_s": wall, "completed": stats.completed,
        "prefill_compute_s": stats.prefill_compute_s,
        "decode_compute_s": stats.decode_compute_s,
        "device_kernel_s": device_us / 1e6,
        "device_busy_share": device_us / 1e6 / wall if wall else None,
        "by_class_s": {k: v / 1e6 for k, v in sorted(by_class.items())},
        "top_kernels": [{"name": n[:120], "s": us / 1e6, "count": c}
                        for n, (us, c) in top],
    }
    if args.trace:
        prof.export_chrome_trace(args.trace)
    return out


def eng_device_is_cuda(device: str) -> bool:
    return device.split(":")[0] == "cuda"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--full", action="store_true",
                    help="full-size config (default is the tiny one)")
    ap.add_argument("--attn-impl", default="kernel")
    ap.add_argument("--paged-decode", action="store_true")
    ap.add_argument("--pool-blocks", type=int, default=512)
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--trace", default=None,
                    help="write a chrome trace (json) to this path")
    out = run(ap.parse_args(argv))
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
