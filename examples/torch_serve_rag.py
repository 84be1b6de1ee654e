"""End-to-end driver of ``examples/serve_rag.py`` on the PyTorch port:
serve a RAG workload with continuous batching.

Compares Cache-Craft against full recomputation on the same trace:
throughput, TTFT, and prefill-token savings.

Run on the GPU:  python examples/torch_serve_rag.py [--requests 16]
Run on the host: python examples/torch_serve_rag.py --device cpu

``run(cfg, params, device, requests, qpm)`` does the work on given
weights and returns the printed figures as a dict, by strategy.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np                                             # noqa
import torch                                                   # noqa

from repro_torch import device as devmod                       # noqa
from repro_torch.configs import get_tiny                       # noqa
from repro_torch.models import model as M                      # noqa
from repro_torch.serving.api import EngineSpec, build_engine   # noqa
from repro_torch.serving.rag import KnowledgeBase              # noqa
from repro_torch.serving.scheduler import SchedulerConfig      # noqa
from repro_torch.serving.workload import WorkloadConfig, generate  # noqa

STRATEGIES = (("full-recompute", "all"), ("cache-craft", "cachecraft"))


def run(cfg, params, device, requests: int = 16, qpm: float = 600) -> dict:
    """Both engines on ``params`` (on ``device``), one after the other:
    prints their lines and returns, by strategy name, completed requests,
    the engine clock, throughput, mean TTFT and prefill tokens computed
    and total."""
    device = devmod.resolve(device)
    kb = KnowledgeBase(num_chunks=24, vocab_size=cfg.vocab_size, seed=0)
    out = {}
    for name, strategy in STRATEGIES:
        eng = build_engine(
            EngineSpec(strategy=strategy, pool_blocks=4096,
                       sched=SchedulerConfig(max_batch_tokens=4096,
                                             max_decode_batch=4),
                       device=str(device)),
            cfg=cfg, params=params)
        try:
            # warm caches (and the chunk store) before the timed trace, as
            # any serving deployment would
            warm = generate(kb, WorkloadConfig(num_requests=4, qpm=1e9,
                                               seed=9, max_new_tokens=8))
            eng.run(warm)
            eng.clock = 0.0
            eng.stats = type(eng.stats)()
            reqs = generate(kb, WorkloadConfig(num_requests=requests,
                                               qpm=qpm, seed=1,
                                               max_new_tokens=8))
            stats = eng.run(reqs)
        finally:
            if eng.store is not None:
                eng.store.tiers.close()
        done = [r for r in reqs if r.ttft is not None]
        ttft_ms = float(np.mean([r.ttft for r in done]) * 1e3)
        rps = stats.completed / max(stats.clock, 1e-9)
        saved = 1 - stats.prefill_tokens_computed / max(
            1, stats.prefill_tokens_total)
        print(f"\n== {name} ==")
        print(f"completed {stats.completed}, sim-clock {stats.clock:.2f}s, "
              f"throughput {rps:.2f} rps")
        print(f"mean TTFT {ttft_ms:.0f} ms | "
              f"prefill tokens computed "
              f"{stats.prefill_tokens_computed}/"
              f"{stats.prefill_tokens_total} "
              f"({saved:.0%} saved)")
        out[name] = dict(
            completed=stats.completed, failed=stats.failed,
            requests=len(reqs), clock_s=float(stats.clock),
            throughput_rps=float(rps), ttft_mean_ms=ttft_ms,
            prefill_tokens_computed=stats.prefill_tokens_computed,
            prefill_tokens_total=stats.prefill_tokens_total,
            saved=float(saved))
        del eng
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--qpm", type=float, default=600)
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    args = ap.parse_args(argv)
    dev = devmod.resolve(args.device)
    cfg = get_tiny("llama3-8b")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    run(cfg, M.init_params(cfg, gen), dev, args.requests, args.qpm)


if __name__ == "__main__":
    main()
