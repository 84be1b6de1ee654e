"""Serving launcher of the port, batch replay: generate a synthetic RAG
workload, run it through the engine with continuous batching, print
per-request and aggregate stats::

    python -m repro_torch.launch.serve --requests 24 --qpm 240
    python -m repro_torch.launch.serve --full --attn-impl kernel  # H100

Runs on the GPU unless ``--device cpu``. ``--full`` serves the full-size
config (random weights from ``--seed``); the default is the tiny one.
The HTTP front end (``--serve``) waits for the port of
``serving/server.py`` (ROADMAP A6).
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.serving.api import EngineSpec, build_engine
from repro_torch.serving.rag import KnowledgeBase
from repro_torch.serving.workload import TenantSpec, WorkloadConfig, \
    generate


def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--full", action="store_true",
                    help="full-size config (default is the tiny one)")
    from repro_torch.core.strategies import STRATEGIES
    ap.add_argument("--strategy", default="cachecraft",
                    choices=tuple(STRATEGIES),
                    help="recompute strategy (core.strategies registry): "
                         + ", ".join(STRATEGIES))
    ap.add_argument("--recompute", type=float, default=None)
    ap.add_argument("--no-focus", action="store_true")
    ap.add_argument("--attn-impl", default=None)
    ap.add_argument("--paged-decode", action="store_true")
    ap.add_argument("--layerwise-load", action="store_true")
    ap.add_argument("--pool-blocks", type=int, default=8192)
    ap.add_argument("--max-batch-tokens", type=int, default=8192)
    ap.add_argument("--max-decode-batch", type=int, default=4)
    ap.add_argument("--tier-dtypes", default=None,
                    help='per-tier storage codecs, e.g. "cpu=int8"')
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--qpm", type=float, default=240)
    ap.add_argument("--kb-chunks", type=int, default=24)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--turns", type=int, default=1,
                    help=">1: multi-turn sessions with growing history")
    ap.add_argument("--tenants", default=None,
                    help='mixed-tenant trace, e.g. "gold:3:2.0,free:1:8.0" '
                         "(name:weight:deadline_s)")
    return ap


def parse_tenants(s):
    if not s:
        return None
    out = []
    for part in s.split(","):
        name, weight, deadline = (part.split(":") + ["1", "0"])[:3]
        out.append(TenantSpec(name, float(weight), float(deadline)))
    return out


def main(argv=None):
    args = make_parser().parse_args(argv)
    spec = EngineSpec.from_args(args)
    eng = build_engine(spec)
    kb = KnowledgeBase(num_chunks=args.kb_chunks,
                       vocab_size=eng.cfg.vocab_size, seed=args.seed)
    reqs = generate(kb, WorkloadConfig(
        num_requests=args.requests, qpm=args.qpm, seed=args.seed,
        max_new_tokens=args.max_new, k_chunks=5, turns=args.turns,
        tenants=parse_tenants(args.tenants)))
    t0 = time.time()
    stats = eng.run(reqs)
    wall = time.time() - t0
    done = [r for r in reqs if r.e2e_latency is not None]
    print(f"\n== {spec.strategy} | {args.requests} reqs @ {args.qpm} QPM "
          f"on {eng.device} ==")
    print(f"completed {stats.completed} failed {stats.failed} "
          f"wall {wall:.1f}s simclock {stats.clock:.2f}s")
    print(f"prefill tokens: total {stats.prefill_tokens_total} "
          f"computed {stats.prefill_tokens_computed} "
          f"(saved {1 - stats.prefill_tokens_computed / max(1, stats.prefill_tokens_total):.1%})")
    if done:
        print(f"TTFT mean {np.mean([r.ttft for r in done])*1e3:.1f}ms "
              f"p99 {np.percentile([r.ttft for r in done], 99)*1e3:.1f}ms")
        print(f"e2e mean {np.mean([r.e2e_latency for r in done]):.3f}s  "
              f"throughput {len(done)/max(stats.clock, 1e-9):.2f} req/s")
    if eng.store:
        store = eng.store
        print(f"store: {store.num_variants()} variants over "
              f"{len(store.table)} chunks, evictions {store.evictions}, "
              f"tier hits {store.tiers.stats['hits']}")
    return stats


if __name__ == "__main__":
    main()
