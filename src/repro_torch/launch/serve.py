"""Serving launcher of the port: batch replay or a live HTTP server.

Batch replay (default): generate a synthetic RAG workload, run it through
the engine with continuous batching, print per-request and aggregate
stats::

    python -m repro_torch.launch.serve --requests 24 --qpm 240
    python -m repro_torch.launch.serve --full --attn-impl kernel  # H100

Online serving (``--serve``): the engine on a background stepping thread
behind the stdlib HTTP API of ``serving/server.py`` (routes, threading
contract and ``ServeClient`` there)::

    python -m repro_torch.launch.serve --serve --full --attn-impl kernel \
        --port 8763
    curl -s localhost:8763/v1/submit -d '{"system_tokens": [1,2,3],
        "chunk_tokens": [[4,5,6],[7,8]], "question_tokens": [9,10],
        "max_new_tokens": 8}'                      # -> {"rid": 0}
    curl -sN localhost:8763/v1/stream/0            # NDJSON tokens
    curl -s localhost:8763/stats

Runs on the GPU unless ``--device cpu``. ``--full`` serves the full-size
config; the default is the tiny one. Weights are random from ``--seed``,
or the trained ones of ``--params <ckpt-dir>`` (a checkpoint of
``launch/train.py``; the latest step, from the same ``--arch`` and
``--full``)::

    python -m repro_torch.launch.train --tiny --steps 200 \
        --ckpt-dir results/train_ckpt
    python -m repro_torch.launch.serve --params results/train_ckpt
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
    ap.add_argument("--params", default=None,
                    help="checkpoint dir with trained params")
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
    ap.add_argument("--serve", action="store_true",
                    help="run the HTTP server instead of batch replay")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8763)
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
    if args.serve:
        from repro_torch.serving.server import CacheCraftServer
        srv = CacheCraftServer(eng, host=args.host, port=args.port).start()
        print(f"serving {args.arch}{'' if args.full else ' (tiny)'} "
              f"strategy={spec.strategy} on {eng.device} at {srv.url}")
        print("routes: POST /v1/submit | GET /v1/stream/<rid> | "
              "POST /v1/cancel/<rid> | GET /health | GET /stats")
        try:
            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            print("\nshutting down...")
            srv.shutdown()
        return None
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
