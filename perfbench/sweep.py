"""The knee sweep of an open-loop cell: one engine, built and warmed
once, serves windows of the cell's traffic at rising rates; each window
prints its TTFT quantiles, the requests still queued when it closed and
how long the backlog took to drain; the engine is run idle between
windows. The knee is the highest rate whose
backlog does not grow; a cell's ``rate_per_s`` is written as a number at
about four fifths of it. Run on the card, not by the benchmark::

    python3 -m perfbench.sweep --workload ds67b-rag-reuse --seed 5 \\
        --seconds 30 --rates 0.5,1,1.5,2,2.5
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="knee sweep")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args(argv)
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    from perfbench import harness
    from perfbench.traffic import Trace
    t0 = time.perf_counter()
    _cell, m, traffic, tr, eng, _params, _dir = harness.build(
        args.workload, args.seed, args.seconds, "cuda")
    harness.warm_up(eng, tr, traffic)
    print(json.dumps({"setup_s": time.perf_counter() - t0}), flush=True)
    for i, rate in enumerate(float(r) for r in args.rates.split(",")):
        p = dict(traffic, rate_per_s=rate)
        # the warm-up's seed: the same chunks' tokens, so the store the
        # warm-up filled serves every window as it serves the cell's
        win = Trace(p, args.seed, m["vocab_size"], args.seconds)
        win.warmup = []
        run = harness.RunData(m, args.seconds)
        backlog = {}

        def close():
            backlog["queued"] = len(eng.scheduler.queue)
            backlog["decoding"] = len(eng.decoding)
            run.stats1 = eng.stats.stats_dict()

        harness.drive(eng, win, p, run, args.seconds,
                      {"open": lambda: None,
                       "start": lambda t: run.stats0.update(
                           eng.stats.stats_dict()), "close": close},
                      0, set())
        t_close = time.perf_counter()
        while eng.scheduler.queue or eng.decoding:     # the next window
            eng.step()                                 # starts idle
        eng.drain_tokens()
        tt = run.ttfts()
        print(json.dumps({
            "rate": rate, "attempted": len(tt),
            "ttft_p50_ms": 1e3 * harness.percentile(tt, 50),
            "ttft_p90_ms": 1e3 * harness.percentile(tt, 90),
            "queued_at_close": backlog.get("queued"),
            "drain_s": max(max(r.t_tokens[-1] for r in run.reqs.values()
                               if r.t_tokens) - run.window_end, 0.0),
            "idle_after_s": time.perf_counter() - t_close,
            "prefill_batches": run.delta("prefill_batches"),
            "computed_share": run.delta("prefill_tokens_computed") /
            max(1, run.delta("prefill_tokens_total"))}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
