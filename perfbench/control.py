"""The control of the correctness check: the reference put in the
program's place and computed one precision step below the
configuration's bfloat16 (float8 e4m3 inputs to every matrix product),
read on the same prompts and served tokens as the program's run.

For each seed it serves the cell's window as a benchmark run does and
judges it twice through the one comparison (``harness.judge``): the
program's outputs, and the control's (the tokens the float8 reference
puts first at each position, and the chunk KV it stores). It prints one
JSON line with both: the program has to come out correct and the control
not. The limits in ``cells/<workload>.json`` lie between the program's
largest readings and the control's smallest. Run on the card, not by the
benchmark's own runs::

    python3 -m perfbench.control --workload ds67b-rag-reuse \\
        --seeds 11,12,13 --seconds 12
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(cellname: str, seed: int, seconds: float, device: str = "cuda",
             overrides=None, fault=None) -> dict:
    from perfbench import harness
    sv = harness.serve(cellname, seed, seconds, False, device, overrides,
                       None, fault)
    out = {"seed": seed, "metrics": sv.line["metrics"]}
    for side, control in (("program", False), ("control", True)):
        line = harness.judge(sv, seed, device, control)
        out[side] = {"correct": line["correct"],
                     "checks": {k: c["value"]
                                for k, c in line["checks"].items()}}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="control readings")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=12.0)
    args = ap.parse_args(argv)
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    for seed in [int(s) for s in args.seeds.split(",")]:
        t = time.perf_counter()
        r = readings(args.workload, seed, args.seconds)
        r["seconds"] = time.perf_counter() - t
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
