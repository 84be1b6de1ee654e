"""mamba2-370m's tensor-parallel train step against the unsharded one in
float64 and in fp32, with the free-running sharded run reported beside the
gated comparisons.

chip_smoke.py's ``f64_check`` (phase 15) with ``free=True``: at full width
cut to ``--layers`` layers (all by default), 8 x 512 tokens, accum 2, the
phase's init and AdamW, on each (data, model) shape of ``--meshes``:

* fp32, then float64 (``Float64``): 3 unsharded steps; the sharded first
  step from the same init and one sharded step from the unsharded state
  before the last, each held against the unsharded step (the gate:
  ``F64_TOL``, ``F64_SCALE``);
* float64 only: the sharded run going on from its own state to the last
  step ("after 3 free"), reported: the steps feed rounding back through
  AdamW and the random layers.

    PYTHONPATH=src python3 scripts/f64_parity.py --device cuda
    PYTHONPATH=src python3 scripts/f64_parity.py --device cuda --layers 2 \\
        --meshes 2x4,2x1
    PYTHONPATH=src python3 scripts/f64_parity.py --device cpu --tiny

Prints the card's name and power limit (on the card) and one JSON line per
mesh (``f64_check``'s record); raises where a gate misses.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import chip_smoke as CS  # noqa: E402
from repro_torch import device as devmod  # noqa: E402
from repro_torch.configs import get_config, get_tiny  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--meshes", default="2x4")
    ap.add_argument("--tiny", action="store_true",
                    help="the tiny config at 32 tokens a row (a check of "
                    "the script)")
    args = ap.parse_args()
    dev = devmod.resolve(args.device)
    cfg = (get_tiny if args.tiny else get_config)("mamba2-370m")
    cfg = cfg.replace(num_layers=args.layers or cfg.num_layers)
    if args.tiny:
        CS.SHARD_SEQ = 32
    if dev.type == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip(), flush=True)
    CS.log = lambda *a: None
    for s in args.meshes.split(","):
        shape = tuple(int(x) for x in s.split("x"))
        print(json.dumps(CS.f64_check(cfg, dev, shape, free=True)),
              flush=True)
        CS._free()


if __name__ == "__main__":
    main()
