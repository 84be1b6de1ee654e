"""The serving steps' collective bytes a device moves, in the dry-run's
closed form (``launch/dryrun.py`` ``cell_tp_bytes`` ->
``serving_collective_bytes``), for every arch and serving shape of the
reference's dry-run on both production meshes (256 and 512 chips), bf16
as the dry-run's cells. Closed forms only (meta shapes, no step run):
seconds on a CPU.

    PYTHONPATH=src python3 scripts/serving_tp_bytes.py [--arch A ...]

Prints one JSON line per (arch, shape, mesh): the bytes per kind, their
sum in GB, and that sum over the NVLink rate (``roofline.NVLINK_BW``).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.launch import dryrun as DR  # noqa: E402
from repro_torch.launch import roofline as RL  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.models.config import LONG_CONTEXT_ARCHS, SHAPES  # noqa


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", nargs="*", default=list(ARCHS))
    args = ap.parse_args()
    for arch in args.arch:
        cfg = get_config(arch).replace(dtype="bfloat16",
                                       param_dtype="bfloat16")
        for name, sp in SHAPES.items():
            if sp["kind"] == "train" or (name == "long_500k" and
                                         arch not in LONG_CONTEXT_ARCHS):
                continue
            for cc in (False, True):
                if cc and not (name == "prefill_32k" and
                               cfg.supports_chunk_cache):
                    continue
                for multi in (False, True):
                    mesh = DR.meta_mesh(make_production_mesh(
                        multi_pod=multi, device="cpu"))
                    b = DR.cell_tp_bytes(cfg, sp["kind"], sp["global_batch"],
                                         sp["seq_len"], mesh, cc=cc)
                    total = sum(b.values())
                    print(json.dumps(dict(
                        arch=arch, shape=name + ("_cc" if cc else ""),
                        chips=512 if multi else 256, bytes=b,
                        gb=total / 1e9, collective_s=total / RL.NVLINK_BW)),
                        flush=True)


if __name__ == "__main__":
    main()
