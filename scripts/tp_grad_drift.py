"""How far one sharded train step's grads lie from the unsharded step's.

A tiny config (``--arch``) at each depth of ``--layers``: one AdamW step
unsharded and one on each (data, model) shape of ``--meshes``, from the
same init on the same batch (tests/test_torch_tp_training.py's 8 x 32
tokens, accum 2, lr 1e-3, fp32, on the CPU). After one step ``m`` is
(1 - b1) times the step's grads, so per param leaf the worst
|m - m_unsharded| over the leaf's largest |m_unsharded| is the relative
error of its grads. A split block that computes the same function as the
whole one reorders fp32 sums only; how far that moves the grads depends
on how much the stack amplifies rounding, which grows with depth.

    PYTHONPATH=src python3 scripts/tp_grad_drift.py
    PYTHONPATH=src python3 scripts/tp_grad_drift.py --arch mamba2-370m \\
        --layers 1 2 4 --meshes 2x1 1x4

Prints one JSON line per (layers, mesh): the relative error per leaf, in
the order of ``tree_leaves``, and its largest.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), os.path.join(ROOT, "tests")]

import torch  # noqa: E402

import test_torch_tp_training as T  # noqa: E402
from repro_torch.configs import get_tiny  # noqa: E402
from repro_torch.launch.mesh import make_debug_mesh  # noqa: E402
from repro_torch.training import steps as TS  # noqa: E402
from repro_torch.training.optimizer import AdamWConfig, tree_leaves  # noqa


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-370m")
    ap.add_argument("--layers", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--meshes", nargs="+", default=["2x1", "1x4"])
    args = ap.parse_args()
    opt = AdamWConfig(**T.OPT)
    for n in args.layers:
        cfg = get_tiny(args.arch).replace(num_layers=n)
        b = T._batches(cfg, n=1)[0]
        ref, _ = TS.make_train_step(cfg, opt, T.ACCUM)(T._state(cfg), b)
        want = list(tree_leaves(ref.opt["m"]))
        for spec in args.meshes:
            shape = tuple(int(v) for v in spec.split("x"))
            shs = TS.train_shardings(cfg, make_debug_mesh(shape,
                                                          device="cpu"))
            step = TS.make_train_step(cfg, opt, T.ACCUM,
                                      grad_specs=shs["opt"]["m"])
            st, _ = step(TS.shard_state(T._state(cfg), shs), b)
            got = tree_leaves(TS.unshard_state(st).opt["m"])
            errs = [float((g - w).abs().max() / w.abs().max())
                    for g, w in zip(got, want, strict=True)]
            print(json.dumps({"arch": cfg.name, "layers": n,
                              "mesh": list(shape), "grad_rel_err": errs,
                              "worst": max(errs)}), flush=True)


if __name__ == "__main__":
    torch.set_num_threads(2)
    main()
