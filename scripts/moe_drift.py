"""Where the sharded MoE train step parts from the unsharded one.

granite-moe-1b-a400m at full width, cut to ``--layers`` layers, with the
setup of chip_smoke.py's phase 15 (8 x 512 tokens, accum 2, fp32, the
same init and batches), ``--steps`` AdamW steps on ``--device``:

* ``plain``: the unsharded step, the run every other is held against;
* ``control s``: the unsharded step from the init with each embedding
  element scaled by 1 + 2^-20 N(0, 1), the noise drawn with seed s, for
  s = 1 .. ``--controls`` (chip_smoke.py's ``MOE_CONTROL``, seed 1);
* ``sharded (d, m)``: ``make_train_step(..., grad_specs=...)`` on each
  (data, model) shape of ``--meshes`` from the same init;
* ``one-step (d, m)`` (``--one-step``): before each step t, one sharded
  step from the plain run's state, held against the plain run's step t:
  the same function from the same state, so that only the order of the
  fp32 sums differs;
* ``replayed (d, m)`` (``--replay``): the sharded run on each shape of
  ``--meshes`` handed the plain run's expert ids of each step
  (chip_smoke.py's ``Routes.hand``, gates from its own probs), so that
  the routing is the plain run's; also its router probs' worst gap to
  the plain run's per step.

For every run and step: the loss, its gap to the plain run's relative to
it, and the routing flips, the tokens (summed over layers and
microbatches) whose set of top-k experts differs from the plain run's in
the same step, read from the forward pass (the recomputation in the
backward pass is not read). For every run at its end, and for a one-step
run after each step: per state (params, ``m``, ``v``) the worst gap and
the elements outside PARAM_TOL; for a one-step run also the worst leaf's
relative error of the step's grads, ||m - m'|| / ||m' - b1 m_prev||.

    PYTHONPATH=src python3 scripts/moe_drift.py --device cuda --controls 6
    PYTHONPATH=src python3 scripts/moe_drift.py --device cuda --layers 24 \\
        --controls 3 --no-one-step
    PYTHONPATH=src python3 scripts/moe_drift.py --device cpu --controls 3
    PYTHONPATH=src python3 scripts/moe_drift.py --device cpu --tiny
    PYTHONPATH=src python3 scripts/moe_drift.py --device cuda --layers 24 \\
        --controls 0 --no-one-step --replay

Prints one JSON line per run (the card's name and power limit first, on
the card) and, with ``--out``, writes them to that file too.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import torch  # noqa: E402

import chip_smoke as CS  # noqa: E402
from repro_torch import device as devmod  # noqa: E402
from repro_torch.configs import get_config, get_tiny  # noqa: E402
from repro_torch.distributed import sharding as SH  # noqa: E402
from repro_torch.launch.mesh import make_debug_mesh  # noqa: E402
from repro_torch.training import steps as TS  # noqa: E402
from repro_torch.training.optimizer import (AdamWConfig,  # noqa: E402
                                            tree_leaves)


def trainable(snap):
    """A fresh unsharded state from a snapshot, its params requiring
    grad."""
    st = CS._snapshot(snap)
    for x in tree_leaves(st.params):
        x.requires_grad_(True)
    return st


def leaves(state):
    """(params, m, v) leaf lists of an unsharded or a sharded state."""
    def un(x):
        return SH.unshard(x) if isinstance(x, SH.ShardedTensor) else x
    return {k: [un(x).detach() for x in tree_leaves(t)] for k, t in
            (("params", state.params), ("m", state.opt["m"]),
             ("v", state.opt["v"]))}


def gaps(got, want):
    """Per state: the worst gap and the elements outside PARAM_TOL."""
    out = {}
    for k in ("params", "m", "v"):
        worst, outside = 0.0, 0
        for g, w in zip(got[k], want[k], strict=True):
            worst = max(worst, float((g - w).abs().max()))
            outside += int((~torch.isclose(g, w, **CS.PARAM_TOL)).sum())
        out[k] = dict(worst_abs=worst, outside=outside)
    return out


def grad_rel_err(got_m, want_m, prev_m, b1, names):
    """The worst leaf's ||m - m'|| / ||m' - b1 m_prev|| (the step's grads'
    relative error, clipping included) and its name."""
    worst, name = 0.0, None
    for n, g, w, p in zip(names, got_m, want_m, prev_m, strict=True):
        den = float(torch.linalg.vector_norm(w - b1 * p))
        if den == 0.0:
            continue
        r = float(torch.linalg.vector_norm(g - w)) / den
        if r > worst:
            worst, name = r, n
    return worst, name


def perturb(state, noise, seed, dev):
    e = state.params["embed"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    with torch.no_grad():
        e.mul_(1 + noise * torch.randn(e.shape, generator=gen,
                                       device=e.device))


def run(cfg, dev, routes, steps, shape=None, noise=0.0, seed=1,
        snaps=None, replay=None, taken=None):
    """``steps`` steps from the phase's init: (losses, per-step routing,
    final state); unsharded without ``shape``, the init perturbed where
    ``noise``; ``snaps``, a list, gets the unsharded state before each
    step and after the last; ``replay``, another run's ``take_all`` per
    step, is handed to the steps (``Routes.hand``); ``taken``, a list,
    gets each step's ``take_all``."""
    state, opt, batch = CS._shard_setup(cfg, dev)
    if noise:
        perturb(state, noise, seed, dev)
    dp = 1
    if shape is None:
        step = TS.make_train_step(cfg, opt, accum=CS.TRAIN_ACCUM)
    else:
        shs = TS.train_shardings(cfg, make_debug_mesh(shape, device=dev))
        state = TS.shard_state(state, shs)
        step = TS.make_train_step(cfg, opt, accum=CS.TRAIN_ACCUM,
                                  grad_specs=shs["opt"]["m"])
        dp = shape[0]
    losses, ids = [], []
    routes.reset()
    for t in range(steps):
        if snaps is not None:
            snaps.append(CS._snapshot(state))
        if replay is not None:
            routes.hand(replay[t]["order"], dp)
        state, m = step(state, batch(t))
        losses.append(float(m["loss"]))
        got = routes.take_all(dp)
        ids.append(got["ids"])
        if taken is not None:
            taken.append(got)
    if snaps is not None:
        snaps.append(CS._snapshot(state))
    return losses, ids, state


def one_step(cfg, dev, routes, shape, snaps, t):
    """One sharded step from ``snaps[t]`` on batch t: (loss, routing,
    leaves after it)."""
    _, opt, batch = CS._shard_setup(cfg, dev)
    shs = TS.train_shardings(cfg, make_debug_mesh(shape, device=dev))
    state = TS.shard_state(trainable(snaps[t]), shs)
    step = TS.make_train_step(cfg, opt, accum=CS.TRAIN_ACCUM,
                              grad_specs=shs["opt"]["m"])
    routes.reset()
    state, m = step(state, batch(t))
    return float(m["loss"]), routes.take(shape[0]), leaves(state)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--steps", type=int, default=CS.SHARD_STEPS)
    ap.add_argument("--controls", type=int, default=6)
    ap.add_argument("--meshes", default="4x1,2x2")
    ap.add_argument("--no-one-step", dest="one_step", action="store_false")
    ap.add_argument("--replay", action="store_true",
                    help="also the sharded runs replaying the plain run's "
                    "expert ids")
    ap.add_argument("--tiny", action="store_true",
                    help="the tiny config (a check of the script)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    dev = devmod.resolve(args.device)
    cfg = (get_tiny if args.tiny else get_config)(
        "granite-moe-1b-a400m").replace(num_layers=args.layers)
    meshes = [tuple(int(x) for x in s.split("x"))
              for s in args.meshes.split(",")]
    recs = []

    def emit(rec):
        recs.append(rec)
        print(json.dumps(rec), flush=True)

    if dev.type == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
        emit(dict(card=card))
    routes = CS.Routes()
    b1 = AdamWConfig().b1
    snaps = [] if args.one_step else None
    taken = []
    base_l, base_ids, base = run(cfg, dev, routes, args.steps, snaps=snaps,
                                 taken=taken)
    want = leaves(base)
    names = CS._leaf_names(base.params)
    del base
    emit(dict(run="plain", model=f"{cfg.name}/{cfg.num_layers}",
              device=str(dev), losses=base_l))

    def versus(name, losses, ids, state, **more):
        emit(dict(run=name, losses=losses,
                  loss_rel_gap=[abs(a - b) / abs(b)
                                for a, b in zip(losses, base_l)],
                  flips=[CS.flips(a, b) for a, b in zip(ids, base_ids)],
                  end=gaps(leaves(state), want), **more))

    for s in range(1, args.controls + 1):
        versus(f"control {s}", *run(cfg, dev, routes, args.steps,
                                    noise=CS.MOE_CONTROL, seed=s))
        CS._free()
    for shape in meshes:
        versus(f"sharded {shape}", *run(cfg, dev, routes, args.steps,
                                        shape=shape))
        CS._free()
    for shape in meshes if args.replay else ():
        got = []
        res = run(cfg, dev, routes, args.steps, shape=shape, replay=taken,
                  taken=got)
        versus(f"replayed {shape}", *res, probs_worst_abs=[
            max(float((a - b).abs().max()) for ma, mb in zip(
                g["probs"], w["probs"]) for a, b in zip(ma, mb))
            for g, w in zip(got, taken)])
        del res
        CS._free()
    if args.one_step:
        plain = [leaves(s) for s in snaps]
        for shape in meshes:
            per = []
            for t in range(args.steps):
                loss, ids, got = one_step(cfg, dev, routes, shape, snaps, t)
                err, leaf = grad_rel_err(got["m"], plain[t + 1]["m"],
                                         plain[t]["m"], b1, names)
                per.append(dict(step=t + 1, loss_rel_gap=abs(
                    loss - base_l[t]) / abs(base_l[t]),
                    flips=CS.flips(ids, base_ids[t]),
                    grad_rel_err=err, grad_rel_err_leaf=leaf,
                    after=gaps(got, plain[t + 1])))
                CS._free()
            emit(dict(run=f"one-step {shape}", steps=per))
    if args.out:
        with open(args.out, "w") as f:
            for r in recs:
                f.write(json.dumps(r) + "\n")


if __name__ == "__main__":
    main()
