"""Multi-pod dry-run on the meta device: every (arch x shape x mesh) cell
of the reference's dry-run (``repro/launch/dryrun.py``), accounted for
the NVIDIA H100.

The reference lowers and compiles each cell for 256 or 512 fake XLA
devices and reads XLA's memory analysis and post-SPMD HLO. The port
builds the same cell, in bf16 and at full width, on ``torch.device
("meta")``, which holds shapes and dtypes and no data, so no memory is
allocated and no device is touched (nothing here sets ``XLA_FLAGS`` or
initialises CUDA). For each cell it records:

* **memory** per device, summed exactly from ``sharding.shard_bytes``
  over the arguments and outputs laid out as the reference lays them
  out on ``make_production_mesh`` (params by the rules, ZeRO-1 moments,
  the batch over the data axes, caches by ``cache_shardings``). This is
  the counterpart of ``memory_analysis()``'s argument and output sizes.
  XLA's temporary buffers have no counterpart: ``temp_gib`` is null.
  ``alias_gib`` is what the port updates in place (the train state, the
  caches), and ``fits_80gb`` says whether arguments plus the outputs not
  updated in place fit in the card's 80 GB;
* **compute**: ``roofline.count_step`` over the unsharded full-width
  step, the FLOPs of an even split over the chips (``flops_device``),
  beside the reference's analytic cross-check. PyTorch runs meta
  operators through Python decompositions (~0.3 s a layer and
  microbatch of llama3-8b's train cell), so ``count_cell`` runs the step
  at none and at one of the config's layer groups and one microbatch,
  and scales: the groups are identical and the microbatches have one
  shape, so the count is linear in both and the result exact;
* **collectives**: for the data axes, the ZeRO-1 train step's grad
  reduce-scatter, param all-gather and the all-reduces of what no
  dimension splits, in closed form (``zero1_collective_bytes``); and the
  tensor-parallel step's collectives over "model" (with the MoE aux
  term's and dispatch's over the data axes), in closed form too
  (``tp_collective_bytes``). Together they are the bytes
  ``distributed/collectives.py`` counts when the step runs. A serving
  cell reports its step's on the serving layout
  (``serving_collective_bytes``: the split blocks' sums, the ``"gather"``
  leaves, the cache put together for attention where its blocks split
  what a shard reads, the vocab-split logits), which the roofline counts
  as it counts a train cell's;
* **roofline** terms with the H100 constants (``launch/roofline.py``).

The steps take the routes that reach no CUDA kernel, as the reference's
``auto`` / ``flash`` cells reach no Pallas kernel: attention ``auto`` or
``flash``, and mamba2's SSD intra-chunk term through its tensor-op route
(the kernel wrappers take only ``cpu`` and ``cuda`` tensors).

    python -m repro_torch.launch.dryrun --arch llama3-8b --shape decode_32k
    python -m repro_torch.launch.dryrun --all --out results/dryrun
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.sharding import P, NamedSharding
from repro_torch.launch import roofline as RL
from repro_torch.launch.mesh import (Mesh, data_axes, dp_size,
                                     make_production_mesh)
from repro_torch.models import backend as AB
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models.config import LONG_CONTEXT_ARCHS, SHAPES
from repro_torch.training.optimizer import (AdamWConfig, adamw_init,
                                            tree_leaves, tree_map2)
from repro_torch.training.steps import (TrainState,
                                        make_cachecraft_prefill_step,
                                        make_decode_step, make_prefill_step,
                                        make_train_step, train_shardings)

META = torch.device("meta")
CC_ACTIVE_FRAC = 0.35       # 30% chunk recompute + question tokens
TRAIN_ACCUM = 8
GIB = 2 ** 30


def _cc_tokens(S: int) -> int:
    """The active tokens of a Cache-Craft partial prefill of S."""
    return int(np.ceil(CC_ACTIVE_FRAC * S / 128) * 128)


def meta_mesh(mesh: Mesh) -> Mesh:
    """``mesh``'s layout with every position on the meta device."""
    return Mesh(np.full(mesh.devices.shape, META, dtype=object),
                mesh.axis_names)


def _batch_axis(mesh, B: int):
    dax = data_axes(mesh)
    dp = dp_size(mesh)
    if B % dp == 0:
        return dax if len(dax) > 1 else dax[0]
    # try pod-only or data-only subsets
    for sub in (("data",), ("pod",)):
        axes = tuple(a for a in sub if a in mesh.axis_names)
        if axes:
            n = int(np.prod([mesh.shape[a] for a in axes]))
            if B % n == 0:
                return axes if len(axes) > 1 else axes[0]
    return None


def cache_shardings(cfg, mesh, cache_shape, B: int,
                    seq_axis: Optional[str] = None,
                    kind: str = "prefill"):
    msz = mesh.shape["model"]
    b_ax = _batch_axis(mesh, B)
    if cfg.num_kv_heads % msz == 0:
        h_ax, d_ax = "model", None
    elif kind == "decode" and seq_axis is None:
        # flash-decode sequence sharding: softmax/output reductions over
        # the model axis are tiny vs per-tile score all-reduces from
        # contraction(D)-sharded KV
        h_ax, d_ax, seq_axis = None, None, "model"
    elif cfg.head_dim_ % msz == 0:
        h_ax, d_ax = None, "model"
    else:
        h_ax = d_ax = None
    rnn_ax = "model" if cfg.rnn_width_ % msz == 0 else None
    di_ax = "model" if cfg.d_inner % msz == 0 else None
    ssm_ax = "model" if cfg.ssm_heads % msz == 0 else None

    def leaf_spec(name: str, rank: int) -> P:
        if name in ("k", "v"):
            base = [b_ax, seq_axis, h_ax, d_ax]
        elif name in ("mk", "mv"):
            base = [b_ax, None, h_ax, d_ax]
        elif name == "pos":
            base = [b_ax, seq_axis]
        elif name == "h":
            base = [b_ax, rnn_ax]
        elif name == "conv":
            base = [b_ax, None, di_ax]
        elif name == "s":
            base = [b_ax, ssm_ax, None, None]
        else:
            base = [None] * rank
        if rank == len(base) + 1:       # group-stacked leaf
            base = [None] + base
        return P(*base)

    def walk(tree):
        if isinstance(tree, dict) and all(
                not isinstance(v, (dict, list)) for v in tree.values()):
            return {k: NamedSharding(mesh, leaf_spec(k, v.ndim))
                    for k, v in tree.items()}
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v) for v in tree]
        return NamedSharding(mesh, P())

    return walk(cache_shape)


def _meta_state(cfg) -> TrainState:
    params = M.init_params(cfg, torch.Generator(), device=META)
    for x in tree_leaves(params):
        x.requires_grad_(True)
    return TrainState(step=torch.zeros((), dtype=torch.int32, device=META),
                      params=params, opt=adamw_init(params))


def build_cell_for(cfg, kind: str, B: int, S: int, mesh, *,
                   seq_shard: bool = False, accum: int = TRAIN_ACCUM,
                   cc: bool = False, attn: str = "auto"):
    """The step of one cell on meta tensors. Returns (fn, args,
    shardings of args, meta): ``fn(*args)`` runs the unsharded step;
    ``shardings`` mirrors ``args`` with a ``NamedSharding`` per leaf."""
    rules = SH.make_rules(mesh, cfg, seq_shard=seq_shard,
                          batch_shard=_batch_axis(mesh, B) is not None)
    dtype = M.torch_dtype(cfg.dtype)
    b_ax = _batch_axis(mesh, B)
    bsh = NamedSharding(mesh, P(b_ax) if b_ax else P())
    meta = dict(cfg=cfg, rules=rules, B=B, S=S, kind=kind)

    def tokens(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=META)

    media, media_sh = {}, {}
    if cfg.num_media_tokens:
        media["media"] = torch.zeros((B, cfg.num_media_tokens, cfg.d_model),
                                     dtype=dtype, device=META)
        media_sh["media"] = bsh
    if kind == "train":
        state = _meta_state(cfg)
        shs = train_shardings(cfg, mesh)
        batch = {"labels": tokens(B, S), **media}
        batch_sh = {"labels": bsh, **media_sh}
        if cfg.input_mode == "embeds":
            batch["embeds"] = torch.zeros((B, S, cfg.d_model), dtype=dtype,
                                          device=META)
        else:
            batch["tokens"] = tokens(B, S)
        batch_sh["embeds" if cfg.input_mode == "embeds" else "tokens"] = bsh
        fn = make_train_step(cfg, AdamWConfig(), accum=accum)
        state_sh = TrainState(step=shs["step"], params=shs["params"],
                              opt=shs["opt"])
        meta.update(accum=accum, grad_specs=shs["opt"]["m"])
        return fn, (state, batch), (state_sh, batch_sh), meta
    params = M.init_params(cfg, torch.Generator(), device=META)
    with SH.axis_rules(rules):
        pspecs = SH.spec_tree(M.param_axes(cfg))
    psh = tree_map2(lambda x, sp: NamedSharding(mesh, sp), params, pspecs)
    impl = attn if attn != "auto" else ("flash" if S > 8192 else "auto")
    if kind == "prefill":
        cache = M.init_cache(cfg, B, S, dtype=cfg.dtype, device=META,
                             ring=not cc)
        csh = cache_shardings(cfg, mesh, cache, B)
        if cc:
            if not cfg.supports_chunk_cache:
                raise ValueError("cc-prefill inapplicable")
            A = _cc_tokens(S)
            batch = {"tokens": tokens(B, A), "positions": tokens(B, A),
                     "cache": cache, **media}
            batch_sh = {"tokens": bsh, "positions": bsh, "cache": csh,
                        **media_sh}
            meta["active_frac"] = A / S
            fn = make_cachecraft_prefill_step(cfg, attn_impl=impl)
            return fn, (params, batch), (psh, batch_sh), meta
        batch = {"cache": cache, **media}
        batch_sh = {"cache": csh, **media_sh}
        if cfg.input_mode == "embeds":
            batch["embeds"] = torch.zeros((B, S, cfg.d_model), dtype=dtype,
                                          device=META)
            batch_sh["embeds"] = bsh
        else:
            batch["tokens"] = tokens(B, S)
            batch_sh["tokens"] = bsh
        fn = make_prefill_step(cfg, attn_impl=impl)
        return fn, (params, batch), (psh, batch_sh), meta
    # decode
    seq_axis = None
    if b_ax is None and S % dp_size(mesh) == 0 and \
            not cfg.is_attention_free:
        seq_axis = "data"       # flash-decode seq parallelism (B=1)
    cache = M.init_cache(cfg, B, S, dtype=cfg.dtype, device=META, ring=True)
    csh = cache_shardings(cfg, mesh, cache, B, seq_axis=seq_axis,
                          kind="decode")
    batch = {"tokens": tokens(B), "positions": tokens(B), "cache": cache}
    batch_sh = {"tokens": bsh, "positions": bsh, "cache": csh}
    meta["seq_axis"] = seq_axis
    return make_decode_step(cfg), (params, batch), (psh, batch_sh), meta


def _tree_pairs(tree, shardings):
    """(leaf, sharding) pairs of a tree of tensors (a ``TrainState`` or
    dicts / lists) and the matching tree of ``NamedSharding``."""
    if isinstance(tree, TrainState):
        tree = {"step": tree.step, "params": tree.params, "opt": tree.opt}
        shardings = {"step": shardings.step, "params": shardings.params,
                     "opt": shardings.opt}
    if isinstance(tree, (tuple, list)) and not isinstance(tree, P):
        for t, s in zip(tree, shardings):
            yield from _tree_pairs(t, s)
    elif isinstance(tree, dict):
        for k in tree:
            yield from _tree_pairs(tree[k], shardings[k])
    else:
        yield tree, shardings


def device_bytes(tree, shardings) -> int:
    """Bytes one device holds of ``tree`` laid out by ``shardings``."""
    return sum(SH.shard_bytes(x.shape, x.dtype, s)
               for x, s in _tree_pairs(tree, shardings))


def zero1_collective_bytes(cfg, mesh, accum: int) -> Dict[str, int]:
    """Per-device bytes of the data-parallel ZeRO-1 train step's
    collectives over the data axes, in closed form. Per microbatch: each
    grad leaf reduce-scattered (its fp32 ZeRO-1 block), or all-reduced
    where its ZeRO-1 spec splits no dimension over the data axes, and the
    loss (one fp32 scalar) all-reduced. Per step: the global grad norm's
    sum of squares (one fp32 scalar) all-reduced, and every data-split
    param leaf all-gathered (the param's block under its param spec).
    These are the bytes ``distributed/collectives.py`` counts when
    ``make_train_step(..., grad_specs=...)`` runs on ``mesh``."""
    params = M.init_params(cfg, torch.Generator(), device=META)
    shs = train_shardings(cfg, mesh)
    dax = data_axes(mesh)
    rs = ar = ag = 0
    for x, g, p in zip(tree_leaves(params), tree_leaves(shs["opt"]["m"]),
                       tree_leaves(shs["params"])):
        if SH.data_dim(g.spec, dax) is None:
            ar += SH.shard_bytes(x.shape, torch.float32, g)
        else:
            rs += SH.shard_bytes(x.shape, torch.float32, g)
            ag += SH.shard_bytes(x.shape, x.dtype, p)
    return {"reduce-scatter": rs * accum, "all-gather": ag,
            "all-reduce": (ar + 4) * accum + 4}


def _elsize(name) -> int:
    return torch.empty((), dtype=M.torch_dtype(name)).element_size()


def tp_collective_bytes(cfg, mesh, accum: int, batch: int, seq: int,
                        train: bool = True,
                        dp: Optional[int] = None) -> Dict[str, int]:
    """Per-device bytes of the train step's collectives beyond ZeRO-1's,
    in closed form, for ``batch`` x ``seq`` tokens in ``accum``
    microbatches, following ``sharding.tp_plan``. With T = a data shard's
    tokens of a microbatch and ``dt`` the compute dtype's bytes, per
    microbatch over "model": each ``"gather"`` leaf of a layer
    all-gathered (its whole per-layer tensor); a split attention layer's
    output summed (T d dt) and, in the backward, the grads of its input
    copies summed (T d dt; with its kv heads not split, also those of k
    and v, T_kv Hkv D dt each); a split SwiGLU the same (T d dt forward,
    T d dt backward); a split RG-LRU block the same (T d dt forward, its
    input's copies T d dt backward); a split SSD block its output (T d
    dt) and its gated norm's statistic (T 4) forward, and the grads of
    the in-projection's copies (T in_w dt, in_w = 2 d_inner + 2 N + H)
    and of the statistic (T 4) backward; split experts their fp32
    combine (T d 4) forward, the grads of their tokens (T d dt) and
    gates (T k 4) backward; the vocab-split embedding's rows (T d dt)
    and loss (three [T] fp32 all-reduces forward, the normed input's
    grad T d dt backward). Under remat a group layer's forward
    collectives count twice. Over the data
    axes, for a config with experts: per microbatch the aux term's
    ``fe`` and ``me`` ([2, layers, E] fp32) all-reduced, and per MoE
    layer, where the shards cut a GShard group, the expert ids of the
    microbatch (int32 [dp T, k]) all-gathered.

    ``train=False`` gives a serving cell's forward under the same plan
    (``batch`` x ``seq`` tokens over ``dp`` data shards, by default the
    mesh's): no backward, no remat, no loss, no aux term, the logits left
    split by vocab."""
    nm = mesh.shape.get("model", 1)
    dp = dp_size(mesh) if dp is None else dp
    T = batch // accum // dp * seq
    dt, pb, d = _elsize(cfg.dtype), _elsize(cfg.param_dtype), cfg.d_model
    plan = SH.tp_plan(mesh, cfg, M.param_axes(cfg))
    shapes = M.init_params(cfg, torch.Generator(), device=META)
    kinds = cfg.layer_kinds
    layers = [(kinds[g * len(cfg.pattern) + i], plan["groups"][i],
               {n: x.shape[1:] for n, x in shapes["groups"][i].items()},
               cfg.remat) for g in range(cfg.n_groups)
              for i in range(len(cfg.pattern))]
    layers += [(kinds[cfg.n_groups * len(cfg.pattern) + i], plan["tail"][i],
                {n: x.shape for n, x in shapes["tail"][i].items()}, False)
               for i in range(cfg.n_tail)]
    bw = 1 if train else 0              # the backward's collectives
    ag = ar = 0
    if nm > 1:
        if cfg.input_mode != "embeds":
            ar += T * d * dt
        ar += bw * (T * d * dt + 3 * T * 4)
        for kind, routes, shp, remat in layers:
            rf = 2 if remat and train else 1
            split = {n for n, r in routes.items()
                     if r is not None and r.route == "split"}
            ag += rf * sum(int(np.prod(shp[n])) * pb
                           for n, r in routes.items()
                           if r is not None and r.route == "gather")
            if "wq" in split:
                ar += rf * T * d * dt + bw * T * d * dt
                if "wk" not in split:
                    t_kv = (T // seq * cfg.num_media_tokens
                            if kind == "xattn" else T)
                    ar += bw * 2 * t_kv * cfg.num_kv_heads * \
                        cfg.head_dim_ * dt
            for n in ("wi", "wx"):      # the SwiGLU, the RG-LRU block
                if n in split:
                    ar += rf * T * d * dt + bw * T * d * dt
            if "out_proj" in split:
                in_w = 2 * cfg.d_inner + 2 * cfg.ssm_state + cfg.ssm_heads
                ar += rf * (T * d * dt + T * 4) + bw * (T * in_w * dt +
                                                        T * 4)
            if "wi_e" in split:
                ar += rf * T * d * 4 + bw * (T * d * dt +
                                              T * cfg.experts_per_token * 4)
    if cfg.num_experts and dp > 1:
        moe = [k for k in kinds if k != "ssd"]
        ar += bw * 2 * len(moe) * cfg.num_experts * 4
        g, gs = L.moe_groups(T, total=T * dp)
        if gs != g:
            ag += len(moe) * dp * T * cfg.experts_per_token * 4
    return {"all-gather": ag * accum, "all-reduce": ar * accum,
            "reduce-scatter": 0}


def _outputs(kind, args, out, shardings, mesh, b_ax):
    """(output bytes, of them updated in place) per device: the train
    state and five fp32 metrics; or the last-position logits (batch over
    the data axes, gathered over "model" as the serving steps return
    them) and the cache."""
    if kind == "train":
        state_sh = shardings[0]
        state = device_bytes(args[0], state_sh)
        return state + 5 * 4, state
    logits, cache = out
    lsh = NamedSharding(mesh, P(b_ax))
    cache_b = device_bytes(cache, shardings[1]["cache"])
    return SH.shard_bytes(logits.shape, logits.dtype, lsh) + cache_b, cache_b


def count_cell(cfg, kind: str, B: int, S: int, mesh, *,
               accum: int = TRAIN_ACCUM, **kw):
    """``roofline.count_step`` of a cell's step, and its output: for a
    train step, one microbatch (B / accum rows) counted and multiplied
    by ``accum``; a stack of more than one layer group counted at none
    and at one group (the tail kept) and extrapolated linearly to
    ``cfg.n_groups``."""
    def run(c):
        Bc = B // accum if kind == "train" else B
        fn, args, _, meta = build_cell_for(c, kind, Bc, S, mesh, accum=1,
                                           **kw)
        outs = []
        with SH.axis_rules(meta["rules"]):
            counts = RL.count_step(lambda *a: outs.append(fn(*a)), *args)
        reps = accum if kind == "train" else 1
        return counts.flops * reps, outs[0]

    G = cfg.n_groups
    if G <= 1:
        return run(cfg)
    f0, out = run(cfg.replace(num_layers=cfg.n_tail))
    f1, _ = run(cfg.replace(num_layers=len(cfg.pattern) + cfg.n_tail))
    return f0 + G * (f1 - f0), out


def run_cell_for(cfg, kind: str, B: int, S: int, mesh, *, cc: bool = False,
                 seq_shard: bool = False, accum: int = TRAIN_ACCUM,
                 attn: str = "auto", rec: Optional[dict] = None) -> Dict:
    """One cell's record (``run_cell``'s body, for any config)."""
    rec = dict(status="ok") if rec is None else rec
    chips = int(np.prod(list(mesh.shape.values())))
    if attn == "flash_cp":
        AB.set_cp_mesh(mesh)
    try:
        t0 = time.time()
        _, args, shardings, meta = build_cell_for(
            cfg, kind, B, S, mesh, cc=cc, seq_shard=seq_shard, accum=accum,
            attn=attn)
        flops, out = count_cell(cfg, kind, B, S, mesh, accum=accum, cc=cc,
                                seq_shard=seq_shard, attn=attn)
        rec["count_s"] = round(time.time() - t0, 2)
        arg_b = device_bytes(args, shardings)
        out_b, alias_b = _outputs(kind, args, out, shardings, mesh,
                                  _batch_axis(mesh, B))
        resident = arg_b + out_b - alias_b
        rec["memory"] = {
            "argument_gib": arg_b / GIB, "output_gib": out_b / GIB,
            "temp_gib": None, "alias_gib": alias_b / GIB,
            "argument_bytes": arg_b, "output_bytes": out_b,
            "resident_gib": resident / GIB,
            "fits_80gb": resident <= RL.HBM_BYTES,
        }
        frac = meta.get("active_frac", 1.0)
        coll = zero1_collective_bytes(cfg, mesh, accum) \
            if kind == "train" else {}
        tp = cell_tp_bytes(cfg, kind, B, S, mesh, accum, cc)
        rec["counted"] = {"flops_total": flops,
                          "flops_device": flops / chips,
                          "coll_bytes_data_axes": coll,
                          "coll_bytes_tensor_parallel": tp}
        model_fl = RL.model_flops_6nd(cfg, kind, B, S)
        an_flops = RL.analytic_flops(cfg, kind, B, S, active_frac=frac)
        an_hbm = RL.analytic_hbm_bytes(cfg, kind, B, S, chips)
        terms = RL.roofline_terms(
            flops / chips, an_hbm, sum(coll.values()) + sum(tp.values()),
            model_fl, chips)
        rec["analytic"] = {"flops_total": an_flops,
                           "flops_device": an_flops / chips,
                           "hbm_bytes_device": an_hbm,
                           "model_flops_6nd": model_fl}
        rec["roofline"] = terms.as_dict()
        rec["chips"] = chips
    except Exception as e:  # noqa: BLE001
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    finally:
        if attn == "flash_cp":
            AB.set_cp_mesh(None)
    return rec


def run_cell(arch: str, shape_name: str, mesh_kind: str, *,
             cc: bool = False, seq_shard: bool = False,
             accum: int = TRAIN_ACCUM, attn: str = "auto") -> Dict:
    rec = dict(arch=arch, shape=shape_name, mesh=mesh_kind, cc=cc,
               seq_shard=seq_shard, attn=attn, status="ok")
    if shape_name == "long_500k" and arch not in LONG_CONTEXT_ARCHS:
        rec["status"] = "skipped"
        rec["reason"] = ("pure full-attention arch: 0.5M-token dense KV "
                         "per sequence is undeployable (DESIGN.md §6)")
        return rec
    cfg0 = get_config(arch)
    if cc and not cfg0.supports_chunk_cache:
        rec["status"] = "skipped"
        rec["reason"] = "chunk-cache inapplicable (DESIGN.md §6)"
        return rec
    mesh = meta_mesh(make_production_mesh(multi_pod=(mesh_kind == "multi"),
                                          device="cpu"))
    spec = SHAPES[shape_name]
    cfg = cfg0.replace(dtype="bfloat16", param_dtype="bfloat16")
    return run_cell_for(cfg, spec["kind"], spec["global_batch"],
                        spec["seq_len"], mesh, cc=cc, seq_shard=seq_shard,
                        accum=accum, attn=attn, rec=rec)


def cell_tp_bytes(cfg, kind: str, B: int, S: int, mesh,
                  accum: int = TRAIN_ACCUM, cc: bool = False) -> Dict:
    """A cell's tensor-parallel collective bytes per device: the train
    step's ``tp_collective_bytes``; or the serving step's
    ``serving_collective_bytes`` over its B rows of S (prefill, into a
    ring cache), the active tokens against a full-length cache of S (cc)
    or one token against a ring cache of S (decode)."""
    if kind == "train":
        return tp_collective_bytes(cfg, mesh, accum, B, S)
    if kind == "decode":
        return serving_collective_bytes(cfg, mesh, "decode", B, 1, S)
    if cc:
        return serving_collective_bytes(cfg, mesh, "partial", B,
                                        _cc_tokens(S), S, ring=False)
    return serving_collective_bytes(cfg, mesh, "prefill", B, S, S)


def serving_shardings(cfg, mode: str, B: int, S: int, mesh):
    """The layout of a serving step's ``(params, batch)`` on ``mesh``,
    as the dry-run's cell lays it out (``build_cell_for``): params by the
    rules, the batch over the data axes where ``_batch_axis`` puts its B
    rows, the cache by ``cache_shardings``, that of a "prefill" cell for
    ``mode`` prefill and partial (the Cache-Craft step's is the same),
    that of a "decode" cell for decode (at B 1 the sequence also over
    "data"). The steps take it as ``shardings=`` (``training/steps.py``);
    ``sharding.shard_tree`` lays trees out by it and
    ``sharding.unshard_tree`` puts them back together. Only the specs
    matter, so the cell is built at S for any cache length."""
    kind = "decode" if mode == "decode" else "prefill"
    _, _, shardings, _ = build_cell_for(cfg, kind, B, S, mesh)
    return shardings


def serving_collective_bytes(cfg, mesh, mode: str, B: int, T: int, S: int,
                             ring: bool = True) -> Dict[str, int]:
    """Per-device bytes of a serving step's collectives, in closed form:
    ``mode`` prefill / partial / decode over B rows of T tokens against a
    cache of S slots (``local`` layers' ``min(S, window)`` with ``ring``),
    laid out by ``serving_shardings``. With R the data shards the rows go
    over (1 where the batch stays whole), B_d = B / R, t = B_d T a data
    shard's tokens and ``dt`` the compute dtype's bytes, over "model" (the
    HLO kinds, ``collectives.BYTES``): the vocab-split embedding's rows
    (t d dt) where tokens are embedded; each ``"gather"`` leaf of a layer
    all-gathered (its per-layer tensor); the output of each split
    attention, cross-attention, SwiGLU and RG-LRU block summed (t d dt),
    of a split SSD block with its gated norm's statistic (t d dt + t 4),
    of split experts their fp32 combine (t d 4); and where the experts'
    GShard groups span the data shards, per MoE layer the expert ids all
    gathered (int32 [R t, k]). The serving gathers (``collectives.
    GATHERS``): attention reading a cache whose blocks split what it
    reads, k and v (and ``pos`` where its slots split) put together,
    under "kv over model" for the model axis (the heads' D columns, or
    the slots of the flash-decode sequence range) and "kv over data" for
    the data axes (B 1 decode's sequence): [B_d, S_c, Hkv', D] each, Hkv'
    the kv heads a shard reads (Hkv / model where they split); across
    both axes, the model gather within one data index (S_c / R' slots)
    and then the data gather. A ``local`` ring shorter than the prompt is
    not read (attention over the fresh K and V). Cross-attention reads
    ``mk`` / ``mv`` [B_d, M, Hkv', D] outside a pass given media. The
    vocab-split last-position logits gathered: B_d V dt (``"logits over
    model"``). These are the bytes ``collectives.py`` counts when the
    steps run with ``shardings=``."""
    nm = mesh.shape.get("model", 1)
    kind = "decode" if mode == "decode" else "prefill"
    b_ax = _batch_axis(mesh, B)
    R = dp_size(mesh) if b_ax else 1
    Bd = B // R
    t = Bd * T
    dt, pb, d = _elsize(cfg.dtype), _elsize(cfg.param_dtype), cfg.d_model
    plan = SH.tp_plan(mesh, cfg, M.param_axes(cfg))
    shapes = M.init_params(cfg, torch.Generator(), device=META)
    kinds = cfg.layer_kinds
    layers = [(kinds[g * len(cfg.pattern) + i], plan["groups"][i],
               {n: x.shape[1:] for n, x in shapes["groups"][i].items()})
              for g in range(cfg.n_groups) for i in range(len(cfg.pattern))]
    layers += [(kinds[cfg.n_groups * len(cfg.pattern) + i], plan["tail"][i],
                {n: x.shape for n, x in shapes["tail"][i].items()})
               for i in range(cfg.n_tail)]
    seq_axis = "data" if (mode == "decode" and b_ax is None and
                          S % dp_size(mesh) == 0 and
                          not cfg.is_attention_free) else None
    # the cache layout's axes for k / v / pos (``cache_shardings``)
    hkv, D = cfg.num_kv_heads, cfg.head_dim_
    if hkv % nm == 0:
        h_ax, d_ax, s_ax = "model", None, seq_axis
    elif kind == "decode" and seq_axis is None:
        h_ax, d_ax, s_ax = None, None, "model"
    elif D % nm == 0:
        h_ax, d_ax, s_ax = None, "model", seq_axis
    else:
        h_ax = d_ax = None
        s_ax = seq_axis
    hread = hkv // nm if h_ax == "model" else hkv
    Rs = dp_size(mesh) if seq_axis else 1
    ag = ar = 0
    gat = {"kv over model": 0, "kv over data": 0, "logits over model": 0}

    def kv_read(n_slots, with_pos, over_model, over_data):
        region = Bd * n_slots * hread * D * dt
        pos = Bd * n_slots * 4 if with_pos else 0
        if over_model:
            gat["kv over model"] += 2 * region // (Rs if over_data else 1)
        if over_data:
            gat["kv over data"] += 2 * region
        if with_pos and s_ax == "model":
            gat["kv over model"] += pos
        if with_pos and s_ax == "data":
            gat["kv over data"] += pos

    if nm > 1:
        if mode == "decode" or cfg.input_mode != "embeds":
            ar += t * d * dt
        if plan["unembed"] is not None:
            gat["logits over model"] += Bd * cfg.padded_vocab * dt
    for kind_l, routes, shp in layers:
        if nm > 1:
            split = {n for n, r in routes.items()
                     if r is not None and r.route == "split"}
            ag += sum(int(np.prod(shp[n])) * pb for n, r in routes.items()
                      if r is not None and r.route == "gather")
            for n in ("wq", "wi", "wx"):
                if n in split:
                    ar += t * d * dt
            if "out_proj" in split:
                ar += t * d * dt + t * 4
            if "wi_e" in split:
                ar += t * d * 4
        if kind_l in ("attn", "local"):
            s_c = M._kv_len(cfg, kind_l, S, ring)
            if mode != "decode" and kind_l == "local" and s_c < T:
                continue
            kv_read(s_c, True, d_ax == "model" or s_ax == "model",
                    s_ax == "data")
        elif kind_l == "xattn" and (mode == "decode"
                                    or not cfg.num_media_tokens):
            kv_read(cfg.num_media_tokens, False, d_ax == "model", False)
    if cfg.num_experts and R > 1:
        g, gs = L.moe_groups(t, total=t * R)
        if gs != g:
            ag += sum(k != "ssd" for k in kinds) * R * t * \
                cfg.experts_per_token * 4
    return {"all-gather": ag, "all-reduce": ar, "reduce-scatter": 0, **gat}


def cells(include_cc: bool = True):
    for arch in ARCHS:
        for shape in SHAPES:
            for mesh_kind in ("single", "multi"):
                yield dict(arch=arch, shape_name=shape, mesh_kind=mesh_kind)
                if include_cc and shape == "prefill_32k" and \
                        get_config(arch).supports_chunk_cache:
                    yield dict(arch=arch, shape_name=shape,
                               mesh_kind=mesh_kind, cc=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=("single", "multi"), default="single")
    ap.add_argument("--cc", action="store_true",
                    help="the Cache-Craft partial prefill")
    ap.add_argument("--seq-shard", action="store_true")
    ap.add_argument("--attn", default="auto",
                    choices=("auto", "flash", "flash_skip", "flash_cp"))
    ap.add_argument("--accum", type=int, default=TRAIN_ACCUM)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args()

    os.makedirs(args.out, exist_ok=True)
    todo = list(cells()) if args.all else [dict(
        arch=args.arch, shape_name=args.shape, mesh_kind=args.mesh,
        cc=args.cc)]
    for cell in todo:
        tag = "{arch}_{shape_name}_{mesh_kind}".format(**cell) + \
            ("_cc" if cell.get("cc") else "") + \
            ("_seqshard" if args.seq_shard else "") + \
            (f"_{args.attn}" if args.attn != "auto" else "")
        path = os.path.join(args.out, tag + ".json")
        if args.skip_existing and os.path.exists(path):
            print("skip", tag, flush=True)
            continue
        t0 = time.time()
        rec = run_cell(cell["arch"], cell["shape_name"], cell["mesh_kind"],
                       cc=cell.get("cc", False), seq_shard=args.seq_shard,
                       accum=args.accum, attn=args.attn)
        rec["wall_s"] = round(time.time() - t0, 1)
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        msg = rec["status"]
        if rec["status"] == "ok":
            r, m = rec["roofline"], rec["memory"]
            msg += (f" dom={r['dominant']} c={r['compute_s']:.3f}s "
                    f"m={r['memory_s']:.3f}s n={r['collective_s']:.3f}s "
                    f"mem={m['resident_gib']:.1f}GiB "
                    f"fits={m['fits_80gb']}")
        elif rec["status"] == "error":
            msg += " " + rec["error"][:120]
        print(f"{tag}: {msg} ({rec['wall_s']}s)", flush=True)


if __name__ == "__main__":
    main()
