"""Step functions of the port (``repro/training/steps.py``): the train
step, and the serving-side roots the reference's dry-run lowers and its
launchers execute.

``make_train_step`` builds a train step with microbatch accumulation
(grads summed in fp32 in microbatch order, then averaged), remat per
layer group (``cfg.remat``, set in the model) and AdamW. The params of a
``TrainState`` are leaf tensors that require grad; the serving engine
and executor run under ``torch.no_grad()``, and params restored for
serving (``serving/api.py``, ``params_path``) carry no grad.

With ``grad_specs`` (a tree of ``sharding.NamedSharding``, the ZeRO-1
layout of ``train_shardings``) the step runs over the mesh in one
process, data shard after data shard: the rows split by the data index,
each data shard's forward and backward on its rows, its layers
tensor-parallel over the model axis as ``sharding.tp_plan`` reads the
rules (the reference gets the same function from GSPMD; each data
shard's forward takes the blocks of every model index), the fp32 grads
reduce-scattered over the data axes, per model index on that index's
blocks, into accumulators laid out by ``grad_specs``, AdamW on each
shard's slice of params, ``m`` and ``v``, and the params all-gathered
back (``distributed/collectives.py``, which counts the bytes). It
computes the unsharded step's function; only the order of the fp32
sums differs. With experts, every data shard's forward
of a microbatch runs first, with the global microbatch's GShard groups
and capacity; where a group spans shards, the shards run layer by layer
(``M.run_stack_lockstep``) so that its dispatch sees all of them. The
aux loss ``E sum_e fe_e me_e`` takes the global
``fe`` (an all-reduce over the data axes; ``fe`` carries no gradient),
each shard's term its own ``me`` over the data-parallel size. The
reference's int8 error-feedback all-reduce
(``distributed/compression.py``) is not part of its train step, nor of
this one.

The serving roots are plain closures ``(params, batch) -> (logits,
cache)`` over ``models.model``: ``batch`` holds ``tokens`` (or
``embeds``, for a config with ``input_mode="embeds"``), ``media`` for a
config with cross-attention layers, ``positions`` (optional for the full
prefill) and ``cache``, which is updated in place. With ``shardings``
(``launch.dryrun.serving_shardings``, the reference's ``in_shardings``)
they run over the mesh in one process (``_sharded_serving_step``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.distributed import collectives as CO
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.collectives import (all_gather, psum,
                                                 reduce_scatter)
from repro_torch.launch.mesh import data_axes, dp_size
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.training.optimizer import (AdamWConfig, adamw_init,
                                            adamw_leaf, adamw_scalars,
                                            adamw_update, tree_leaves,
                                            tree_map, tree_map2,
                                            tree_unflatten)

MOE_AUX_COEF = 0.01


@dataclass
class TrainState:
    step: torch.Tensor          # int32 scalar on the params' device
    params: Any
    opt: Any


def _trainable(params):
    for x in tree_leaves(params):
        x.requires_grad_(True)
    return params


def init_train_state(cfg: ModelConfig,
                     generator: torch.Generator) -> TrainState:
    """Random init on ``generator``'s device (``M.init_params``)."""
    params = _trainable(M.init_params(cfg, generator))
    return TrainState(
        step=torch.zeros((), dtype=torch.int32, device=generator.device),
        params=params, opt=adamw_init(params))


def state_to_tree(state: TrainState) -> dict:
    """Checkpoint-friendly (dict/list-only) representation."""
    return {"step": state.step, "params": state.params, "opt": state.opt}


def tree_to_state(tree: dict, device) -> TrainState:
    """A ``state_to_tree`` tree with numpy leaves (a restored checkpoint
    of either package) -> a ``TrainState`` on ``device``, copied (the
    train step updates it in place)."""
    t = tree_map(lambda x: torch.tensor(x, device=device), tree)
    return TrainState(step=t["step"].to(torch.int32),
                      params=_trainable(t["params"]), opt=t["opt"])


def state_from_jax(cfg: ModelConfig, np_tree: dict, device) -> TrainState:
    """The reference's ``TrainState`` as a numpy tree
    (``jax.tree.map(np.asarray, state_to_tree(state))``) -> the port's, on
    ``device``: the params and both moments through ``params_from_jax``,
    ``count`` and ``step`` as int32 scalars."""
    def scalar(x):
        return torch.tensor(int(np.asarray(x)), dtype=torch.int32,
                            device=device)
    opt = np_tree["opt"]
    params = _trainable(M.params_from_jax(cfg, np_tree["params"], device))
    return TrainState(
        step=scalar(np_tree["step"]), params=params,
        opt={"m": M.params_from_jax(cfg, opt["m"], device),
             "v": M.params_from_jax(cfg, opt["v"], device),
             "count": scalar(opt["count"])})


def loss_fn(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor],
            label_count=None):
    """Next-token CE on fp32 logits (labels shifted by the data pipeline;
    labels < 0 are masked), plus ``MOE_AUX_COEF`` x the MoE aux loss.
    The inputs are ``batch["tokens"]`` or ``batch["embeds"]``, and
    ``batch["media"]`` where the config has cross-attention layers. The
    CE sum is divided by ``label_count`` where given (a data shard's rows
    over the whole batch's count), else by the batch's own count."""
    out = M.forward(cfg, params, tokens=batch.get("tokens"),
                    embeds=batch.get("embeds"), media=batch.get("media"),
                    mode="train")
    nll = _nll(out.logits.float(), batch["labels"], label_count)
    loss = nll + MOE_AUX_COEF * out.aux_loss
    return loss, {"nll": nll, "aux": out.aux_loss}


def _nll(logits, labels, label_count=None):
    labels = labels.long()
    logp = F.log_softmax(logits, dim=-1)
    take = logp.gather(-1, labels.clamp(min=0)[..., None])[..., 0]
    mask = (labels >= 0).float()
    count = mask.sum() if label_count is None else label_count
    return -(take * mask).sum() / torch.clamp(count, min=1.0)


def _vocab_parallel_nll(cfg, params, h, labels, label_count):
    """``_nll`` of the final hidden states ``h`` with ``unembed`` split
    over the model axis by vocab: each shard's logits columns, the row
    max (a pmax), the sum of exponentials and the label's logit (each a
    psum over the shards, of [rows, S] fp32)."""
    hn = L.rms_norm(h, params["final_norm"], cfg.norm_eps)
    w = params["unembed"]
    dtype = M.torch_dtype(cfg.dtype)
    logits = [(x.reshape(-1, x.shape[-1]) @ b.to(dtype)).reshape(
        *x.shape[:-1], -1).float()
        for x, b in zip(CO.copy_to_model(hn, len(w.parts)), w.parts)]
    mx = CO.pmax([lg.detach().amax(-1) for lg in logits])
    se = CO.reduce_from_model([torch.exp(lg - mx[..., None]).sum(-1)
                               for lg in logits])
    lab = labels.long().clamp(min=0)
    picks, lo = [], 0
    for lg in logits:
        n = lg.shape[-1]
        mine = (lab >= lo) & (lab < lo + n)
        v = lg.gather(-1, (lab - lo).clamp(0, n - 1)[..., None])[..., 0]
        picks.append(torch.where(mine, v, torch.zeros((), device=v.device)))
        lo += n
    take = CO.reduce_from_model(picks) - mx - torch.log(se)
    mask = (labels >= 0).float()
    return -(take * mask).sum() / torch.clamp(label_count, min=1.0)


def _grads(loss, leaves):
    """d loss / d leaves; zeros for a leaf the loss does not reach (the
    token embedding of an ``embeds`` config), as ``jax.grad`` gives."""
    return torch.autograd.grad(loss, leaves, allow_unused=True,
                               materialize_grads=True)


def _micro(batch, accum):
    return [{k: v.reshape(accum, v.shape[0] // accum, *v.shape[1:])[i]
             for k, v in batch.items()} for i in range(accum)]


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    accum: int = 1, grad_specs=None) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``. ``batch``
    leaves are ``[global_batch, ...]`` tensors on the params' device;
    with ``accum > 1`` the batch is split into ``accum`` microbatches run
    one after another (activation memory / accum), their grads summed in
    fp32 in order and divided by ``accum``. The state's params, moments
    and step are updated in place.

    ``grad_specs``: the ZeRO-1 layout of the fp32 grads (a tree of
    ``NamedSharding`` like the params, ``train_shardings(...)["opt"]
    ["m"]``); the step then runs data-parallel over its mesh on a state
    laid out by ``train_shardings`` (``shard_state``), see the module
    docstring.

    The metrics: ``loss``, ``nll`` and ``aux`` as the reference reports
    them (above one microbatch ``nll`` is the loss and ``aux`` 0), ``lr``,
    ``grad_norm`` and, for a config with experts, ``aux_micro``: each
    microbatch's aux loss."""
    if grad_specs is not None:
        return _sharded_train_step(cfg, opt_cfg, accum, grad_specs)

    def train_step(state: TrainState, batch):
        params = state.params
        leaves = list(tree_leaves(params))
        if accum == 1:
            loss, aux = loss_fn(cfg, params, batch)
            flat = _grads(loss, leaves)
            micro = [aux["aux"]]
        else:
            lsum, micro = 0.0, []
            for i, mb in enumerate(_micro(batch, accum)):
                loss, a = loss_fn(cfg, params, mb)
                micro.append(a["aux"])
                grads = _grads(loss, leaves)
                # accumulate in fp32 whatever the param dtype, so the
                # running sum is order-deterministic and does not narrow
                if i == 0:
                    flat = [g.float() for g in grads]
                else:
                    for a, g in zip(flat, grads):
                        a.add_(g.float())
                del grads
                lsum = lsum + loss.detach()
            flat = [g.div_(accum) for g in flat]
            loss = lsum / accum
            aux = {"nll": loss, "aux": 0.0}
        _, state.opt, om = adamw_update(
            opt_cfg, tree_unflatten(params, flat), state.opt, params)
        state.step = state.step + 1
        metrics = {"loss": loss.detach(), "nll": aux["nll"].detach(),
                   "aux": aux["aux"], **om}
        if cfg.num_experts:
            # a stack with no MoE layer (the dry-run's count at 0 groups)
            # has the number 0.0 for its aux
            metrics["aux_micro"] = torch.stack([torch.as_tensor(
                a, device=loss.device).detach() for a in micro])
        return state, metrics

    return train_step


# ---------------------------------------------------------------------------
# Data-parallel ZeRO-1 over a mesh
# ---------------------------------------------------------------------------
def train_shardings(cfg: ModelConfig, mesh) -> dict:
    """The layout of a train state on ``mesh``, a tree like
    ``state_to_tree``'s: params by the rules (``make_rules``,
    ``spec_tree(param_axes)``), ``m`` / ``v`` (and the grads) by their
    ZeRO-1 spec over the data axes, ``step`` and ``count`` replicated
    (the reference's dry-run layout)."""
    shapes = M.init_params(cfg, torch.Generator(), device="meta")
    dax, dsz = data_axes(mesh), dp_size(mesh)
    with SH.axis_rules(SH.make_rules(mesh, cfg)):
        pspecs = SH.spec_tree(M.param_axes(cfg))

    def layout(fn):
        return tree_map2(lambda x, sp: SH.NamedSharding(mesh, fn(sp, x)),
                         shapes, pspecs)
    rep = SH.NamedSharding(mesh, SH.P())
    zero1 = layout(lambda sp, x: SH.zero1_spec(sp, x.shape, dax, dsz))
    return {"step": rep, "params": layout(lambda sp, x: sp),
            "opt": {"m": zero1, "v": zero1, "count": rep}}


def shard_state(state: TrainState, shardings: dict) -> TrainState:
    """``state`` laid out by ``train_shardings``: params, ``m`` and ``v``
    as ``ShardedTensor``s (param shards require grad), ``step`` and
    ``count`` as they are. The moments' blocks are copies of their own;
    the params' replicas on the state's device are the params."""
    def lay(tree, specs):
        return tree_map2(lambda x, sp: SH.shard(x.detach(), sp), tree,
                         specs)
    params = lay(state.params, shardings["params"])
    for st in tree_leaves(params):
        for x in {id(x): x for x in st.shards.flat}.values():
            x.requires_grad_(True)
    opt = shardings["opt"]
    return TrainState(step=state.step, params=params, opt={
        "m": lay(state.opt["m"], opt["m"]), "v": lay(state.opt["v"],
                                                    opt["v"]),
        "count": state.opt["count"]})


def sharded_state_from_tree(tree: dict) -> TrainState:
    """A ``state_to_tree`` tree of ``ShardedTensor``s (a checkpoint
    restored with ``shardings=train_shardings(...)``) as a state the
    sharded step takes: ``step`` and ``count`` as plain int32 scalars,
    param shards requiring grad."""
    for st in tree_leaves(tree["params"]):
        for x in {id(x): x for x in st.shards.flat}.values():
            x.requires_grad_(True)
    opt = tree["opt"]
    return TrainState(step=SH.unshard(tree["step"]).to(torch.int32),
                      params=tree["params"], opt={
                          "m": opt["m"], "v": opt["v"],
                          "count": SH.unshard(opt["count"]).to(torch.int32)})


def unshard_state(state: TrainState) -> TrainState:
    """A ``shard_state`` state as one unsharded ``TrainState``."""
    def whole(tree):
        return tree_map(lambda st: SH.unshard(st).detach(), tree)
    return TrainState(step=state.step, params=whole(state.params), opt={
        "m": whole(state.opt["m"]), "v": whole(state.opt["v"]),
        "count": state.opt["count"]})


def _check_layout(m_leaves, specs):
    for st, sp in zip(m_leaves, specs):
        if st.sharding != sp:
            raise ValueError(f"moment laid out by {st.sharding}, grads "
                             f"by {sp}: lay the state out with "
                             "train_shardings")


def _rows(batch, accum, dp):
    B = next(iter(batch.values())).shape[0]
    if B % (accum * dp):
        raise ValueError(f"global batch {B} does not split into "
                         f"{accum} microbatches over {dp} data shards")
    return B // accum // dp


def _moe_sync(cfg, dp):
    """The dispatch of one MoE layer over the data shards of a
    microbatch: each shard's expert ids [Gs, gs, k] -> its (slot, kept).
    Where the shards cut no GShard group (gs == g) each dispatches its
    own groups; else the ids are all-gathered over the data axes (int32)
    and the global groups dispatched in shard order, so a group that
    spans shards fills its capacity across them."""
    E, k = cfg.num_experts, cfg.experts_per_token

    def sync(gis):
        t = gis[0].shape[0] * gis[0].shape[1]
        g, gs = L.moe_groups(t, total=t * dp)
        C = L.moe_capacity(g, k, cfg.capacity_factor, E)
        if gs == g:
            return [L.moe_slots(gi, C, E) for gi in gis]
        ids = all_gather([gi.reshape(-1, k).to(torch.int32) for gi in gis],
                         0).long()
        slot, kept = (x.reshape(-1, k) for x in
                      L.moe_slots(ids.reshape(-1, g, k), C, E))
        return [(slot[d * t:(d + 1) * t].reshape(gi.shape).to(gi.device),
                 kept[d * t:(d + 1) * t].reshape(gi.shape).to(gi.device))
                for d, gi in enumerate(gis)]
    return sync


def _sharded_train_step(cfg, opt_cfg, accum, grad_specs):
    """The step on the mesh of ``grad_specs`` (see the module docstring).
    One process runs every device group's collectives; those of data
    shards and model indices other than 0 run under
    ``collectives.counting(False)``, so that ``BYTES`` counts one
    device's (``dryrun.tp_collective_bytes`` plus
    ``zero1_collective_bytes``)."""
    specs = list(tree_leaves(grad_specs))
    mesh = specs[0].mesh
    dax = data_axes(mesh)
    if any(n > 1 for a, n in mesh.shape.items()
           if a not in dax and a != "model"):
        raise ValueError(f"sharded train step on mesh {mesh.shape}: the "
                         "rules split only the data axes and 'model'")
    names = mesh.axis_names
    nm = mesh.shape.get("model", 1)
    dshards = list(np.ndindex(*(mesh.shape[a] for a in dax)))
    dp = len(dshards)

    def at(d, m):
        idx = [0] * len(names)
        for a, i in zip(dax, dshards[d]):
            idx[names.index(a)] = i
        if "model" in names:
            idx[names.index("model")] = m
        return tuple(idx)

    routes = list(tree_leaves(SH.tp_plan(mesh, cfg, M.param_axes(cfg))))
    ddims = [SH.data_dim(sp.spec, dax) for sp in specs]
    # the distinct model blocks of each leaf: (leaf, model index)
    units = [(j, u) for j, r in enumerate(routes)
             for u in (range(nm) if r is not None else (0,))]
    sync = _moe_sync(cfg, dp)

    def scope(d):
        return CO.counting(d == 0)

    def train_step(state: TrainState, batch):
        p_leaves = list(tree_leaves(state.params))
        m_leaves = list(tree_leaves(state.opt["m"]))
        v_leaves = list(tree_leaves(state.opt["v"]))
        _check_layout(m_leaves, specs)
        rows = _rows(batch, accum, dp)

        def params_of(d):
            return tree_unflatten(state.params, [
                st.shards[at(d, 0)] if r is None else SH.Blocks(
                    [st.shards[at(d, m)] for m in range(nm)], r.dim, r.route)
                for st, r in zip(p_leaves, routes)])

        def leaves_of(d):
            return [p_leaves[j].shards[at(d, u)] for j, u in units]

        def shard_losses(mb, sbs, count):
            """Per data shard, its loss over ``mb``'s label count (a
            tensor with its graph, or a function that builds it), and
            the MoE aux term's value over the microbatch."""
            def nll(d, params, h, logits):
                if logits is None:
                    return _vocab_parallel_nll(cfg, params, h,
                                               sbs[d]["labels"],
                                               count.to(h.device))
                return _nll(logits.float(), sbs[d]["labels"],
                            count.to(logits.device))
            if not cfg.num_experts:
                def one(d):
                    params = params_of(d)
                    out = M.forward(cfg, params, tokens=sbs[d].get("tokens"),
                                    embeds=sbs[d].get("embeds"),
                                    media=sbs[d].get("media"), mode="train")
                    return nll(d, params, out.hidden, out.logits)
                return [lambda d=d: one(d) for d in range(dp)], 0.0
            params = [params_of(d) for d in range(dp)]
            total = mb["labels"].numel()
            t = total // dp
            g, gs = L.moe_groups(t, total=total)
            if gs == g:
                # every GShard group lies within one shard: each shard's
                # own forward dispatches its groups
                probs = [[] for _ in range(dp)]
                outs = []
                for d in range(dp):
                    with scope(d):
                        o = M.forward(cfg, params[d],
                                      tokens=sbs[d].get("tokens"),
                                      embeds=sbs[d].get("embeds"),
                                      media=sbs[d].get("media"),
                                      mode="train", moe_tokens=total,
                                      moe_probs=probs[d])
                    outs.append((o.hidden, o.logits))
            else:
                hs, probs = M.run_stack_lockstep(
                    cfg, params, sbs, moe_tokens=total, sync=sync,
                    scope=scope)
                outs = []
                for d in range(dp):
                    with scope(d):
                        outs.append((hs[d], None if isinstance(
                            params[d]["unembed"], SH.Blocks)
                            else M.lm_head(cfg, params[d], hs[d])))
            E = cfg.num_experts
            me = [torch.stack([p.mean(dim=(0, 1)) for p in ps])
                  for ps in probs]
            fe = [torch.stack([F.one_hot(p.argmax(-1), E).float().mean(
                dim=(0, 1)) for p in ps]) for ps in probs]
            stats = [torch.stack([f, m.detach()]) for f, m in zip(fe, me)]
            tot = psum(stats) / dp if dp > 1 else stats[0]
            losses = []
            for d, (h, logits) in enumerate(outs):
                with scope(d):
                    aux = E * torch.sum(tot[0].to(me[d].device) * me[d]) / dp
                    losses.append(nll(d, params[d], h, logits)
                                  + MOE_AUX_COEF * aux)
            return losses, E * torch.sum(tot[0] * tot[1])

        def shard_grads(mb, losses, auxes):
            count = (mb["labels"] >= 0).float().sum()
            sbs = [{k: v[d * rows:(d + 1) * rows].to(
                torch.device(mesh.devices[at(d, 0)]))
                for k, v in mb.items()} for d in range(dp)]
            per, aux = shard_losses(mb, sbs, count)
            auxes.append(aux)
            for d in range(dp):
                with scope(d):
                    loss = per[d]() if callable(per[d]) else per[d]
                    per[d] = None
                    grads = _grads(loss, leaves_of(d))
                losses.append(loss.detach())
                # fp32 whatever the param dtype, as in the unsharded step
                yield [g.float() for g in grads]
                del grads

        acc, lsum, auxes = None, None, []
        dims = [ddims[j] for j, _ in units]
        counted = [u == 0 for _, u in units]
        for mb in _micro(batch, accum):
            losses = []
            blocks = reduce_scatter(shard_grads(mb, losses, auxes), dims,
                                    counted)
            lsum = psum(losses) if lsum is None else lsum + psum(losses)
            if acc is None:
                acc = blocks
            else:
                done = set()
                for a_s, b_s in zip(acc, blocks):
                    for a, b in zip(a_s, b_s):
                        if id(a) not in done:
                            done.add(id(a))
                            a.add_(b)
            del blocks
        for a in {id(a): a for a_s in acc for a in a_s}.values():
            a.div_(accum)
        loss = lsum / accum
        sq = [sum(torch.sum(torch.square(a)) for i, a in enumerate(a_s)
                  if dims[i] is not None or d == 0)
              for d, a_s in enumerate(acc)]
        gnorm = torch.sqrt(psum(sq))
        count_new, lr, scale, bc1, bc2 = adamw_scalars(
            opt_cfg, state.opt["count"], gnorm)
        unit_at = {ju: i for i, ju in enumerate(units)}
        for j, dd in enumerate(ddims):
            pst, mst, vst = p_leaves[j], m_leaves[j], v_leaves[j]
            seen = set()
            for m in range(nm):
                trios = [(mst.shards[at(d, m)], vst.shards[at(d, m)],
                          pst.shards[at(d, m)]) for d in range(dp)]
                key = tuple(id(x) for t in trios for x in t)
                if key in seen:
                    continue
                seen.add(key)
                i = unit_at[(j, m if routes[j] is not None else 0)]
                with CO.counting(m == 0):
                    _update_blocks(opt_cfg, pst, specs[j], dd, trios,
                                   [a_s[i] for a_s in acc],
                                   [at(d, m) for d in range(dp)],
                                   (scale, lr, bc1, bc2))
            for u in range(nm if routes[j] is not None else 1):
                for a_s in acc:
                    a_s[unit_at[(j, u)]] = None
        state.opt["count"] = count_new
        state.step = state.step + 1
        aux = auxes[0] if cfg.num_experts and accum == 1 else 0.0
        metrics = {"loss": loss, "nll": loss - MOE_AUX_COEF * aux,
                   "aux": aux, "lr": lr, "grad_norm": gnorm}
        if cfg.num_experts:
            metrics["aux_micro"] = torch.stack(auxes)
        return state, metrics

    return train_step


def _update_blocks(opt_cfg, pst, spec, dd, trios, grads, idxs, scalars):
    """AdamW on one model block of a leaf over the data shards: each
    shard's ZeRO-1 slice of the block (the whole block where ``dd``, the
    data-split dim, is None), then the slices all-gathered back into
    every replica of the block."""
    scale, lr, bc1, bc2 = scalars
    if dd is None:
        done = set()
        for (m, v, p), g in zip(trios, grads):
            if tuple(map(id, (m, v, p))) not in done:
                done.add(tuple(map(id, (m, v, p))))
                adamw_leaf(opt_cfg, g.to(p.device), m, v, p, scale, lr,
                           bc1, bc2)
        return
    new = []
    for (m, v, p), g, idx in zip(trios, grads, idxs):
        z = SH.shard_slices(pst.shape, spec, idx)
        b = SH.shard_slices(pst.shape, pst.sharding, idx)
        rel = tuple(slice(zs.start - bs.start, zs.stop - bs.start)
                    for zs, bs in zip(z, b))
        block = p.detach()[rel].clone()
        adamw_leaf(opt_cfg, g.to(p.device), m, v, block, scale, lr, bc1,
                   bc2)
        new.append(block)
    whole = all_gather(new, dd)
    del new
    with torch.no_grad():
        for p in {id(t[2]): t[2] for t in trios}.values():
            p.copy_(whole.to(p.device))


# ---------------------------------------------------------------------------
# Serving-side roots
# ---------------------------------------------------------------------------
def make_prefill_step(cfg: ModelConfig, attn_impl: str = "auto",
                      shardings=None):
    """Full prefill: the paper's Full-Recomp baseline. ``shardings``: the
    layout of ``(params, batch)`` on a mesh (``jax.jit``'s
    ``in_shardings``; ``launch.dryrun.serving_shardings``), see
    ``_sharded_serving_step``."""
    if shardings is not None:
        return _sharded_serving_step(cfg, "prefill", attn_impl, shardings)

    def prefill_step(params, batch):
        out = M.forward(cfg, params, tokens=batch.get("tokens"),
                        embeds=batch.get("embeds"), media=batch.get("media"),
                        positions=batch.get("positions"), mode="prefill",
                        cache=batch["cache"], attn_impl=attn_impl,
                        logits_slice="last")
        return out.logits, out.cache
    return prefill_step


def make_cachecraft_prefill_step(cfg: ModelConfig, attn_impl: str = "auto",
                                 shardings=None):
    """Cache-Craft partial prefill as one step: active tokens (new chunks
    + recompute + question) against a pre-populated cache.
    ``shardings`` as in ``make_prefill_step``."""
    if shardings is not None:
        return _sharded_serving_step(cfg, "partial", attn_impl, shardings)

    def step(params, batch):
        out = M.forward(cfg, params, tokens=batch.get("tokens"),
                        embeds=batch.get("embeds"), media=batch.get("media"),
                        positions=batch["positions"], mode="partial",
                        cache=batch["cache"], attn_impl=attn_impl,
                        logits_slice="last")
        return out.logits, out.cache
    return step


def make_decode_step(cfg: ModelConfig, attn_impl: str = "auto",
                     shardings=None):
    """One decode step (``M.decode_step``, decode slot = position).
    ``shardings`` as in ``make_prefill_step``."""
    if shardings is not None:
        return _sharded_serving_step(cfg, "decode", attn_impl, shardings)

    def decode(params, batch):
        out = M.decode_step(cfg, params, batch["tokens"],
                            batch["positions"], batch["cache"],
                            attn_impl=attn_impl)
        return out.logits, out.cache
    return decode


def _sharded_serving_step(cfg, mode, attn_impl, shardings):
    """A serving step on the mesh of ``shardings`` = (the params' layout,
    the batch's), the reference's ``jax.jit(step, in_shardings=...)``: it
    takes ``params`` and ``batch["cache"]`` laid out by them (trees of
    ``sharding.ShardedTensor``, ``sharding.shard_tree``), and the other
    batch entries as whole tensors, and returns (the logits [B,1,V] put
    together over the data shards, the cache, updated in place). The rows
    go over the data axes where the batch's layout puts them (the data
    shards run in order, each on its rows, layer by layer:
    ``M.forward_shards``); where it leaves them whole (B 1 decode), one
    pass runs on all rows and reads the cache's blocks of every data
    index. Each data shard's layers see the leaves ``sharding.tp_plan``
    splits over "model" as ``sharding.Blocks`` and its cache leaves as
    ``sharding.Tiles``. The collectives of data shards other than the
    first run under ``collectives.counting(False)``, so that ``BYTES`` and
    ``GATHERS`` count one device's (``dryrun.serving_collective_bytes``).
    It computes the unsharded step's function: only the order of fp32
    sums, and on ``kernel`` each launch's key split, differ."""
    psh, bsh = shardings
    specs = list(tree_leaves(psh))
    mesh = specs[0].mesh
    dax = data_axes(mesh)
    names = mesh.axis_names
    if any(n > 1 for a, n in mesh.shape.items()
           if a not in dax and a != "model"):
        raise ValueError(f"sharded serving step on mesh {mesh.shape}: the "
                         "rules split only the data axes and 'model'")
    nm = mesh.shape.get("model", 1)
    row_spec = bsh["embeds" if "embeds" in bsh else "tokens"].spec
    b_axes = SH._dim_axes(row_spec, 1)[0] if len(row_spec) else ()
    if b_axes and set(b_axes) != set(dax):
        raise ValueError(f"the batch split over {b_axes}, a part of the "
                         f"data axes {dax}")
    dshape = [mesh.shape[a] for a in dax]
    groups = list(np.ndindex(*dshape)) if b_axes else [None]
    routes = list(tree_leaves(SH.tp_plan(mesh, cfg, M.param_axes(cfg))))
    csh = bsh["cache"]

    def at(didx, m):
        idx = [0] * len(names)
        for a, i in zip(dax, didx or (0,) * len(dax)):
            idx[names.index(a)] = i
        if "model" in names:
            idx[names.index("model")] = m
        return tuple(idx)

    def scope(d):
        return CO.counting(d == 0)

    def step(params, batch):
        p_leaves = list(tree_leaves(params))
        c_leaves = list(tree_leaves(batch["cache"]))
        for st, sp in zip(p_leaves + c_leaves,
                          specs + list(tree_leaves(csh))):
            if st.sharding != sp:
                raise ValueError(f"{st} laid out by {st.sharding}, the step "
                                 f"by {sp}: lay it out with shard_tree")
        x0 = batch.get("embeds", batch.get("tokens"))
        B = x0.shape[0]
        R = len(groups)
        if B % R:
            raise ValueError(f"batch {B} does not split over {R} data "
                             "shards")
        rows = B // R
        inputs, ps, caches = [], [], []
        for r, didx in enumerate(groups):
            ps.append(tree_unflatten(params, [
                st.shards[at(didx, 0)] if rt is None else SH.Blocks(
                    [st.shards[at(didx, m)] for m in range(nm)], rt.dim,
                    rt.route)
                for st, rt in zip(p_leaves, routes)]))
            cache = batch["cache"]
            caches.append({
                "groups": [{k: SH.Tiles.of(v, 1, didx) for k, v in c.items()}
                           for c in cache["groups"]],
                "tail": [{k: SH.Tiles.of(v, 0, didx) for k, v in c.items()}
                         for c in cache["tail"]]})
            x = {k: v[r * rows:(r + 1) * rows] for k, v in batch.items()
                 if k != "cache" and v is not None}
            if mode == "decode":
                x["tokens"] = x["tokens"][:, None]
                x["decode_slot"] = x["positions"]
                x["positions"] = x["positions"][:, None]
            inputs.append(x)
        T = x0.shape[1] if mode != "decode" else 1
        logits = M.forward_shards(
            cfg, ps, inputs, caches, mode=mode, attn_impl=attn_impl,
            moe_tokens=B * T if cfg.num_experts else None,
            sync=_moe_sync(cfg, R) if cfg.num_experts else None,
            scope=scope)
        return torch.cat([lg.to(logits[0].device) for lg in logits], 0), \
            batch["cache"]
    return step
