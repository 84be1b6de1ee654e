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
layout of ``train_shardings``) the step runs data-parallel with ZeRO-1
over the mesh's data axes, one shard after another in one process: each
shard's forward and backward on its rows, the fp32 grads
reduce-scattered into accumulators laid out by ``grad_specs``, AdamW on
each shard's slice of params, ``m`` and ``v``, and the params
all-gathered back (``distributed/collectives.py``, which counts the
bytes). It computes the unsharded step's function; only the order of the
cross-shard sums differs. Tensor-parallel execution (a non-data axis
larger than 1; the reference gets it from GSPMD) and the MoE aux loss
(a product of two batch means, not a sum over shards) raise (ROADMAP
A18, A19). The reference's int8 error-feedback all-reduce
(``distributed/compression.py``) is not part of its train step, nor of
this one.

The serving roots are plain closures ``(params, batch) -> (logits,
cache)`` over ``models.model``: ``batch`` holds ``tokens`` (or
``embeds``, for a config with ``input_mode="embeds"``), ``media`` for a
config with cross-attention layers, ``positions`` (optional for the full
prefill) and ``cache``, which is updated in place.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.distributed import sharding as SH
from repro_torch.distributed.collectives import (all_gather, psum,
                                                 reduce_scatter)
from repro_torch.launch.mesh import data_axes, dp_size
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
    logits = out.logits.float()
    labels = batch["labels"].long()
    logp = F.log_softmax(logits, dim=-1)
    take = logp.gather(-1, labels.clamp(min=0)[..., None])[..., 0]
    mask = (labels >= 0).float()
    count = mask.sum() if label_count is None else label_count
    nll = -(take * mask).sum() / torch.clamp(count, min=1.0)
    loss = nll + MOE_AUX_COEF * out.aux_loss
    return loss, {"nll": nll, "aux": out.aux_loss}


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
    docstring."""
    if grad_specs is not None:
        return _sharded_train_step(cfg, opt_cfg, accum, grad_specs)

    def train_step(state: TrainState, batch):
        params = state.params
        leaves = list(tree_leaves(params))
        if accum == 1:
            loss, aux = loss_fn(cfg, params, batch)
            flat = _grads(loss, leaves)
        else:
            lsum = 0.0
            for i, mb in enumerate(_micro(batch, accum)):
                loss, _ = loss_fn(cfg, params, mb)
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


def _sharded_train_step(cfg, opt_cfg, accum, grad_specs):
    specs = list(tree_leaves(grad_specs))
    mesh = specs[0].mesh
    dax = data_axes(mesh)
    other = {a: n for a, n in mesh.shape.items() if a not in dax}
    if any(n > 1 for n in other.values()):
        raise NotImplementedError(
            f"sharded train step on mesh {mesh.shape}: only the data axes "
            "may exceed 1; tensor-parallel execution is not ported "
            "(ROADMAP A19)")
    if cfg.num_experts:
        raise NotImplementedError(
            f"{cfg.name}: the MoE aux loss is a product of two batch means, "
            "not a sum over data shards; the sharded train step does not "
            "compute it (ROADMAP A18)")
    # the data shards in mesh order (every other axis has size 1)
    shards = list(np.ndindex(mesh.devices.shape))
    dp = len(shards)
    dims = [SH.data_dim(sp.spec, dax) for sp in specs]

    def train_step(state: TrainState, batch):
        p_leaves = list(tree_leaves(state.params))
        m_leaves = list(tree_leaves(state.opt["m"]))
        v_leaves = list(tree_leaves(state.opt["v"]))
        for st, sp in zip(m_leaves, specs):
            if st.sharding != sp:
                raise ValueError(f"moment laid out by {st.sharding}, grads "
                                 f"by {sp}: lay the state out with "
                                 "train_shardings")
        B = next(iter(batch.values())).shape[0]
        if B % (accum * dp):
            raise ValueError(f"global batch {B} does not split into "
                             f"{accum} microbatches over {dp} data shards")
        rows = B // accum // dp

        def shard_grads(mb, losses):
            """Each data shard's fp32 grads on its rows of ``mb``, in
            shard order, its loss over ``mb``'s label count appended to
            ``losses``; each list is handed over to the sum."""
            count = (mb["labels"] >= 0).float().sum()
            for s, idx in enumerate(shards):
                dev = torch.device(mesh.devices[idx])
                sb = {k: v[s * rows:(s + 1) * rows].to(dev)
                      for k, v in mb.items()}
                leaves = [st.shards[idx] for st in p_leaves]
                loss, _ = loss_fn(cfg, tree_unflatten(state.params, leaves),
                                  sb, label_count=count.to(dev))
                grads = _grads(loss, leaves)
                losses.append(loss.detach())
                # fp32 whatever the param dtype, as in the unsharded step
                yield [g.float() for g in grads]
                del grads

        acc, lsum = None, None
        for mb in _micro(batch, accum):
            losses = []
            blocks = reduce_scatter(shard_grads(mb, losses), dims)
            lsum = psum(losses) if lsum is None else lsum + psum(losses)
            if acc is None:
                acc = blocks
            else:
                # a leaf no dim of which splits is one sum, shared by the
                # shards on its device: add it once
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
        # the global grad norm: each shard's sum of squares over its
        # blocks (a leaf no dim of which splits counts on shard 0 only),
        # summed over shards
        sq = [sum(torch.sum(torch.square(a)) for j, a in enumerate(a_s)
                  if dims[j] is not None or s == 0)
              for s, a_s in enumerate(acc)]
        gnorm = torch.sqrt(psum(sq))
        count_new, lr, scale, bc1, bc2 = adamw_scalars(
            opt_cfg, state.opt["count"], gnorm)
        for j, d in enumerate(dims):
            pst, mst, vst = p_leaves[j], m_leaves[j], v_leaves[j]
            if d is None:
                done = set()
                for s, idx in enumerate(shards):
                    trio = (mst.shards[idx], vst.shards[idx],
                            pst.shards[idx])
                    if tuple(map(id, trio)) in done:
                        continue
                    done.add(tuple(map(id, trio)))
                    adamw_leaf(opt_cfg, acc[s][j], *trio, scale, lr, bc1,
                               bc2)
                continue
            new = []
            for s, idx in enumerate(shards):
                p = pst.shards[idx]
                sl = SH.shard_slices(pst.shape, specs[j], idx)
                block = p.detach()[sl].clone()
                adamw_leaf(opt_cfg, acc[s][j], mst.shards[idx],
                           vst.shards[idx], block, scale, lr, bc1, bc2)
                new.append(block)
            whole = all_gather(new, d)
            del new
            with torch.no_grad():
                for p in {id(x): x for x in pst.shards.flat}.values():
                    p.copy_(whole.to(p.device))
            del whole
            for a_s in acc:
                a_s[j] = None
        state.opt["count"] = count_new
        state.step = state.step + 1
        return state, {"loss": loss, "nll": loss, "aux": 0.0, "lr": lr,
                       "grad_norm": gnorm}

    return train_step


# ---------------------------------------------------------------------------
# Serving-side roots
# ---------------------------------------------------------------------------
def make_prefill_step(cfg: ModelConfig, attn_impl: str = "auto"):
    """Full prefill: the paper's Full-Recomp baseline."""

    def prefill_step(params, batch):
        out = M.forward(cfg, params, tokens=batch.get("tokens"),
                        embeds=batch.get("embeds"), media=batch.get("media"),
                        positions=batch.get("positions"), mode="prefill",
                        cache=batch["cache"], attn_impl=attn_impl,
                        logits_slice="last")
        return out.logits, out.cache
    return prefill_step


def make_cachecraft_prefill_step(cfg: ModelConfig, attn_impl: str = "auto"):
    """Cache-Craft partial prefill as one step: active tokens (new chunks
    + recompute + question) against a pre-populated cache."""

    def step(params, batch):
        out = M.forward(cfg, params, tokens=batch.get("tokens"),
                        embeds=batch.get("embeds"), media=batch.get("media"),
                        positions=batch["positions"], mode="partial",
                        cache=batch["cache"], attn_impl=attn_impl,
                        logits_slice="last")
        return out.logits, out.cache
    return step


def make_decode_step(cfg: ModelConfig):
    def decode(params, batch):
        out = M.decode_step(cfg, params, batch["tokens"],
                            batch["positions"], batch["cache"])
        return out.logits, out.cache
    return decode
