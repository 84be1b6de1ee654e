"""Step functions of the port (``repro/training/steps.py``): the train
step, and the serving-side roots the reference's dry-run lowers and its
launchers execute.

``make_train_step`` builds a train step with microbatch accumulation
(grads summed in fp32 in microbatch order, then averaged), remat per
layer group (``cfg.remat``, set in the model) and AdamW. The params of a
``TrainState`` are leaf tensors that require grad; the serving engine
and executor run under ``torch.no_grad()``, and params restored for
serving (``serving/api.py``, ``params_path``) carry no grad. The
reference's int8 error-feedback gradient all-reduce is ported as
``distributed/compression.py`` over per-shard gradient trees; the train
step's ``grad_specs`` (grads laid out over a data-parallel mesh) waits
for a multi-process mesh (ROADMAP A10).

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

from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.training.optimizer import (AdamWConfig, adamw_init,
                                            adamw_update, tree_leaves,
                                            tree_map, tree_unflatten)

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


def loss_fn(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor]):
    """Next-token CE on fp32 logits (labels shifted by the data pipeline;
    labels < 0 are masked), plus ``MOE_AUX_COEF`` x the MoE aux loss.
    The inputs are ``batch["tokens"]`` or ``batch["embeds"]``, and
    ``batch["media"]`` where the config has cross-attention layers."""
    out = M.forward(cfg, params, tokens=batch.get("tokens"),
                    embeds=batch.get("embeds"), media=batch.get("media"),
                    mode="train")
    logits = out.logits.float()
    labels = batch["labels"].long()
    logp = F.log_softmax(logits, dim=-1)
    take = logp.gather(-1, labels.clamp(min=0)[..., None])[..., 0]
    mask = (labels >= 0).float()
    nll = -(take * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    loss = nll + MOE_AUX_COEF * out.aux_loss
    return loss, {"nll": nll, "aux": out.aux_loss}


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    accum: int = 1) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``. ``batch``
    leaves are ``[global_batch, ...]`` tensors on the params' device;
    with ``accum > 1`` the batch is split into ``accum`` microbatches run
    one after another (activation memory / accum), their grads summed in
    fp32 in order and divided by ``accum``. The state's params, moments
    and step are updated in place."""

    def train_step(state: TrainState, batch):
        params = state.params
        leaves = list(tree_leaves(params))
        if accum == 1:
            loss, aux = loss_fn(cfg, params, batch)
            flat = torch.autograd.grad(loss, leaves)
        else:
            micro = [{k: v.reshape(accum, v.shape[0] // accum, *v.shape[1:])
                      [i] for k, v in batch.items()} for i in range(accum)]
            lsum = 0.0
            for i, mb in enumerate(micro):
                loss, _ = loss_fn(cfg, params, mb)
                grads = torch.autograd.grad(loss, leaves)
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
