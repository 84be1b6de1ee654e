"""Serving-side step functions: the roots the reference's dry-run lowers
and its launchers execute (``repro/training/steps.py``), as plain
closures ``(params, batch) -> (logits, cache)`` over ``models.model``.

``batch`` holds ``tokens``, ``positions`` (optional for the full
prefill) and ``cache``, which is updated in place. The reference's
``embeds`` / ``media`` inputs come with the families that take them, and
the train step (microbatch accumulation, remat, AdamW) with the training
port (ROADMAP A9).
"""
from __future__ import annotations

from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig


def make_prefill_step(cfg: ModelConfig, attn_impl: str = "auto"):
    """Full prefill: the paper's Full-Recomp baseline."""

    def prefill_step(params, batch):
        out = M.forward(cfg, params, tokens=batch["tokens"],
                        positions=batch.get("positions"), mode="prefill",
                        cache=batch["cache"], attn_impl=attn_impl,
                        logits_slice="last")
        return out.logits, out.cache
    return prefill_step


def make_cachecraft_prefill_step(cfg: ModelConfig, attn_impl: str = "auto"):
    """Cache-Craft partial prefill as one step: active tokens (new chunks
    + recompute + question) against a pre-populated cache."""

    def step(params, batch):
        out = M.forward(cfg, params, tokens=batch["tokens"],
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
