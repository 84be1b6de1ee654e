"""Architecture registry of the port: the configs whose layer families
the port runs so far (the paper's own LLaMA-3 models, dense GQA).

``get_config(name)`` returns the full production config;
``get_tiny(name)`` returns a reduced same-family config for CPU smoke
tests (small widths/depths, tiny vocab). The other architectures of
the reference registry come over with their layer families.
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

ARCHS = ("llama3-8b", "llama3-70b")

# the paper's own evaluation models (LLaMA-3 family)
PAPER_ARCHS = ("llama3-8b", "llama3-70b")

_MODULES = {
    "llama3-8b": "llama3_8b",
    "llama3-70b": "llama3_70b",
}


def get_config(name: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG


def get_tiny(name: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.TINY


def list_archs():
    return ARCHS
