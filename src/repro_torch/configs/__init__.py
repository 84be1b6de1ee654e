"""Architecture registry of the port: the reference's registry, every
config copied with its import renamed. Its layer families: dense GQA
(the paper's own LLaMA-3 models, llama3.2-3b, deepseek-7b/67b,
musicgen-medium over precomputed frame embeddings), gemma3's
sliding-window ``local`` layers, the MoE FFN (granite-moe, phi3.5-moe),
recurrentgemma-9b's RG-LRU recurrence beside ``local`` layers,
llama-3.2-vision-90b's cross-attention to precomputed media embeddings,
and mamba2, the Mamba2 SSD family.

``get_config(name)`` returns the full production config;
``get_tiny(name)`` returns a reduced same-family config for CPU smoke
tests (small widths/depths, few experts, tiny vocab).
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

ARCHS = (
    "llama3.2-3b",
    "gemma3-4b",
    "deepseek-67b",
    "deepseek-7b",
    "recurrentgemma-9b",
    "granite-moe-1b-a400m",
    "phi3.5-moe-42b-a6.6b",
    "llama-3.2-vision-90b",
    "musicgen-medium",
    "mamba2-370m",
)

# the paper's own evaluation models (LLaMA-3 family)
PAPER_ARCHS = ("llama3-8b", "llama3-70b")

_MODULES = {
    "llama3.2-3b": "llama3_2_3b",
    "gemma3-4b": "gemma3_4b",
    "deepseek-67b": "deepseek_67b",
    "deepseek-7b": "deepseek_7b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "granite-moe-1b-a400m": "granite_moe_1b",
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe_42b",
    "llama-3.2-vision-90b": "llama3_2_vision_90b",
    "musicgen-medium": "musicgen_medium",
    "mamba2-370m": "mamba2_370m",
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
