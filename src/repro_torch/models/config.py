"""Model configuration covering all assigned architecture families.

A model is a decoder stack described by a repeating *pattern* of layer
kinds; the stack is executed as a ``lax.scan`` over pattern groups (plus
an unrolled tail when ``num_layers % len(pattern) != 0``), which keeps
compile time flat in depth for the 95-100 layer configs.

Layer kinds:
  "attn"   global causal self-attention + FFN (dense or MoE)
  "local"  sliding-window causal self-attention + FFN
  "xattn"  gated cross-attention to modality embeddings + FFN
  "rglru"  Griffin RG-LRU recurrent block + FFN
  "ssd"    Mamba2 state-space-duality block (no separate FFN)
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | hybrid | ssm | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads
    pattern: Tuple[str, ...] = ("attn",)
    window: int = 4096               # sliding window for "local" layers
    rope_theta: float = 500_000.0
    norm_eps: float = 1e-6
    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    # --- recurrent / ssm ---
    rnn_width: int = 0               # RG-LRU width (0 -> d_model)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    conv_width: int = 4
    ssd_chunk: int = 128
    # --- modality frontends (stubs) ---
    input_mode: str = "tokens"       # "tokens" | "embeds" (audio backbone)
    num_media_tokens: int = 0        # cross-attn memory length (vlm)
    # --- numerics ---
    dtype: str = "float32"
    param_dtype: str = "float32"
    remat: bool = True
    # --- cache-craft applicability ---
    supports_chunk_cache: bool = True
    # --- attention-stat collection (cache-craft metadata) ---
    stats_chunks: int = 16           # padded #chunks tracked by stat path

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def rnn_width_(self) -> int:
        return self.rnn_width or self.d_model

    @property
    def d_inner(self) -> int:        # mamba2 inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def padded_vocab(self) -> int:
        return _round_up(self.vocab_size, 256)

    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        p = self.pattern
        return tuple(p[i % len(p)] for i in range(self.num_layers))

    @property
    def n_groups(self) -> int:
        return self.num_layers // len(self.pattern)

    @property
    def n_tail(self) -> int:
        return self.num_layers % len(self.pattern)

    @property
    def attn_layer_ids(self) -> Tuple[int, ...]:
        return tuple(i for i, k in enumerate(self.layer_kinds)
                     if k in ("attn", "local"))

    @property
    def is_attention_free(self) -> bool:
        return not any(k in ("attn", "local", "xattn")
                       for k in self.layer_kinds)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ---- parameter count (for roofline MODEL_FLOPS = 6 N D) ----
    def param_count(self, active_only: bool = False) -> int:
        d, dh = self.d_model, self.head_dim_
        n = self.padded_vocab * d * 2          # embed + unembed
        for kind in self.layer_kinds:
            if kind in ("attn", "local", "xattn"):
                n += d * self.num_heads * dh        # wq
                n += 2 * d * self.num_kv_heads * dh  # wk, wv
                n += self.num_heads * dh * d         # wo
                n += 2 * d                           # norms
                if kind == "xattn":
                    n += 2                            # gates
                if self.num_experts and kind != "xattn":
                    e = (self.experts_per_token if active_only
                         else self.num_experts)
                    n += d * self.num_experts         # router (always dense)
                    n += e * (3 * d * self.d_ff)
                else:
                    n += 3 * d * self.d_ff
            elif kind == "rglru":
                r = self.rnn_width_
                n += d * r * 2 + self.conv_width * r + 3 * r + r * d + d
                n += 3 * d * self.d_ff + d            # ffn + norm
            elif kind == "ssd":
                di, ns, nh = self.d_inner, self.ssm_state, self.ssm_heads
                n += d * (2 * di + 2 * ns + nh)       # in_proj
                n += self.conv_width * di + 3 * nh + di + di * d + d
        n += d                                        # final norm
        return n


# ---------------------------------------------------------------------------
# Input shapes assigned to the LM family (seq_len, global_batch, kind)
# ---------------------------------------------------------------------------
SHAPES = {
    "train_4k":    dict(seq_len=4_096,   global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32_768,  global_batch=32,  kind="prefill"),
    "decode_32k":  dict(seq_len=32_768,  global_batch=128, kind="decode"),
    "long_500k":   dict(seq_len=524_288, global_batch=1,   kind="decode"),
}

# Archs allowed to run long_500k (sub-quadratic / constant-state): the
# 8 pure-full-attention archs are skipped per DESIGN.md §6.
LONG_CONTEXT_ARCHS = ("mamba2-370m", "recurrentgemma-9b")
