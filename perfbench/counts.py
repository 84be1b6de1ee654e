"""The yardstick's arithmetic: the card's peaks and the closed-form
operations and bytes of the model's work and of each attention kernel
call, counted from what the inputs need, whatever implements them.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates without
sparsity, at the 700 W power limit; the constants of
``src/repro_torch/launch/roofline.py``). A share of a peak is stated
against these, with the card's power limit beside it.
"""
from __future__ import annotations

from typing import Dict

PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "tf32": 495e12,
              "float32": 67e12}
HBM_BW = 3.35e12            # bytes/s
HBM_BYTES = 80e9


def linear_flops_per_token(m: Dict) -> float:
    """Matrix-product FLOPs of one token through one layer, attention
    scores excluded: q/k/v/o projections and the FFN (the router and the
    ``experts_per_token`` experts a token reaches, for an MoE FFN)."""
    d, h, hkv, dh, f = (m["d_model"], m["num_heads"], m["num_kv_heads"],
                        m["head_dim"], m["d_ff"])
    proj = 2 * d * (h + 2 * hkv) * dh + 2 * h * dh * d
    if m.get("num_experts"):
        ffn = 2 * d * m["num_experts"] + \
            m["experts_per_token"] * 6 * d * f
    else:
        ffn = 6 * d * f
    return float(proj + ffn)


def attention_flops(m: Dict, pairs: float) -> float:
    """Scores and weighted values of ``pairs`` live (query, key) pairs in
    one layer: 2 FLOPs per multiply-add, two products, every q head."""
    return 4.0 * pairs * m["num_heads"] * m["head_dim"]


def head_flops(m: Dict) -> float:
    """The LM head's logits of one row."""
    return 2.0 * m["d_model"] * m["vocab_size"]


def token_flops(m: Dict, layers: int, ctx: int) -> float:
    """One token through ``layers`` layers attending ``ctx`` keys each."""
    return layers * (linear_flops_per_token(m) + attention_flops(m, ctx))


def bound_seconds(flops: float, nbytes: float, dtype: str) -> float:
    """Least time the card could take: the larger of the operations over
    the peak of ``dtype``'s tensor cores and the bytes over HBM's rate."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / HBM_BW)


_ITEM = {"torch.float32": 4, "torch.bfloat16": 2, "torch.float16": 2}


def itemsize(dtype) -> int:
    return _ITEM[str(dtype)]


def chunk_call(q_shape, k_shape, q_dtype, k_dtype, live_q: int,
               live_pairs: float, live_keys: int, num_chunks: int):
    """(FLOPs, bytes) of one chunk-attention call: every live query row
    and every live key read once, the output and the chunk mass written
    once, the positions and segment ids of live rows and keys read once.
    ``live_*`` count rows with a position >= 0; pairs are the (query, key)
    pairs the causal, per-request mask lets through."""
    H, D = q_shape[-2], q_shape[-1]
    hkv = k_shape[-2]
    qb, kb = itemsize(q_dtype), itemsize(k_dtype)
    flops = 4.0 * live_pairs * H * D
    nbytes = live_q * H * D * qb * 2 + live_keys * hkv * D * kb * 2 + \
        live_q * num_chunks * 4 + (live_q + live_keys) * 8
    return flops, nbytes


def decode_call(q_shape, k_shape, q_dtype, k_dtype, live_rows: int,
                live_keys: int):
    """(FLOPs, bytes) of one decode-attention call: each live row's query
    and output once, each of its live keys (positions <= its own) read
    once with its position."""
    H, D = q_shape[-2], q_shape[-1]
    hkv = k_shape[-2]
    qb, kb = itemsize(q_dtype), itemsize(k_dtype)
    flops = 4.0 * live_keys * H * D
    nbytes = live_rows * H * D * qb * 2 + live_keys * (hkv * D * kb * 2 + 4)
    return flops, nbytes
