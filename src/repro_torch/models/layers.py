"""Layer primitives of the dense attention family, in PyTorch.

The main-path subset of ``repro/models/layers.py``: RMS norm, RoPE
(apply and remove), position masks with segment ids, the dense GQA
attention oracle with the Cache-Craft chunk-mass statistic, one-token
decode attention and the SwiGLU FFN. Every function keeps the JAX
signature and layout (``[B, T, H, D]``), so the tests feed both packages
the same numpy arrays and compare like with like.

All attention helpers take explicit *position vectors* for Q and K
rather than assuming a triangular layout: that is what lets Cache-Craft's
partial prefill (scattered recompute tokens attending to merged KV) run
through the same code as a full prefill.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

NEG_INF = -1e30


def rms_norm(x: torch.Tensor, w: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMS norm with the reference's ``1 + w`` scale (zero-init ``w``)."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + w.float())).to(dt)


# ---------------------------------------------------------------------------
# RoPE (rotate-half convention; inverse == rotation by -theta, used to store
# chunk-caches position-independently, paper §4 "RPE Management").
# ---------------------------------------------------------------------------
def _inv_freq(dim: int, theta: float) -> np.ndarray:
    # the reference's exact fp32 expression, so both packages start from
    # the same frequencies bit for bit
    return 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float32) / dim))


def rope_cos_sin(pos: torch.Tensor, dim: int, theta: float):
    """pos [..., T] -> cos, sin [..., T, dim//2] (fp32)."""
    freqs = torch.from_numpy(_inv_freq(dim, theta)).to(pos.device)
    ang = pos.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, pos: torch.Tensor, theta: float,
               inverse: bool = False) -> torch.Tensor:
    """x [..., T, H, D], pos broadcastable to x[..., T]. ``inverse=True``
    undoes the rotation (the paper's "RPE removal" math)."""
    d = x.shape[-1]
    cos, sin = rope_cos_sin(pos, d, theta)
    if inverse:
        sin = -sin
    cos = cos[..., None, :]                       # [..., T, 1, D/2]
    sin = sin[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention masks from position vectors
# ---------------------------------------------------------------------------
def position_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, window: int = 0,
                  k_valid: Optional[torch.Tensor] = None,
                  q_seg: Optional[torch.Tensor] = None,
                  k_seg: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B,Tq], [B,Tk] -> bool [B,Tq,Tk]. Causal by absolute position,
    optional sliding window, invalid (padding) K slots masked.

    ``q_seg``/``k_seg`` [B,Tq]/[B,Tk] carry per-token segment (request)
    ids for cross-request token packing: attention stays within keys of
    the same segment."""
    qp = q_pos[:, :, None]
    kp = k_pos[:, None, :]
    m = (qp >= kp) & (qp >= 0) & (kp >= 0)
    if window:
        m &= (qp - kp) < window
    if k_valid is not None:
        m &= k_valid[:, None, :]
    if q_seg is not None and k_seg is not None:
        m &= q_seg[:, :, None] == k_seg[:, None, :]
    return m


def _safe_softmax(scores: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Softmax that returns zeros (not NaN) for fully masked rows."""
    m = torch.amax(scores, dim=dim, keepdim=True)
    m = torch.clamp(m, min=NEG_INF / 2)
    e = torch.exp(scores - m)
    s = torch.sum(e, dim=dim, keepdim=True)
    return torch.where(s > 0, e / torch.clamp(s, min=1e-30),
                       torch.zeros((), dtype=e.dtype, device=e.device))


# ---------------------------------------------------------------------------
# Dense GQA attention with optional Cache-Craft attention statistics: the
# oracle every backend and kernel is held against.
# ---------------------------------------------------------------------------
def gqa_attend_dense(q, k, v, mask, k_chunk: Optional[torch.Tensor] = None,
                     num_chunks: int = 0):
    """q [B,Tq,H,D], k/v [B,Tk,Hkv,D], mask [B,Tq,Tk].

    Returns ``(out [B,Tq,H,D], row_mass [B,Tq,C] | None, key_mass [B,Tk]
    | None)``: ``row_mass[b,i,c]`` is the softmax probability token ``i``
    spends on keys of chunk ``c``, summed over heads (the streaming
    statistic behind Eqs. 3-4); ``key_mass`` is the mass each key
    receives (the H2O heavy-hitter criterion)."""
    B, Tq, H, D = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    qg = q.reshape(B, Tq, Hkv, G, D)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(),
                          k.float()) / np.sqrt(D)
    scores = torch.where(mask[:, None, None], scores,
                         torch.full((), NEG_INF, dtype=scores.dtype,
                                    device=scores.device))
    probs = _safe_softmax(scores)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype), v)
    out = out.reshape(B, Tq, H, D)
    row_mass, key_mass = None, None
    if k_chunk is not None:
        onehot = F.one_hot(k_chunk.long(), num_chunks).float()
        row_mass = torch.einsum("bhgqk,bkc->bqc", probs, onehot)
        key_mass = probs.sum(dim=(1, 2, 3))
    return out, row_mass, key_mass


def decode_attend(q, k, v, q_pos, k_pos, window: int = 0):
    """Single-step decode: q [B,H,D] vs KV [B,S,Hkv,D] -> [B,H,D]."""
    out = gqa_attend_dense(
        q[:, None], k, v, position_mask(q_pos[:, None], k_pos, window))[0]
    return out[:, 0]


# ---------------------------------------------------------------------------
# FFN
# ---------------------------------------------------------------------------
def swiglu(x, wi, wo):
    """wi [d,2,F], wo [F,d]; output in x's dtype."""
    d = wi.shape[0]
    gu = (x.reshape(-1, d) @ wi.reshape(d, -1)).reshape(
        *x.shape[:-1], 2, wi.shape[-1])
    h = F.silu(gu[..., 0, :]) * gu[..., 1, :]
    return (h @ wo).to(x.dtype)
