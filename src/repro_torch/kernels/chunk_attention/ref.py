"""Plain PyTorch version of the chunk-attention kernel.

Position-masked GQA attention over a merged KV (cached + fresh) for an
arbitrary set of active query rows, plus the Cache-Craft attention
statistic: per query row, the softmax mass spent on keys of each chunk
id, summed over heads (the streaming form of Eqs. 3-4). The same
function as ``repro/kernels/chunk_attention/ref.py``.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

NEG_INF = -1e30


def chunk_attention_ref(q, k, v, q_pos, k_pos, k_chunk, *,
                        num_chunks: int, window: int = 0,
                        q_seg=None, k_seg=None):
    """q [A,H,D], k/v [S,Hkv,D], q_pos [A], k_pos [S], k_chunk [S].
    ``q_seg`` [A] / ``k_seg`` [S] (optional) confine attention to keys of
    the same segment (request) id.

    Returns (out [A,H,D] in q's dtype, mass [A,num_chunks] fp32)."""
    A, H, D = q.shape
    S, Hkv = k.shape[0], k.shape[1]
    G = H // Hkv
    qg = q.reshape(A, Hkv, G, D).float()
    scores = torch.einsum("ahgd,shd->hgas", qg, k.float()) / np.sqrt(D)
    mask = (q_pos[:, None] >= k_pos[None, :]) & \
        (q_pos[:, None] >= 0) & (k_pos[None, :] >= 0)
    if window:
        mask &= (q_pos[:, None] - k_pos[None, :]) < window
    if q_seg is not None and k_seg is not None:
        mask &= q_seg[:, None] == k_seg[None, :]
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=q.device)
    scores = torch.where(mask[None, None], scores, neg)
    m = torch.clamp(torch.amax(scores, -1, keepdim=True), min=NEG_INF / 2)
    e = torch.exp(scores - m)
    l = torch.sum(e, -1, keepdim=True)
    probs = torch.where(l > 0, e / torch.clamp(l, min=1e-30),
                        torch.zeros((), device=q.device))
    out = torch.einsum("hgas,shd->ahgd", probs, v.float())
    onehot = F.one_hot(k_chunk.long(), num_chunks).float()
    mass = torch.einsum("hgas,sc->ac", probs, onehot)
    return out.reshape(A, H, D).to(q.dtype), mass
