"""Plain PyTorch versions of the decode kernels: the model's dense decode
path, over a dense KV arena and over the pool's block arena (gather the
request's blocks, then the dense oracle). The same functions as
``repro/kernels/decode_attention/ref.py``."""
from __future__ import annotations

import torch

from repro_torch.models.layers import decode_attend


def decode_attention_ref(q, k, v, q_pos, k_pos, *, window: int = 0):
    """q [B,H,D], k/v [B,S,Hkv,D], q_pos [B], k_pos [B,S] -> [B,H,D]."""
    return decode_attend(q, k, v, q_pos, k_pos, window=window)


def paged_decode_attention_ref(q, k_blocks, v_blocks, kpos_blocks,
                               block_rows, q_pos, *, window: int = 0):
    """q [B,H,D]; k_blocks/v_blocks [NB, bs, Hkv, D]; kpos_blocks
    [NB, bs]; block_rows [B, NBmax] (-1 padded); q_pos [B] -> [B,H,D]."""
    B = q.shape[0]
    bs = k_blocks.shape[1]
    NBmax = block_rows.shape[1]
    rows = block_rows.long()
    safe = rows.clamp(min=0)
    kb = k_blocks[safe].reshape(B, NBmax * bs, *k_blocks.shape[2:])
    vb = v_blocks[safe].reshape(B, NBmax * bs, *v_blocks.shape[2:])
    pb = kpos_blocks[safe].reshape(B, NBmax * bs)
    live = (rows >= 0).repeat_interleave(bs, dim=1)
    pb = torch.where(live, pb, torch.full_like(pb, -1))
    return decode_attend(q, kb, vb, q_pos, pb, window=window)
