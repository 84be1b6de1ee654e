"""Plain PyTorch version of the SSD intra-chunk kernel: the same function
as ``repro/kernels/ssd/ref.py`` (the intra-chunk and chunk-state math of
``repro.models.layers.ssd_chunked``), on the same layouts.

One deliberate difference: the log-decay between two steps is summed
over its own segment, not taken as a difference of prefix sums (see
``_segsum``)."""
from __future__ import annotations

import torch


def _segsum(log_a: torch.Tensor) -> torch.Tensor:
    """log_a [..., L] -> [..., L, L]: entry (i, j) is the log-decay from
    input step j to output step i, ``sum(log_a[j+1 : i+1])``, for i >= j,
    and ``-inf`` above the diagonal, so its exponential is the causal
    decay matrix.

    The reference (``models/layers.py``) forms it as ``cumsum_i -
    cumsum_j``. At mamba2-370m's decay (log_a near -3.6 a step) the
    prefix sums reach about -460 over a 128-step chunk, and that
    difference keeps only ~1e-5 of relative accuracy where the decay is
    largest, near the diagonal; two fp32 prefix sums taken in different
    orders (a sequential loop, the card's parallel scan) then disagree by
    more than 3e-5 in the output. Here each column j is a running sum of
    ``log_a[j+1..i]`` down the rows, so every entry is a sum of terms of
    one sign, accurate to a few ulps."""
    L = log_a.shape[-1]
    tril = torch.ones((L, L), dtype=torch.bool, device=log_a.device).tril()
    x = log_a[..., :, None].expand(*log_a.shape, L)       # (k, j) -> la_k
    x = x.masked_fill(~tril.tril(-1), 0.0)                # keep k > j
    return x.cumsum(dim=-2).masked_fill(~tril, float("-inf"))


def ssd_intra_ref(xdt, log_a, B_mat, C_mat):
    """xdt [nC,L,H,P] (x pre-multiplied by dt), log_a [nC,L,H], B/C
    [nC,L,N], any float type. Returns ``(y_intra [nC,L,H,P] fp32,
    chunk_state [nC,H,P,N] fp32)``::

        y[c,i,h,:]     = sum_{j<=i} exp(seg_ij) (C_i . B_j) xdt[c,j,h,:]
        state[c,h,p,n] = sum_l exp(seg_{L-1,l}) B[c,l,n] xdt[c,l,h,p]

    with ``seg_ij = sum(log_a[c, j+1 : i+1, h])``."""
    x = xdt.float()
    Bm = B_mat.float()
    Cm = C_mat.float()
    seg = _segsum(log_a.float().transpose(1, 2))          # [nC,H,L,L]
    decay = torch.exp(seg)
    scores = torch.einsum("cin,cjn->cij", Cm, Bm)         # [nC,L,L]
    y = torch.einsum("chij,cjhp->cihp", decay * scores[:, None], x)
    decay_out = decay[:, :, -1].transpose(1, 2)           # [nC,L,H]
    st = torch.einsum("cln,clhp->chpn", Bm, x * decay_out[..., None])
    return y, st
