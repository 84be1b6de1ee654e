"""Layer primitives of every family of the reference's registry, in
PyTorch.

The ported ``repro/models/layers.py``: RMS norm, RoPE (apply and
remove), position masks with segment ids, the dense GQA attention oracle
with the Cache-Craft chunk-mass statistic, the blocked flash attention of
long prompts (with its balanced ``causal_skip`` schedule and its
context-parallel form over a mesh axis, ``gqa_attend_flash_cp``),
one-token decode attention, the SwiGLU FFN, the GShard MoE FFN
with its load-balancing loss, Griffin's RG-LRU recurrence (a log-step
scan over the sequence and the one-token step), and the Mamba2 pieces
(causal depthwise conv, chunked SSD prefill through the ``ssd_intra``
kernel and its differentiable training route, one-step SSD decode).
Every function
keeps the JAX signature and layout (``[B, T, H, D]``), so the tests feed
both packages the same numpy arrays and compare like with like.

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

from repro_torch.distributed.collectives import all_gather, shard_map
from repro_torch.distributed.sharding import P
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd.ref import ssd_intra_ref

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
    Tk, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    # the products one KV head at a time, each on a contiguous [B, ...]
    # slice: the library picks its matmul kernel by the shapes, the batch
    # included, so a head shard of the serving mesh gets the whole call's
    # bits only from calls of the same shapes; the row-wise softmax keeps
    # each row's order whatever the number of rows
    qh = q.float().view(B, Tq, Hkv, G, D).permute(2, 0, 3, 1, 4) \
        .contiguous().view(Hkv, B, G * Tq, D)
    kt = k.float().permute(2, 0, 3, 1).contiguous()     # [Hkv, B, D, Tk]
    vh = v.permute(2, 0, 1, 3).contiguous()             # [Hkv, B, Tk, D]
    scores = torch.stack([torch.matmul(qh[h], kt[h]) for h in range(Hkv)])
    scores = scores.view(Hkv, B, G, Tq, Tk) / np.sqrt(D)
    scores = torch.where(mask[None, :, None], scores,
                         torch.full((), NEG_INF, dtype=scores.dtype,
                                    device=scores.device))
    probs = _safe_softmax(scores)                       # [Hkv,B,G,Tq,Tk]
    pv = probs.to(v.dtype).view(Hkv, B, G * Tq, Tk)
    out = torch.stack([torch.matmul(pv[h], vh[h]) for h in range(Hkv)])
    out = out.view(Hkv, B, G, Tq, D).permute(1, 3, 0, 2, 4) \
        .reshape(B, Tq, H, D)
    row_mass, key_mass = None, None
    if k_chunk is not None:
        onehot = F.one_hot(k_chunk.long(), num_chunks).float()
        row_mass = torch.einsum("hbgqk,bkc->bqc", probs, onehot)
        key_mass = probs.sum(dim=(0, 2, 3))
    return out, row_mass, key_mass


# ---------------------------------------------------------------------------
# Flash-style blocked attention (plain PyTorch, as the reference's is plain
# JAX): a loop over KV blocks with a running max / denominator, memory
# O(Tq * block). ``causal_skip`` visits, for q block i, only the kv blocks
# j with j * block_k < (i + 1) * block_q (positions known to be row-major),
# which halves the score work of a full causal prefill.
# ---------------------------------------------------------------------------
def gqa_attend_flash(q, k, v, q_pos, k_pos, window: int = 0,
                     block_q: int = 1024, block_k: int = 1024,
                     causal_skip: bool = False):
    """q [B,Tq,H,D], k/v [B,Tk,Hkv,D], q_pos [B,Tq], k_pos [B,Tk] ->
    out [B,Tq,H,D] in v's dtype. Ragged edges are padded with zeros at
    position -1, which the position mask drops."""
    B, Tq, H, D = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    block_q = min(block_q, Tq)
    block_k = min(block_k, Tk)
    nq, nk = -(-Tq // block_q), -(-Tk // block_k)
    pq, pk = nq * block_q - Tq, nk * block_k - Tk
    if pq:
        q = F.pad(q, (0, 0, 0, 0, 0, pq))
        q_pos = F.pad(q_pos, (0, pq), value=-1)
    if pk:
        k = F.pad(k, (0, 0, 0, 0, 0, pk))
        v = F.pad(v, (0, 0, 0, 0, 0, pk))
        k_pos = F.pad(k_pos, (0, pk), value=-1)
    qb = q.reshape(B, nq, block_q, Hkv, G, D).float()
    qpb = q_pos.reshape(B, nq, block_q)
    kb = k.reshape(B, nk, block_k, Hkv, D).float()
    vb = v.reshape(B, nk, block_k, Hkv, D).float()
    kpb = k_pos.reshape(B, nk, block_k)
    scale = 1.0 / np.sqrt(D)
    outs = []
    for i in range(nq):
        need = min(nk, -(-((i + 1) * block_q) // block_k)) \
            if causal_skip else nk
        qi, qp = qb[:, i], qpb[:, i]
        carry = (torch.full((B, block_q, Hkv, G), NEG_INF,
                            dtype=torch.float32, device=q.device),
                 torch.zeros((B, block_q, Hkv, G), dtype=torch.float32,
                             device=q.device),
                 torch.zeros((B, block_q, Hkv, G, D), dtype=torch.float32,
                             device=q.device))
        for j in range(need):
            carry = _flash_kv_step(carry, (kb[:, j], vb[:, j], kpb[:, j]),
                                   qi, qp, scale, window)
        _m, l, acc = carry
        outs.append(acc / torch.clamp(l, min=1e-30)[..., None])
    out = torch.stack(outs, dim=1).reshape(B, nq * block_q, H, D)[:, :Tq]
    return out.to(v.dtype)


def _flash_kv_step(carry, blk, qi, qp, scale, window):
    """One KV block of the online softmax: (m, l, acc) -> updated."""
    m, l, acc = carry
    ki, vi, kp = blk
    s = torch.einsum("bqhgd,bkhd->bqhgk", qi, ki) * scale
    msk = position_mask(qp, kp, window)
    s = torch.where(msk[:, :, None, None, :], s,
                    torch.full((), NEG_INF, dtype=s.dtype, device=s.device))
    m_new = torch.maximum(m, torch.amax(s, dim=-1))
    m_new = torch.clamp(m_new, min=NEG_INF / 2)
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l = l * corr + torch.sum(p, dim=-1)
    acc = acc * corr[..., None] + torch.einsum("bqhgk,bkhd->bqhgd", p, vi)
    return m_new, l, acc


def gqa_attend_flash_cp(q, k, v, q_pos, k_pos, mesh, window: int = 0,
                        axis: str = "model", block_k: int = 1024):
    """Context-parallel flash attention: query rows split over the mesh
    ``axis``, each shard attending its slice of rows against the full KV
    (the answer for head counts that do not divide the axis). Rows are
    padded to a multiple of the axis size at position -1; positions
    travel with the rows, so causality is exact despite the split. The
    shards' outputs are concatenated in shard order and the padding cut
    (``distributed.collectives``)."""
    msz = mesh.shape[axis]
    T = q.shape[1]
    pad = (-T) % msz
    if pad:
        q = F.pad(q, (0, 0, 0, 0, 0, pad))
        q_pos = F.pad(q_pos, (0, pad), value=-1)

    def body(qs, qps, kf, vf, kps):
        return gqa_attend_flash(qs, kf, vf, qps, kps, window,
                                block_q=max(128, qs.shape[1] // 4),
                                block_k=block_k)

    outs = shard_map(body, mesh=mesh,
                     in_specs=(P(None, axis, None, None), P(None, axis),
                               P(), P(), P()),
                     axis=axis)(q, q_pos, k, v, k_pos)
    return all_gather(outs, dim=1)[:, :T]


def decode_attend(q, k, v, q_pos, k_pos, window: int = 0):
    """Single-step decode: q [B,H,D] vs KV [B,S,Hkv,D] -> [B,H,D]."""
    out = gqa_attend_dense(
        q[:, None], k, v, position_mask(q_pos[:, None], k_pos, window))[0]
    return out[:, 0]


# ---------------------------------------------------------------------------
# FFNs
# ---------------------------------------------------------------------------
def swiglu(x, wi, wo):
    """wi [d,2,F], wo [F,d]; output in x's dtype."""
    d = wi.shape[0]
    gu = (x.reshape(-1, d) @ wi.reshape(d, -1)).reshape(
        *x.shape[:-1], 2, wi.shape[-1])
    h = F.silu(gu[..., 0, :]) * gu[..., 1, :]
    return (h @ wo).to(x.dtype)


def moe_groups(T: int, group_size: int = 512, total: Optional[int] = None):
    """(g, gs): g the GShard group, the largest divisor of the token
    count ``total`` (default ``T``) up to ``group_size``; gs = gcd(T, g),
    the groups ``T`` consecutive tokens of those ``total`` are cut into
    (a data shard's rows of a global microbatch), each inside one g-token
    group."""
    total = T if total is None else total
    g = min(group_size, total)
    while total % g:
        g -= 1
    return g, int(np.gcd(T, g))


def moe_capacity(g: int, k: int, capacity_factor: float, E: int) -> int:
    """Slots per expert and group: max(4, ceil(g k cf / E))."""
    return max(4, int(np.ceil(g * k * capacity_factor / E)))


def moe_route(xg, router_w, k: int):
    """xg [G, g, d] -> (router probs [G, g, E] fp32, the top-k gates
    renormalised over the k [G, g, k], their expert ids [G, g, k]); ties
    go to the lower expert id, as ``jax.lax.top_k``."""
    logits = torch.einsum("gtd,de->gte", xg.float(), router_w.float())
    probs = torch.softmax(logits, dim=-1)
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals = top.values[..., :k]
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)
    return probs, gate_vals, top.indices[..., :k]


def moe_slots(gate_idx, C: int, E: int):
    """The GShard dispatch of expert ids [G, g, k]: each round i takes its
    tokens in cumsum order after the kept tokens of the rounds before it,
    up to C per expert and group. Returns (slot [G, g, k] long, kept
    [G, g, k] bool). Integers only: no gradient."""
    counts = torch.zeros((gate_idx.shape[0], E), dtype=torch.long,
                         device=gate_idx.device)
    pos_k, keep_k = [], []
    for i in range(gate_idx.shape[-1]):
        oh = F.one_hot(gate_idx[..., i], E)                  # [G,g,E]
        pos = torch.cumsum(oh, dim=1) - 1 + counts[:, None, :]
        keep = (pos < C) & (oh > 0)
        counts = counts + (oh * keep).sum(dim=1)
        sel = gate_idx[..., i, None]
        pos_k.append(pos.gather(-1, sel)[..., 0])
        keep_k.append(keep.gather(-1, sel)[..., 0])
    return torch.stack(pos_k, -1), torch.stack(keep_k, -1)


def moe_experts(xg, gate_vals, gate_idx, slot, kept, wi, wo, C: int,
                e0: int = 0):
    """Experts e0 .. e0 + wi.shape[0] of the GShard FFN on the tokens xg
    [G, g, d] dispatched by ``moe_slots`` (the overflow dropped), their
    outputs combined with the gates: [G, g, d] fp32. wi [E', d, 2, F], wo
    [E', F, d]. A token routed to no expert of the range adds nothing, so
    the experts of a model shard give a partial sum."""
    G, g = xg.shape[:2]
    E_ = wi.shape[0]
    dt = xg.dtype
    dispatch = torch.zeros((G, g, E_, C), dtype=dt, device=xg.device)
    combine = torch.zeros((G, g, E_, C), dtype=torch.float32,
                          device=xg.device)
    for i in range(gate_idx.shape[-1]):
        e = gate_idx[..., i] - e0
        mine = kept[..., i] & (e >= 0) & (e < E_)
        # slot C is the drop column (the reference's one_hot of -1)
        at = F.one_hot(torch.where(mine, slot[..., i], C), C + 1)[..., :C]
        oh = F.one_hot(e.clamp(0, E_ - 1), E_)
        disp_i = (oh[..., None] * at[..., None, :]).to(dt)   # [G,g,E',C]
        dispatch = dispatch + disp_i
        combine = combine + disp_i.float() * gate_vals[..., i, None, None]

    ein = torch.einsum("gtec,gtd->gecd", dispatch.float(),
                       xg.float()).to(dt)
    a = torch.einsum("gecd,edf->gecf", ein.float(),
                     wi[:, :, 0].float()).to(dt)
    b = torch.einsum("gecd,edf->gecf", ein.float(),
                     wi[:, :, 1].float()).to(dt)
    hid = F.silu(a) * b
    out_e = torch.einsum("gecf,efd->gecd", hid.float(), wo.float())
    return torch.einsum("gtec,gecd->gtd", combine, out_e)


def moe_ffn(x, router_w, wi, wo, *, experts_per_token: int,
            capacity_factor: float, group_size: int = 512):
    """GShard-style einsum-dispatch MoE, the reference's function.

    x [..., d] is flattened to [T, d] and cut into G groups of g tokens (g
    the largest divisor of T up to ``group_size``). Each token's top-k
    experts (gates renormalised over the k) take it in cumsum order up to
    the capacity C = max(4, ceil(g k cf / E)) per expert and group; the
    overflow is dropped. router_w [d, E], wi [E, d, 2, F], wo [E, F, d].
    Returns (out like x, router probs [G, g, E] fp32)."""
    d = x.shape[-1]
    T = x.numel() // d
    E = router_w.shape[-1]
    k = experts_per_token
    g, _ = moe_groups(T, group_size)
    xg = x.reshape(T // g, g, d)
    C = moe_capacity(g, k, capacity_factor, E)
    probs, gate_vals, gate_idx = moe_route(xg, router_w, k)
    slot, kept = moe_slots(gate_idx, C, E)
    out = moe_experts(xg, gate_vals, gate_idx, slot, kept, wi, wo, C)
    return out.reshape(x.shape).to(x.dtype), probs


def moe_aux_loss(probs, num_experts: int) -> torch.Tensor:
    """Switch-style load-balancing loss (mean fraction * mean prob * E)."""
    lead = tuple(range(probs.dim() - 1))
    me = probs.mean(dim=lead)
    fe = F.one_hot(probs.argmax(dim=-1), num_experts).float().mean(dim=lead)
    return num_experts * torch.sum(me * fe)


# ---------------------------------------------------------------------------
# Griffin RG-LRU recurrent block (recurrentgemma)
# ---------------------------------------------------------------------------
_RGLRU_C = 8.0


def _rglru_coeffs(b, lam, alpha, beta):
    """Per-step decay ``a`` and input ``u`` of h_t = a_t h_{t-1} + u_t."""
    r = torch.sigmoid(alpha * b)
    i = torch.sigmoid(beta * b)
    log_a = -_RGLRU_C * F.softplus(lam) * r
    a = torch.exp(log_a)
    u = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) * \
        (i * b)
    return a, u


def rglru_scan(b, lam, alpha, beta, h0=None):
    """b [B,S,R] -> (y [B,S,R] in b's dtype, h_last [B,R] fp32), computed
    in fp32. The linear recurrence runs as a Hillis-Steele scan over the
    time axis: ceil(log2 S) rounds of whole-tensor ops, each combining
    step t with step t - k (k = 1, 2, 4, ...), differentiable by autograd.
    The reference's ``associative_scan`` combines in another tree order,
    so the two agree to rounding, not bit for bit."""
    a, u = _rglru_coeffs(b.float(), lam, alpha, beta)
    if h0 is not None:
        u = torch.cat([u[:, :1] + a[:, :1] * h0[:, None].float(), u[:, 1:]],
                      dim=1)
    S, k = b.shape[1], 1
    while k < S:
        # (a1, u1) then (a2, u2) -> (a1 a2, a2 u1 + u2), step t - k first
        u = torch.cat([u[:, :k], a[:, k:] * u[:, :-k] + u[:, k:]], dim=1)
        if 2 * k < S:           # the last round needs no decays
            a = torch.cat([a[:, :k], a[:, k:] * a[:, :-k]], dim=1)
        k *= 2
    return u.to(b.dtype), u[:, -1]


def rglru_step(b, lam, alpha, beta, h):
    """One decode step: b [B,R], h [B,R] fp32 -> (y in b's dtype, h)."""
    a, u = _rglru_coeffs(b.float(), lam, alpha, beta)
    h = a * h + u
    return h.to(b.dtype), h


# ---------------------------------------------------------------------------
# Mamba2 (the causal conv is Griffin's too)
# ---------------------------------------------------------------------------
def causal_conv1d(x, w, state=None):
    """x [B,S,R], w [W,R]; returns (y, new_state [B,W-1,R]): the last W-1
    inputs, carried state included."""
    W = w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], W - 1, x.shape[2]), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state, x], dim=1)
    S = x.shape[1]
    y = sum(xp[:, i:i + S] * w[i] for i in range(W))
    return y.to(x.dtype), xp[:, -(W - 1):] if W > 1 else state


def ssd_chunked(x, dt, A_log, B_mat, C_mat, D, chunk: int, state0=None,
                train: bool = False):
    """SSD forward (state-space duality, chunked).

    x [B,S,H,P], dt [B,S,H] (already softplus'ed), A_log [H], B_mat/C_mat
    [B,S,N], D [H]. Returns (y [B,S,H,P], state [B,H,P,N] fp32). The
    inter-chunk recurrence and the ``D`` skip run here. The intra-chunk
    term and the chunk states come from the ``ssd_intra`` kernel (its
    plain version on CPU tensors) when serving; with ``train=True`` they
    come from the same function written in differentiable tensor ops
    (``ssd_intra_ref``: the reference's einsums, with the per-segment
    ``_segsum``), on any device. That is the reference's own training
    route (its ``ssd_chunked`` never reaches the Pallas kernel), chosen by
    the caller's mode, not a fallback: the kernel has no backward, and
    its wrapper raises rather than drop the gradient. Tensors on the
    ``meta`` device (shapes only, the dry-run's accounting) take the
    same tensor-op route: the kernel launches on ``cuda`` tensors only."""
    Bsz, S, H, Pd = x.shape
    N = B_mat.shape[-1]
    L = min(chunk, S)
    while S % L:
        L -= 1
    nC = S // L
    a = -torch.exp(A_log.float())                         # [H]
    log_a = dt.float() * a                                # [B,S,H]
    xdt = x.float() * dt.float()[..., None]

    xc = xdt.reshape(Bsz, nC, L, H, Pd)
    lac = log_a.reshape(Bsz, nC, L, H)
    # B and C arrive as column slices of the in-projection
    Bc = B_mat.float().contiguous().reshape(Bsz, nC, L, N)
    Cc = C_mat.float().contiguous().reshape(Bsz, nC, L, N)
    if train or x.device.type == "meta":
        y_intra, chunk_state = (t.unflatten(0, (Bsz, nC)) for t in
                                ssd_intra_ref(xc.flatten(0, 1),
                                              lac.flatten(0, 1),
                                              Bc.flatten(0, 1),
                                              Cc.flatten(0, 1)))
    else:
        y_intra, chunk_state = ssd_ops.ssd_intra(xc, lac, Bc, Cc)

    # inter-chunk recurrence over chunk states
    cum = torch.cumsum(lac, dim=2)                        # [B,nC,L,H]
    total = cum[:, :, -1]                                 # [B,nC,H]
    s = (torch.zeros((Bsz, H, Pd, N), dtype=torch.float32, device=x.device)
         if state0 is None else state0.float())
    prev = []
    for c in range(nC):
        prev.append(s)
        s = s * torch.exp(total[:, c])[:, :, None, None] + chunk_state[:, c]
    prev_states = torch.stack(prev, dim=1)                # [B,nC,H,P,N]

    y_inter = torch.einsum("bcln,bchpn->bclhp", Cc, prev_states) * \
        torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(Bsz, S, H, Pd)
    y = y + D.float()[None, None, :, None] * x.float()
    return y.to(x.dtype), s


def ssd_step(x, dt, A_log, B_mat, C_mat, D, state):
    """One decode step. x [B,H,P], dt [B,H], B/C [B,N], state [B,H,P,N]."""
    a = torch.exp(dt.float() * -torch.exp(A_log.float()))  # [B,H]
    xdt = x.float() * dt[..., None]
    state = state * a[:, :, None, None] + \
        torch.einsum("bhp,bn->bhpn", xdt, B_mat.float())
    y = torch.einsum("bhpn,bn->bhp", state, C_mat.float())
    y = y + D[None, :, None] * x.float()
    return y.to(x.dtype), state
