"""Arithmetic the per-layer metric readers share: the closed-form work
of the window's prefill passes and decode steps, the attention kernels'
rooflines from their recorded calls and the device trace, and the
device's idle share. A reader that finds nothing to read returns None,
and the metric is left out of the line."""
from __future__ import annotations

from typing import Optional

import torch

from perfbench import counts


def prefill_flops(run) -> Optional[float]:
    """FLOPs of every row the window's prefill passes computed: per layer
    window, its live rows' projections and FFN and their attention over
    the keys at or before them in their request; plus one LM-head row per
    request of each pass."""
    m = run.m
    if not run.prefill_windows:
        return None
    tot = 0.0
    for win in run.prefill_windows:
        for g0, g1, tail, pos, _seg, R in win:
            p = pos[0]
            p = p[p >= 0].to(torch.float64)
            layers = g1 - g0
            tot += layers * (len(p) * counts.linear_flops_per_token(m)
                             + counts.attention_flops(m, float((p + 1)
                                                               .sum())))
        if win:
            tot += win[0][5] * counts.head_flops(m)
    return tot


def decode_flops(run) -> Optional[float]:
    """FLOPs of every token the window's decode steps produced: token i
    (i >= 1) of a request of prompt length T is the step that fed token
    i - 1 at position T + i - 1 and attends T + i keys in every layer."""
    m = run.m
    tot, n = 0.0, 0
    for rid, i, _t in run.tokens_in_window():
        if i == 0:
            continue
        T = run.reqs[rid].prompt_len
        tot += counts.token_flops(m, m["num_layers"], T + i) + \
            counts.head_flops(m)
        n += 1
    return tot if n else None


def decode_tokens(run) -> int:
    return sum(1 for _rid, i, _t in run.tokens_in_window() if i >= 1)


def _peak_type(dtype) -> str:
    return "bfloat16" if dtype in (torch.bfloat16, torch.float16) \
        else "tf32"


def is_chunk_kernel(name: str) -> bool:
    return "chunk_attention" in name or "ChunkParams" in name or \
        "mass_reduce_kernel" in name


def is_decode_kernel(name: str) -> bool:
    return ("decode_kernel" in name or "DecodeParams" in name) and \
        "paged" not in name


def chunk_roofline(run) -> Optional[float]:
    kc, dt = run.kernels, run.dtrace
    if kc is None or dt is None or not kc.chunk:
        return None
    t_kernel, n = dt.kernel_seconds(is_chunk_kernel)
    if n == 0 or t_kernel <= 0:
        return None
    bound = 0.0
    for (qs, ks, qd, kd, qp, kp, qseg, kseg, C) in kc.chunk:
        for b in range(qs[0]):
            qpb, kpb = qp[b], kp[b]
            qsb = qseg[b] if qseg is not None else torch.zeros_like(qpb)
            ksb = kseg[b] if kseg is not None else torch.zeros_like(kpb)
            vq, vk = qpb >= 0, kpb >= 0
            live = (kpb[None, :] <= qpb[:, None]) & vq[:, None] & \
                vk[None, :] & (qsb[:, None] == ksb[None, :])
            f, by = counts.chunk_call(qs, ks, qd, kd, int(vq.sum()),
                                      float(live.sum()), int(vk.sum()), C)
            bound += counts.bound_seconds(f, by, _peak_type(qd))
    return 100.0 * bound / t_kernel


def decode_roofline(run) -> Optional[float]:
    kc, dt = run.kernels, run.dtrace
    if kc is None or dt is None or not kc.decode:
        return None
    t_kernel, n = dt.kernel_seconds(is_decode_kernel)
    if n == 0 or t_kernel <= 0:
        return None
    bound = 0.0
    for (qs, ks, qd, kd, qp, kp) in kc.decode:
        vq = qp >= 0
        live = (kp <= qp[:, None]) & (kp >= 0) & vq[:, None]
        f, by = counts.decode_call(qs, ks, qd, kd, int(vq.sum()),
                                   int(live.sum()))
        bound += counts.bound_seconds(f, by, _peak_type(qd))
    return 100.0 * bound / t_kernel


def idle_share(run) -> Optional[float]:
    dt = run.dtrace
    if dt is None or not dt.events:
        return None
    return 100.0 * (1.0 - dt.busy_s() / dt.window_s)
