"""Roofline terms of a step on the NVIDIA H100 (the port's counterpart of
``repro/launch/roofline.py``).

The reference parses XLA's post-SPMD HLO (``analyze_hlo``): dot FLOPs and
collective bytes per device, trip-corrected through its layer scans. The
port makes no HLO; its counterpart is ``count_step(fn, *args)``, which
runs the step once under ``torch.utils.flop_counter.FlopCounterMode``,
usually on ``meta`` tensors (shapes only, no memory, no device), and
reads the collectives' byte counters (``distributed/collectives.py``).
What it counts is what the port executes: every matrix product of the
forward, the backward and remat's second forward (the stack is a Python
loop, not a scan, so nothing needs a trip count), and the collectives the
one-process mesh runs. The closed-form cross-checks (``analytic_flops``,
``analytic_hbm_bytes``, ``model_flops_6nd``) and the three terms
(``roofline_terms``) are the reference's, copied as they are; only the
hardware constants are the H100's.
"""
from __future__ import annotations

from dataclasses import dataclass

from torch.utils.flop_counter import FlopCounterMode

from repro_torch.distributed import collectives

# hardware constants of one NVIDIA H100 SXM (NVIDIA's H100 data sheet,
# dense rates without sparsity, at the 700 W power limit)
PEAK_FLOPS = 989e12          # bf16 / fp16 on the tensor cores
PEAK_FLOPS_BY_TYPE = {
    "bfloat16": PEAK_FLOPS,
    "float32": 67e12,        # fp32 outside the tensor cores
    "tf32": 495e12,          # TF32 on the tensor cores
}
HBM_BW = 3.35e12             # HBM3 bytes/s (80 GB)
HBM_BYTES = 80e9             # device memory
NVLINK_BW = 450e9            # bytes/s each way, to the host's other cards
                             # (900 GB/s NVLink 4 in all, data sheet)


@dataclass
class StepCounts:
    flops: float                       # matrix-product FLOPs, all shards
    coll_bytes: dict                   # per collective kind, per device


def count_step(fn, *args) -> StepCounts:
    """Run ``fn(*args)`` once and count what it executes: the FLOPs of
    its matrix products (``FlopCounterMode``: mm, bmm, addmm, baddbmm,
    convolutions and SDPA, forward and backward) and the bytes of its
    collectives per device, by kind. On ``meta`` arguments the run costs
    no memory and touches no device, and a data-dependent count of
    nonzero elements (the cache-write index) takes every element as
    nonzero, as every row of a full batch is live."""
    import torch.fx.experimental._config as fx_config
    collectives.reset_bytes()
    with FlopCounterMode(display=False) as fc, fx_config.patch(
            meta_nonzero_assume_all_nonzero=True):
        fn(*args)
    return StepCounts(flops=float(fc.get_total_flops()),
                      coll_bytes=dict(collectives.BYTES))


# ---------------------------------------------------------------------------
# roofline terms
# ---------------------------------------------------------------------------
@dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    flops_device: float
    hbm_bytes_device: float
    coll_bytes_device: float
    model_flops_total: float           # 6*N_active*D
    useful_ratio: float                # model_flops / (flops_device*chips)
    dominant: str

    def as_dict(self):
        return {
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "flops_device": self.flops_device,
            "hbm_bytes_device": self.hbm_bytes_device,
            "coll_bytes_device": self.coll_bytes_device,
            "model_flops_total": self.model_flops_total,
            "useful_ratio": self.useful_ratio, "dominant": self.dominant,
        }


def roofline_terms(flops_device: float, hbm_bytes_device: float,
                   coll_bytes_device: float, model_flops_total: float,
                   chips: int) -> RooflineTerms:
    c = flops_device / PEAK_FLOPS
    m = hbm_bytes_device / HBM_BW
    n = coll_bytes_device / NVLINK_BW
    dom = max((c, "compute"), (m, "memory"), (n, "collective"))[1]
    useful = model_flops_total / max(1.0, flops_device * chips)
    return RooflineTerms(compute_s=c, memory_s=m, collective_s=n,
                         flops_device=flops_device,
                         hbm_bytes_device=hbm_bytes_device,
                         coll_bytes_device=coll_bytes_device,
                         model_flops_total=model_flops_total,
                         useful_ratio=useful, dominant=dom)


# ---------------------------------------------------------------------------
# analytic cross-check (napkin math per config & shape)
# ---------------------------------------------------------------------------
def analytic_flops(cfg, kind: str, B: int, S: int,
                   active_frac: float = 1.0) -> float:
    """Total (all-chip) step FLOPs. Matmul-dominated closed form:
    train = 3x fwd (fwd + 2x bwd); attention quadratic term explicit.
    The flash path computes the full (not causal-skipped) score matrix,
    so attention uses the 2*S^2 (not S^2) convention — matching the code.
    """
    N = cfg.param_count(active_only=True)
    d, dh = cfg.d_model, cfg.head_dim_
    Hq, Hkv = cfg.num_heads, cfg.num_kv_heads
    tok = B * S * active_frac
    lin = 2.0 * N * tok                    # all weight matmuls, fwd
    attn = 0.0
    for k in cfg.layer_kinds:
        if k in ("attn", "local"):
            kv_len = min(S, cfg.window) if k == "local" else S
            if kind == "decode":
                attn += 2.0 * B * Hq * dh * kv_len * 2     # qk + pv
            else:
                attn += 2.0 * B * (S * active_frac) * kv_len * Hq * dh * 2
        elif k == "xattn":
            qlen = 1 if kind == "decode" else S * active_frac
            attn += 2.0 * B * qlen * cfg.num_media_tokens * Hq * dh * 2
        elif k == "ssd":
            L = min(cfg.ssd_chunk, S)
            nC = max(1, S // L)
            di, ns = cfg.d_inner, cfg.ssm_state
            if kind == "decode":
                attn += 2.0 * B * di * ns * 2
            else:
                attn += 2.0 * B * nC * (L * L * (ns + di) +
                                        L * di * ns * 2)
    if kind == "decode":
        lin = 2.0 * N * B                   # one token per sequence
    fwd = lin + attn
    return 3.0 * fwd if kind == "train" else fwd


def analytic_hbm_bytes(cfg, kind: str, B: int, S: int, chips: int,
                       dtype_bytes: int = 2) -> float:
    """Per-device HBM traffic estimate: weights read once per step (+grad
    and optimizer traffic for train), KV cache read for decode."""
    N = cfg.param_count(active_only=False)
    w = N * dtype_bytes / chips
    if kind == "train":
        # read w, write grads, read+write m,v (fp32): dominated by 16 N/chips
        return w * (1 + 2) + N * 16 / chips
    kv = 0.0
    for k in cfg.layer_kinds:
        if k in ("attn", "local"):
            kv_len = min(S, cfg.window) if k == "local" else S
            kv += 2 * B * kv_len * cfg.num_kv_heads * cfg.head_dim_ * \
                dtype_bytes
        elif k == "ssd":
            kv += B * cfg.ssm_heads * cfg.ssm_head_dim * cfg.ssm_state * 4
        elif k == "rglru":
            kv += B * cfg.rnn_width_ * 4
    if kind == "decode":
        return w + kv / chips
    return w + kv / chips  # prefill writes the cache once


def model_flops_6nd(cfg, kind: str, B: int, S: int) -> float:
    N = cfg.param_count(active_only=True)
    D = B * (1 if kind == "decode" else S)
    if kind == "train":
        return 6.0 * N * D
    return 2.0 * N * D
