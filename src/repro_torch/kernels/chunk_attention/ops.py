"""Wrapper of the chunk-attention kernel.

CPU tensors go through the plain version (``ref.py``); CUDA tensors
launch the CUDA kernel (``csrc/chunk_attention.cu``) or raise: there is
no fallback on the card. ``chunk_attention.launches`` counts kernel
launches (never the CPU path), and ``chunk_attention.launches_by_type``
the launches of each element-type instantiation apart, by
``build.ATTN_TYPE_NAMES``: fp32, bf16, and bf16 q and out over fp32 K/V
(a bf16 model over the engine's fp32 caches). Any other mix of dtypes is
refused with ``TypeError``, on the CPU too; the mass is fp32 always.

The kernel takes 64 query vectors (row x head of one KV head) per CTA and
32 keys per tile in fp32 K/V, 64 in bf16 (at D 256 with two warps per 16
vectors, each owning half of the output columns); where that gives fewer
CTAs than fill the card, the keys
are split into ``num_splits`` ranges whose partial rows a second kernel
combines in a fixed order (``workspace_floats`` of fp32 scratch).
"""
from __future__ import annotations

import collections
import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.chunk_attention.ref import chunk_attention_ref

_WHAT = "chunk_attention"
_FLOATS = (torch.float32, torch.bfloat16)
_HEAD_DIMS = (32, 64, 128, 256)   # the source's instantiations
_NR = 64              # query vectors per CTA (NR in the source); H/Hkv <= it
_BK = {torch.float32: 32, torch.bfloat16: 64}   # keys per tile
_MAX_C = 64           # chunk-mass column tiles held in registers (8 x 8)
# CTAs a call should launch on the H100's 132 SMs (design constants, not
# read from the device), a hand-picked compromise rather than a fit: fp32
# (3xTF32, long dependent mma chains) gains from more than one resident
# CTA's worth of warps per SM; bf16 splits only where SMs would idle. At
# some shapes another count reads faster; chip_smoke.py's split sweep
# prints them beside this rule's choice (PERF.md)
_TARGET_CTAS = {torch.float32: 3 * 132, torch.bfloat16: 132}
_MAX_SPLIT = 16


def num_splits(B: int, A: int, S: int, H: int, Hkv: int,
               dtype=torch.float32) -> int:
    """Key ranges of one call, from the shapes and K/V's dtype alone:
    enough CTAs to reach ``_TARGET_CTAS`` where query blocks x KV heads x
    batch do not, at least one key tile (32 keys in fp32, 64 in bf16) per
    range and at most ``_MAX_SPLIT`` ranges, none empty."""
    base = -(-A // (_NR // (H // Hkv))) * Hkv * B
    tiles = -(-S // _BK[dtype])
    n = max(1, min(_TARGET_CTAS[dtype] // base, tiles, _MAX_SPLIT))
    per = -(-tiles // n)
    return -(-tiles // per)


def workspace_floats(B: int, A: int, H: int, Hkv: int, D: int, C: int,
                     nsplit: int) -> int:
    """fp32 scratch of one launch: the per-KV-head mass without a split,
    else the partial (acc, m, l, mass) rows of every range and head."""
    if nsplit == 1:
        return B * Hkv * A * C
    return nsplit * B * A * H * (D + 2 + C)


def _lib():
    lib = build.load("chunk_attention")
    fn = lib.chunk_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 10 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _launch(q, k, v, q_pos, k_pos, k_chunk, q_seg, k_seg, num_chunks,
            window):
    B, A, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    dev = q.device
    types = build.attn_type_code(_WHAT, q, k, v)
    build.check_no_grad(_WHAT, q=q, k=k, v=v)
    build.check_tensor(_WHAT, "q", q, (B, A, H, D), _FLOATS, dev)
    for name, t in (("k", k), ("v", v)):
        build.check_tensor(_WHAT, name, t, (B, S, Hkv, D), (k.dtype,),
                           dev)
    for name, t, n in (("q_pos", q_pos, A), ("q_seg", q_seg, A),
                       ("k_pos", k_pos, S), ("k_chunk", k_chunk, S),
                       ("k_seg", k_seg, S)):
        build.check_tensor(_WHAT, name, t, (B, n), (torch.int32,), dev)
    if H % Hkv or H // Hkv > _NR:
        raise ValueError(f"chunk_attention: H={H}, Hkv={Hkv} needs "
                         f"Hkv | H and H/Hkv <= {_NR}")
    if D not in _HEAD_DIMS:
        raise ValueError(f"chunk_attention: head dim {D} not in "
                         f"{_HEAD_DIMS}")
    if not 0 < num_chunks <= _MAX_C:
        raise ValueError(f"chunk_attention: num_chunks {num_chunks} "
                         f"outside (0, {_MAX_C}]")
    if min(A, S) < 1:
        raise ValueError(f"chunk_attention: A={A}, S={S} must be >= 1")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"chunk_attention: {name} is not 16-byte "
                             "aligned (16-byte asynchronous copies)")
    nsplit = num_splits(B, A, S, H, Hkv, k.dtype)
    out = torch.empty_like(q)
    work = torch.empty(workspace_floats(B, A, H, Hkv, D, num_chunks, nsplit),
                       dtype=torch.float32, device=dev)
    mass = torch.empty((B, A, num_chunks), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 q_pos.data_ptr(), k_pos.data_ptr(), k_chunk.data_ptr(),
                 q_seg.data_ptr(), k_seg.data_ptr(), out.data_ptr(),
                 work.data_ptr(), mass.data_ptr(), B, A, S, H, Hkv, D,
                 num_chunks, int(window), types, nsplit, stream)
    build.check(err, _WHAT)
    chunk_attention.launches += 1
    chunk_attention.launches_by_type[build.ATTN_TYPE_NAMES[types]] += 1
    return out, mass


def chunk_attention(q, k, v, q_pos, k_pos, k_chunk, *, q_seg=None,
                    k_seg=None, num_chunks: int = 16, window: int = 0):
    """Batched entry point. q [B,A,H,D] (or [A,H,D]), k/v [B,S,Hkv,D],
    q_pos [B,A], k_pos [B,S], k_chunk [B,S] int32. Optional ``q_seg`` /
    ``k_seg`` ([B,A] / [B,S]) carry packed-request segment ids (zeros when
    absent). q and K/V are fp32, bf16, or bf16 q over fp32 K/V. Returns
    (out like q, mass [B,A,C] fp32)."""
    squeeze = q.dim() == 3
    if squeeze:
        q, k, v = q[None], k[None], v[None]
        q_pos, k_pos, k_chunk = q_pos[None], k_pos[None], k_chunk[None]
        q_seg = None if q_seg is None else q_seg[None]
        k_seg = None if k_seg is None else k_seg[None]
    if q_seg is None:
        q_seg = torch.zeros_like(q_pos)
    if k_seg is None:
        k_seg = torch.zeros_like(k_pos)
    if q.device.type == "cpu":
        build.attn_type_code(_WHAT, q, k, v)     # _launch's check on CUDA
        outs = [chunk_attention_ref(q[b], k[b], v[b], q_pos[b], k_pos[b],
                                    k_chunk[b], num_chunks=num_chunks,
                                    window=window, q_seg=q_seg[b],
                                    k_seg=k_seg[b])
                for b in range(q.shape[0])]
        out = torch.stack([o for o, _ in outs])
        mass = torch.stack([m for _, m in outs])
    elif q.device.type == "cuda":
        out, mass = _launch(q, k, v, q_pos, k_pos, k_chunk, q_seg, k_seg,
                            num_chunks, window)
    else:
        raise ValueError(f"chunk_attention: no kernel for device "
                         f"{q.device}")
    if squeeze:
        out, mass = out[0], mass[0]
    return out, mass


chunk_attention.launches = 0
chunk_attention.launches_by_type = collections.Counter()
