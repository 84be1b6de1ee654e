"""Wrapper of the chunk-attention kernel.

CPU tensors go through the plain version (``ref.py``); CUDA tensors
launch the CUDA kernel (``csrc/chunk_attention.cu``) or raise: there is
no fallback on the card. ``chunk_attention.launches`` counts kernel
launches (never the CPU path).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.chunk_attention.ref import chunk_attention_ref

_WHAT = "chunk_attention"
_FLOATS = (torch.float32, torch.bfloat16)
_MAX_D = 128          # output columns per thread x 16 (MAXE in the source)
_MAX_G = 64           # query vectors per CTA (NR)
_MAX_C = 64           # chunk-mass accumulators stay in shared memory


def _lib():
    lib = build.load("chunk_attention")
    fn = lib.chunk_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 9 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _launch(q, k, v, q_pos, k_pos, k_chunk, q_seg, k_seg, num_chunks,
            window):
    B, A, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    dev = q.device
    build.check_tensor(_WHAT, "q", q, (B, A, H, D), _FLOATS, dev)
    for name, t in (("k", k), ("v", v)):
        build.check_tensor(_WHAT, name, t, (B, S, Hkv, D), (q.dtype,),
                           dev)
    for name, t, n in (("q_pos", q_pos, A), ("q_seg", q_seg, A),
                       ("k_pos", k_pos, S), ("k_chunk", k_chunk, S),
                       ("k_seg", k_seg, S)):
        build.check_tensor(_WHAT, name, t, (B, n), (torch.int32,), dev)
    if H % Hkv or H // Hkv > _MAX_G:
        raise ValueError(f"chunk_attention: H={H}, Hkv={Hkv} needs "
                         f"Hkv | H and H/Hkv <= {_MAX_G}")
    if D % 16 or D > _MAX_D:
        raise ValueError(f"chunk_attention: head dim {D} must be a "
                         f"multiple of 16 and <= {_MAX_D}")
    if not 0 < num_chunks <= _MAX_C:
        raise ValueError(f"chunk_attention: num_chunks {num_chunks} "
                         f"outside (0, {_MAX_C}]")
    out = torch.empty_like(q)
    mass_part = torch.empty((B, Hkv, A, num_chunks), dtype=torch.float32,
                            device=dev)
    mass = torch.empty((B, A, num_chunks), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 q_pos.data_ptr(), k_pos.data_ptr(), k_chunk.data_ptr(),
                 q_seg.data_ptr(), k_seg.data_ptr(), out.data_ptr(),
                 mass_part.data_ptr(), mass.data_ptr(), B, A, S, H, Hkv, D,
                 num_chunks, int(window), int(q.dtype == torch.bfloat16),
                 stream)
    build.check(err, _WHAT)
    chunk_attention.launches += 1
    return out, mass


def chunk_attention(q, k, v, q_pos, k_pos, k_chunk, *, q_seg=None,
                    k_seg=None, num_chunks: int = 16, window: int = 0):
    """Batched entry point. q [B,A,H,D] (or [A,H,D]), k/v [B,S,Hkv,D],
    q_pos [B,A], k_pos [B,S], k_chunk [B,S] int32. Optional ``q_seg`` /
    ``k_seg`` ([B,A] / [B,S]) carry packed-request segment ids (zeros when
    absent). Returns (out like q, mass [B,A,C] fp32)."""
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
