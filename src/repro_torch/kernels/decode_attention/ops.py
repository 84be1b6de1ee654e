"""Wrappers of the decode kernels (dense arena and paged pool).

CPU tensors go through the plain versions (``ref.py``); CUDA tensors
launch the CUDA kernels (``csrc/decode_attention.cu``) or raise: there
is no fallback on the card. ``decode_attention.launches`` and
``paged_decode_attention.launches`` count kernel launches (never the
CPU path).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_ref,
    paged_decode_attention_ref,
)

_FLOATS = (torch.float32, torch.bfloat16)
_MAX_D = 256          # 64-key K/V tiles of D fp32 stay in shared memory
_MAX_GD = 2048        # G * D outputs per CTA (128 threads x MAXI)


def _fn(name, n_ptr, n_int):
    fn = getattr(build.load("decode_attention"), name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check_heads(what, H, Hkv, D):
    if H % Hkv:
        raise ValueError(f"{what}: H={H} not a multiple of Hkv={Hkv}")
    if D > _MAX_D or (H // Hkv) * D > _MAX_GD:
        raise ValueError(f"{what}: head dim {D} must be <= {_MAX_D}, "
                         f"with (H/Hkv)*D <= {_MAX_GD}")


def _device_of(q, what):
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: no kernel for device {q.device}")
    return q.device.type


def decode_attention(q, k, v, q_pos, k_pos, *, window: int = 0):
    """q [B,H,D], k/v [B,S,Hkv,D], q_pos [B], k_pos [B,S] -> [B,H,D].
    Rows with q_pos = -1 give zeros."""
    what = "decode_attention"
    if _device_of(q, what) == "cpu":
        return decode_attention_ref(q, k, v, q_pos, k_pos, window=window)
    B, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    dev = q.device
    build.check_tensor(what, "q", q, (B, H, D), _FLOATS, dev)
    for name, t in (("k", k), ("v", v)):
        build.check_tensor(what, name, t, (B, S, Hkv, D), (q.dtype,),
                           dev)
    build.check_tensor(what, "q_pos", q_pos, (B,), (torch.int32,), dev)
    build.check_tensor(what, "k_pos", k_pos, (B, S), (torch.int32,), dev)
    _check_heads(what, H, Hkv, D)
    out = torch.empty_like(q)
    err = _fn("decode_attention_fwd", 6, 7)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
        k_pos.data_ptr(), out.data_ptr(), B, S, H, Hkv, D, int(window),
        int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, what)
    decode_attention.launches += 1
    return out


def paged_decode_attention(q, k_blocks, v_blocks, kpos_blocks, block_rows,
                           q_pos, *, window: int = 0):
    """Block-table-native decode: q [B,H,D], k_blocks/v_blocks
    [NB, bs, Hkv, D] (the pool arena, read in place), kpos_blocks
    [NB, bs], block_rows [B, NBmax] (-1 padded), q_pos [B] -> [B,H,D]."""
    what = "paged_decode_attention"
    if _device_of(q, what) == "cpu":
        return paged_decode_attention_ref(q, k_blocks, v_blocks,
                                          kpos_blocks, block_rows, q_pos,
                                          window=window)
    B, H, D = q.shape
    NB, bs, Hkv = k_blocks.shape[:3]
    NBmax = block_rows.shape[1]
    dev = q.device
    build.check_tensor(what, "q", q, (B, H, D), _FLOATS, dev)
    for name, t in (("k_blocks", k_blocks), ("v_blocks", v_blocks)):
        build.check_tensor(what, name, t, (NB, bs, Hkv, D), (q.dtype,),
                           dev)
    for name, t, shape in (("kpos_blocks", kpos_blocks, (NB, bs)),
                           ("block_rows", block_rows, (B, NBmax)),
                           ("q_pos", q_pos, (B,))):
        build.check_tensor(what, name, t, shape, (torch.int32,), dev)
    _check_heads(what, H, Hkv, D)
    out = torch.empty_like(q)
    err = _fn("paged_decode_attention_fwd", 7, 8)(
        q.data_ptr(), k_blocks.data_ptr(), v_blocks.data_ptr(),
        kpos_blocks.data_ptr(), block_rows.data_ptr(), q_pos.data_ptr(),
        out.data_ptr(), B, NBmax, bs, H, Hkv, D, int(window),
        int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, what)
    paged_decode_attention.launches += 1
    return out


decode_attention.launches = 0
paged_decode_attention.launches = 0
