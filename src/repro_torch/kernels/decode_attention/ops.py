"""Wrappers of the decode kernels (dense arena and paged pool).

CPU tensors go through the plain versions (``ref.py``); CUDA tensors
launch the CUDA kernels (``csrc/decode_attention.cu``) or raise: there
is no fallback on the card. ``decode_attention.launches`` and
``paged_decode_attention.launches`` count wrapper calls that launched
the kernel (the combine included), never the CPU path, and their
``launches_by_type`` the launches of each element-type instantiation
apart (``build.ATTN_TYPE_NAMES``). The dense kernel takes fp32, bf16, and
bf16 q and out over fp32 K/V (a bf16 model over the engine's fp32 arena);
the paged one fp32 or bf16 alone. Any other mix is refused with
``TypeError``, on the CPU too.

The kernels take one CTA per (request, KV head, key range): the keys are
split into ``num_splits`` ranges, from the shapes and dtype alone, whose
partial rows a second kernel combines in a fixed order
(``workspace_floats`` of fp32 scratch). ``bind`` holds the C entry
points' argument types, for the built library and for the CPU-emulated
build the tests load.

The paged kernel reads the pool arena in place, and also a head slice of
it, ``k_blocks[:, :, h0:h1]``, the view a head-sharded serving mesh gives
each shard: strided in the head axis, dense in the last two. Its key
split follows the pool's head count (the slot stride), not the slice's,
so a shard's launch splits and sums each head's keys exactly as the
unsharded launch does, and the shards' outputs put together equal the
unsharded output bit for bit.
"""
from __future__ import annotations

import collections
import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_ref,
    paged_decode_attention_ref,
)

_FLOATS = (torch.float32, torch.bfloat16)
_HEAD_DIMS = (16, 32, 64, 128, 256)   # the source's instantiations
_MAX_GD = 4096        # G * D outputs per CTA (MAX_GD in the source)
_TK = {torch.float32: 32, torch.bfloat16: 64}   # keys per tile
# CTAs a call should launch on the H100's 132 SMs: two per SM (a design
# constant, not read from the device; the kernel fits three at G 4, D 128).
# Chosen from chip_smoke.py's split sweep, which times every count by the
# card's clock at the kernel table's and the serving path's shapes beside
# this rule's pick: the fastest counts sat near 2 x 132 CTAs there
# (PERF.md). Other shapes were not swept
_TARGET_CTAS = 2 * 132
_MAX_SPLIT = 16

_P, _I = ctypes.c_void_p, ctypes.c_int
_ABI = {
    # q, k, v, q_pos, k_pos, out, work; B, S, H, Hkv, D, window, types,
    # nsplit; stream
    "decode_attention_fwd": ([_P] * 7 + [_I] * 8 + [_P], _I),
    # q, k_blocks, v_blocks, kpos_blocks, block_rows, q_pos, out, work;
    # B, NB, NBmax, bs, H, Hkv, kvh, D, window, types, nsplit; stream
    "paged_decode_attention_fwd": ([_P] * 8 + [_I] * 11 + [_P], _I),
    # D, G, types, paged
    "decode_attention_smem_bytes": ([_I] * 4, ctypes.c_longlong),
    "decode_attention_occupancy": ([_I] * 4, _I),   # not in emulated builds
}


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set argument and result types of every entry point ``lib`` has."""
    for name, (args, res) in _ABI.items():
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes, fn.restype = args, res
    return lib


def _lib() -> ctypes.CDLL:
    lib = build.load("decode_attention")
    if lib.decode_attention_fwd.argtypes is None:
        bind(lib)
    return lib


def split_units(S: int, dtype=torch.float32, block: int = 0) -> int:
    """The pieces a key range is made of: tiles of the S arena slots
    (dense), or runs of pool blocks of one tile's keys (paged, ``block`` =
    bs, S = NBmax * bs; one block where a block holds a tile or more). At
    most this many ranges."""
    if not block:
        return -(-S // _TK[dtype])
    run = max(1, _TK[dtype] // block)
    return -(-(S // block) // run)


def num_splits(B: int, S: int, Hkv: int, dtype=torch.float32,
               block: int = 0) -> int:
    """Key ranges of one call, from the shapes and K/V's dtype alone: enough
    CTAs to reach ``_TARGET_CTAS`` where B x Hkv does not, at most
    ``_MAX_SPLIT``, each of the same number of ``split_units`` (whole
    tiles, or whole runs of pool blocks), none empty."""
    units = split_units(S, dtype, block)
    n = max(1, min(_TARGET_CTAS // (B * Hkv), units, _MAX_SPLIT))
    per = -(-units // n)
    return -(-units // per)


def workspace_floats(B: int, H: int, D: int, nsplit: int) -> int:
    """fp32 scratch of one launch: none without a split, else the partial
    (acc [D], m, l) rows of every range and head."""
    return 0 if nsplit == 1 else nsplit * B * H * (D + 2)


def _check_heads(what, H, Hkv, D):
    if H % Hkv:
        raise ValueError(f"{what}: H={H} not a multiple of Hkv={Hkv}")
    if D not in _HEAD_DIMS:
        raise ValueError(f"{what}: head dim {D} not in {_HEAD_DIMS}")
    if (H // Hkv) * D > _MAX_GD:
        raise ValueError(f"{what}: (H/Hkv)*D = {(H // Hkv) * D} > "
                         f"{_MAX_GD} outputs per CTA")


def _check_aligned(what, **tensors):
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} is not 16-byte aligned "
                             "(16-byte asynchronous copies)")


def _slot_heads(what, k_blocks, v_blocks, shape, dtype, device) -> int:
    """Check the pool blocks (or a head slice of them) and return the heads
    a pool slot holds: the view must be [NB, bs, Hkv, D] of ``dtype`` on
    ``device``, dense in its last two dims, with slots of ``kvh * D``
    elements, ``kvh >= Hkv``; K and V alike."""
    NB, bs, Hkv, D = shape
    for name, t in (("k_blocks", k_blocks), ("v_blocks", v_blocks)):
        if t.device != device:
            raise ValueError(f"{what}: {name} on {t.device}, expected "
                             f"{device}")
        if t.dtype != dtype:
            raise TypeError(f"{what}: {name} dtype {t.dtype}, expected "
                            f"{dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{what}: {name} shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
    st = k_blocks.stride()
    if v_blocks.stride() != st:
        raise ValueError(f"{what}: k_blocks strides {st} != v_blocks "
                         f"strides {v_blocks.stride()}")
    slot = st[1]
    if st[3] != 1 or st[2] != D or slot % D or slot // D < Hkv or \
            st[0] != bs * slot:
        raise ValueError(f"{what}: k_blocks / v_blocks strides {st}: need "
                         "pool blocks or a head slice of them, dense in "
                         "the last two dims")
    return slot // D


def _device_of(q, what):
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: no kernel for device {q.device}")
    return q.device.type


def _call(what, entry, ptrs, ints, q, nsplit):
    """Launch ``entry`` on ``ptrs`` and ``ints`` (the shapes, the window
    and, last, the type code of q's and K/V's dtypes) with a fresh output
    like ``q`` and the split's workspace; raise on a launch error."""
    B, H, D = q.shape
    out = torch.empty_like(q)
    n_work = workspace_floats(B, H, D, nsplit)
    work = torch.empty(n_work, dtype=torch.float32, device=q.device) \
        if n_work else None
    err = getattr(_lib(), entry)(
        *[t.data_ptr() for t in ptrs], out.data_ptr(),
        None if work is None else work.data_ptr(), *ints, nsplit,
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, what)
    return out


def decode_attention(q, k, v, q_pos, k_pos, *, window: int = 0):
    """q [B,H,D], k/v [B,S,Hkv,D], q_pos [B], k_pos [B,S] -> [B,H,D] in
    q's dtype; q and K/V fp32, bf16, or bf16 q over fp32 K/V. Rows with
    q_pos = -1 give zeros."""
    what = "decode_attention"
    types = build.attn_type_code(what, q, k, v)
    if _device_of(q, what) == "cpu":
        return decode_attention_ref(q, k, v, q_pos, k_pos, window=window)
    B, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    dev = q.device
    build.check_no_grad(what, q=q, k=k, v=v)
    build.check_tensor(what, "q", q, (B, H, D), _FLOATS, dev)
    for name, t in (("k", k), ("v", v)):
        build.check_tensor(what, name, t, (B, S, Hkv, D), (k.dtype,),
                           dev)
    build.check_tensor(what, "q_pos", q_pos, (B,), (torch.int32,), dev)
    build.check_tensor(what, "k_pos", k_pos, (B, S), (torch.int32,), dev)
    _check_heads(what, H, Hkv, D)
    _check_aligned(what, q=q, k=k, v=v)
    if min(B, S) < 1:
        raise ValueError(f"{what}: B={B}, S={S} must be >= 1")
    out = _call(what, "decode_attention_fwd", (q, k, v, q_pos, k_pos),
                (B, S, H, Hkv, D, int(window), types), q,
                num_splits(B, S, Hkv, k.dtype))
    decode_attention.launches += 1
    decode_attention.launches_by_type[build.ATTN_TYPE_NAMES[types]] += 1
    return out


def paged_decode_attention(q, k_blocks, v_blocks, kpos_blocks, block_rows,
                           q_pos, *, window: int = 0):
    """Block-table-native decode: q [B,H,D], k_blocks/v_blocks
    [NB, bs, Hkv, D] (the pool arena or a head slice of it, read in
    place), kpos_blocks [NB, bs], block_rows [B, NBmax] (-1 padded), q_pos
    [B] -> [B,H,D]; q and the blocks both fp32 or both bf16."""
    what = "paged_decode_attention"
    types = build.attn_type_code(what, q, k_blocks, v_blocks, codes=(0, 1))
    if _device_of(q, what) == "cpu":
        return paged_decode_attention_ref(q, k_blocks, v_blocks,
                                          kpos_blocks, block_rows, q_pos,
                                          window=window)
    B, H, D = q.shape
    NB, bs, Hkv = k_blocks.shape[:3]
    NBmax = block_rows.shape[1]
    dev = q.device
    build.check_no_grad(what, q=q, k_blocks=k_blocks, v_blocks=v_blocks)
    build.check_tensor(what, "q", q, (B, H, D), _FLOATS, dev)
    kvh = _slot_heads(what, k_blocks, v_blocks, (NB, bs, Hkv, D), q.dtype,
                      dev)
    for name, t, shape in (("kpos_blocks", kpos_blocks, (NB, bs)),
                           ("block_rows", block_rows, (B, NBmax)),
                           ("q_pos", q_pos, (B,))):
        build.check_tensor(what, name, t, shape, (torch.int32,), dev)
    _check_heads(what, H, Hkv, D)
    _check_aligned(what, q=q, k_blocks=k_blocks, v_blocks=v_blocks)
    if min(B, NB, bs, NBmax) < 1:
        raise ValueError(f"{what}: B={B}, NB={NB}, bs={bs}, NBmax={NBmax} "
                         "must be >= 1")
    out = _call(what, "paged_decode_attention_fwd",
                (q, k_blocks, v_blocks, kpos_blocks, block_rows, q_pos),
                (B, NB, NBmax, bs, H, Hkv, kvh, D, int(window), types), q,
                num_splits(B, NBmax * bs, kvh, q.dtype, block=bs))
    paged_decode_attention.launches += 1
    paged_decode_attention.launches_by_type[
        build.ATTN_TYPE_NAMES[types]] += 1
    return out


decode_attention.launches = 0
paged_decode_attention.launches = 0
decode_attention.launches_by_type = collections.Counter()
paged_decode_attention.launches_by_type = collections.Counter()
