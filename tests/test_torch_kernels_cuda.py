"""The port's CUDA kernels against their plain PyTorch versions on the
card, on the parametrisations of ``tests/test_kernels.py``, in fp32
(3e-5) and bf16 (3e-2). Every test is ``cuda``-marked and skips on a host
without a GPU. This file imports neither jax nor the reference package,
so it also runs on a GPU host without them::

    PYTHONPATH=src python -m pytest --noconftest -m cuda \
        tests/test_torch_kernels_cuda.py

The numpy input makers here are shared with ``test_torch_kernels.py``."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import device as devmod
from repro_torch.kernels.chunk_attention import ops as cops
from repro_torch.kernels.chunk_attention.ref import chunk_attention_ref
from repro_torch.kernels.decode_attention import ops as dops
from repro_torch.kernels.rope import ops as rops
from repro_torch.kernels.ssd import ops as sops
from repro_torch.models import layers as TL

F32 = dict(rtol=3e-5, atol=3e-5)
BF16 = dict(rtol=3e-2, atol=3e-2)

CHUNK_CASES = [
    (16, 64, 4, 4, 32, 8, 0),       # MHA
    (48, 160, 8, 4, 32, 8, 0),      # GQA
    (32, 96, 8, 2, 64, 16, 0),      # deep GQA
    (32, 96, 4, 2, 32, 8, 48),      # sliding window
    (8, 32, 4, 1, 128, 4, 0),       # MQA, wide head
]
DECODE_CASES = [(2, 64, 4, 2, 32, 0), (3, 100, 8, 2, 32, 0),
                (1, 48, 4, 4, 64, 16)]
PAGED_CASES = [(2, 8, 4, 4, 2, 32, 0), (3, 12, 8, 8, 2, 32, 0),
               (1, 6, 4, 4, 4, 64, 8)]
# nC, L, H, P, N: the three shapes of tests/test_kernels.py, then chunk
# lengths 1 and 7 (ssd_chunked hands the kernel any L <= chunk)
SSD_CASES = [(1, 8, 2, 16, 8), (3, 16, 4, 32, 16), (2, 32, 2, 64, 32),
             (2, 1, 2, 16, 8), (3, 7, 2, 16, 8)]
# T, H, D, theta: the three shapes of tests/test_kernels.py, then an odd T
# with D/2 not a multiple of 4 (one element per thread)
ROPE_CASES = [(32, 4, 32, 1e4), (50, 2, 64, 5e5), (128, 8, 128, 1e6),
              (7, 3, 10, 1e4), (40, 4, 256, 1e6), (48, 8, 64, 1e4)]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


@pytest.fixture
def counts():
    cops.chunk_attention.launches = 0
    dops.decode_attention.launches = 0
    dops.paged_decode_attention.launches = 0
    sops.ssd_intra.launches = 0
    rops.rope.launches = 0


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel; run on the card)")
    return devmod.resolve("cuda")     # fp32 products in IEEE fp32, no TF32


def _plain(ref, *ins, device, dtype=None, **kw):
    """``ref``, a kernel's plain version, on the card, on the same rounded
    inputs as the kernel: the oracle of the kernel-vs-plain tests. The
    host CPU is not the oracle: on the card's machine, the host's first
    fp32 product in a process came out ~1e-4 off in about 1% of fresh
    processes while the kernel matched a float64 version (ROADMAP C8,
    PERF.md §6)."""
    return ref(*_t(*ins, device=device, dtype=dtype), **kw)


# ---------------- inputs, made with numpy from a seed -----------------------
def _chunk_inputs(seed, A, S, H, Hkv, D, C):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(A, H, D)).astype(np.float32)
    k = rng.normal(size=(S, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(S, Hkv, D)).astype(np.float32)
    qpos = np.sort(rng.choice(S, A, replace=False)).astype(np.int32)
    kpos = np.arange(S, dtype=np.int32)
    kpos[-S // 8:] = -1
    kch = np.minimum(np.maximum(kpos, 0) * C // S, C - 1).astype(np.int32)
    return q, k, v, qpos, kpos, kch


def _segment_inputs(seed):
    rng = np.random.default_rng(seed)
    H, Hkv, D, C = 4, 2, 32, 8
    A1, S1, A2, S2 = 16, 48, 8, 32
    q = rng.normal(size=(A1 + A2, H, D)).astype(np.float32)
    k = rng.normal(size=(S1 + S2, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(S1 + S2, Hkv, D)).astype(np.float32)
    qpos = np.concatenate([np.arange(A1) * 2, np.arange(A2) * 3]) \
        .astype(np.int32)
    kpos = np.concatenate([np.arange(S1), np.arange(S2)]).astype(np.int32)
    kch = np.concatenate([np.arange(S1) % C, np.arange(S2) % C]) \
        .astype(np.int32)
    qseg = np.concatenate([np.zeros(A1), np.ones(A2)]).astype(np.int32)
    kseg = np.concatenate([np.zeros(S1), np.ones(S2)]).astype(np.int32)
    return (q, k, v, qpos, kpos, kch, qseg, kseg), C


def _t(*xs, device="cpu", dtype=None):
    out = []
    for x in xs:
        t = torch.from_numpy(np.ascontiguousarray(x)).to(device)
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        out.append(t)
    return out


def _decode_inputs(seed, B, S, H, Hkv, D):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, D)).astype(np.float32)
    k = rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
    kpos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    kpos[:, -S // 4:] = -1
    qpos = rng.integers(1, S, B).astype(np.int32)
    return q, k, v, qpos, kpos


def _paged_inputs(seed, B, NB, bs, H, Hkv, D):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, D)).astype(np.float32)
    kb = rng.normal(size=(NB, bs, Hkv, D)).astype(np.float32)
    vb = rng.normal(size=(NB, bs, Hkv, D)).astype(np.float32)
    kpos = rng.integers(0, 64, (NB, bs)).astype(np.int32)
    kpos[rng.random((NB, bs)) < 0.2] = -1    # dead pool slots
    NBmax = 4
    rows = np.full((B, NBmax), -1, np.int32)
    for b in range(B):
        n = int(rng.integers(1, NBmax + 1))
        rows[b, :n] = rng.choice(NB, size=n, replace=False)
    qpos = rng.integers(1, 64, B).astype(np.int32)
    return q, kb, vb, kpos, rows, qpos


def _rope_inputs(seed, T, H, D, lead=()):
    """x [.., T, H, D] fp32 and int32 positions [.., T] up to 10,000."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=lead + (T, H, D)).astype(np.float32)
    pos = rng.integers(0, 10_000, lead + (T,)).astype(np.int32)
    return x, pos


def _ssd_inputs(seed, nC, L, H, P, N, batch=0):
    """xdt [nC,L,H,P], log_a [nC,L,H] (<= 0), B/C [nC,L,N]; with ``batch``
    a leading batch axis of that size."""
    rng = np.random.default_rng(seed)
    lead = (batch,) if batch else ()
    xdt = rng.normal(size=lead + (nC, L, H, P)).astype(np.float32)
    la = (-np.abs(rng.normal(size=lead + (nC, L, H))) * 0.2) \
        .astype(np.float32)
    Bm = rng.normal(size=lead + (nC, L, N)).astype(np.float32)
    Cm = rng.normal(size=lead + (nC, L, N)).astype(np.float32)
    return xdt, la, Bm, Cm


def _ssd_model_inputs(seed, nC, L, H, P, N):
    """The SSD block's inputs at the distributions mamba2 makes them
    (chip_smoke.ssd_inputs): dt = softplus(N(0, 1)), A = -U(1, 8) per
    head, log_a = dt * A, xdt = x * dt with x ~ N(0, 1), B/C ~ N(0, 1)."""
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.normal(size=(nC, L, H)))).astype(np.float32)
    A = -rng.uniform(1, 8, size=H).astype(np.float32)
    xdt = rng.normal(size=(nC, L, H, P)).astype(np.float32) * dt[..., None]
    Bm = rng.normal(size=(nC, L, N)).astype(np.float32)
    Cm = rng.normal(size=(nC, L, N)).astype(np.float32)
    return xdt, dt * A, Bm, Cm


# ---------------- CUDA kernels vs plain versions (on the card) --------------
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("A,S,H,Hkv,D,C,window", CHUNK_CASES)
def test_chunk_cuda_kernel_vs_plain(counts, A, S, H, Hkv, D, C, window,
                                    dtype):
    dev = _need_cuda()
    dt = getattr(torch, dtype)
    tol = F32 if dt == torch.float32 else BF16
    ins = _chunk_inputs(A + S, A, S, H, Hkv, D, C)
    o, m = cops.chunk_attention(*_t(*ins, device=dev, dtype=dt),
                                num_chunks=C, window=window)
    torch.cuda.synchronize()
    assert cops.chunk_attention.launches == 1
    orf, mrf = _plain(chunk_attention_ref, *ins, device=dev, dtype=dt,
                      num_chunks=C, window=window)
    np.testing.assert_allclose(_np(o), _np(orf), **tol)
    np.testing.assert_allclose(_np(m), _np(mrf), **tol)


@pytest.mark.cuda
def test_chunk_cuda_kernel_segments_vs_plain():
    dev = _need_cuda()
    (q, k, v, qpos, kpos, kch, qseg, kseg), C = _segment_inputs(5)
    o, m = cops.chunk_attention(*_t(q, k, v, qpos, kpos, kch, device=dev),
                                q_seg=_t(qseg, device=dev)[0],
                                k_seg=_t(kseg, device=dev)[0], num_chunks=C)
    orf, mrf = cops.chunk_attention(*_t(q, k, v, qpos, kpos, kch),
                                    q_seg=_t(qseg)[0], k_seg=_t(kseg)[0],
                                    num_chunks=C)
    np.testing.assert_allclose(_np(o), _np(orf), **F32)
    np.testing.assert_allclose(_np(m), _np(mrf), **F32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("A", [16, 40, 64])
def test_chunk_cuda_split_key_window_vs_plain(counts, A, dtype):
    """A partial window of the path's kind: A 16-64 recomputed rows over
    S 768 keys of llama3-8b's heads (H 32 / Hkv 8, D 128), which takes the
    split-key route (partial rows, combine kernel)."""
    dev = _need_cuda()
    S, H, Hkv, D, C = 768, 32, 8, 128, 16
    assert cops.num_splits(1, A, S, H, Hkv, getattr(torch, dtype)) > 1
    dt = getattr(torch, dtype)
    tol = F32 if dt == torch.float32 else BF16
    ins = _chunk_inputs(A * 7, A, S, H, Hkv, D, C)
    o, m = cops.chunk_attention(*_t(*ins, device=dev, dtype=dt),
                                num_chunks=C)
    torch.cuda.synchronize()
    assert cops.chunk_attention.launches == 1
    orf, mrf = _plain(chunk_attention_ref, *ins, device=dev, dtype=dt,
                      num_chunks=C)
    np.testing.assert_allclose(_np(o), _np(orf), **tol)
    np.testing.assert_allclose(_np(m), _np(mrf), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("A,S,window", [(50, 200, 0), (101, 333, 64)])
def test_chunk_cuda_ragged_rows_g3_vs_plain(counts, A, S, window, dtype):
    """G = 3 (21 rows x 3 heads per CTA, one vector of 64 idle), A not a
    multiple of 21, S not a multiple of the 32-key tile, padding rows and
    keys, two packed segments, with and without a sliding window."""
    dev = _need_cuda()
    H, Hkv, D, C = 12, 4, 64, 8
    dt = getattr(torch, dtype)
    tol = F32 if dt == torch.float32 else BF16
    q, k, v, qpos, kpos, kch = _chunk_inputs(A + S, A, S, H, Hkv, D, C)
    qpos[:3] = -1
    qseg = (np.arange(A) >= A // 2).astype(np.int32)
    kseg = (np.arange(S) >= S // 2).astype(np.int32)
    kseg[kpos < 0] = -2
    tq = _t(q, k, v, qpos, kpos, kch, device=dev, dtype=dt)
    o, m = cops.chunk_attention(*tq, q_seg=_t(qseg, device=dev)[0],
                                k_seg=_t(kseg, device=dev)[0],
                                num_chunks=C, window=window)
    torch.cuda.synchronize()
    assert cops.chunk_attention.launches == 1
    orf, mrf = _plain(chunk_attention_ref, q, k, v, qpos, kpos, kch,
                      device=dev, dtype=dt, q_seg=_t(qseg, device=dev)[0],
                      k_seg=_t(kseg, device=dev)[0], num_chunks=C,
                      window=window)
    np.testing.assert_allclose(_np(o), _np(orf), **tol)
    np.testing.assert_allclose(_np(m), _np(mrf), **tol)
    assert float(o[:3].float().abs().sum()) == 0.0
    assert float(m[:3].sum()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("A,S", [(32, 768), (256, 1024)])
def test_chunk_cuda_two_launches_bit_identical(counts, A, S, dtype):
    """No atomics: two launches on the same inputs give the same bytes,
    on the split route (A 32, both types; A 256 in fp32) and with one
    range (A 256 in bf16)."""
    dev = _need_cuda()
    dt = getattr(torch, dtype)
    ins = _t(*_chunk_inputs(3, A, S, 32, 8, 128, 16), device=dev, dtype=dt)
    o1, m1 = cops.chunk_attention(*ins, num_chunks=16)
    o2, m2 = cops.chunk_attention(*ins, num_chunks=16)
    torch.cuda.synchronize()
    assert cops.chunk_attention.launches == 2
    assert torch.equal(o1, o2) and torch.equal(m1, m2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunk_cuda_head_dim_256_full_width(counts, dtype):
    """gemma3-4b's prefill window: A 512 rows over S 2048 keys, H 8 / Hkv
    4, D 256 (two warps per 16 query vectors), C 16, the 1024-key window
    of its local layers; two launches give the same bytes."""
    dev = _need_cuda()
    dt = getattr(torch, dtype)
    A, S, H, Hkv, D, C, win = 512, 2048, 8, 4, 256, 16, 1024
    ins = _chunk_inputs(256, A, S, H, Hkv, D, C)
    td = _t(*ins, device=dev, dtype=dt)
    o, m = cops.chunk_attention(*td, num_chunks=C, window=win)
    o2, m2 = cops.chunk_attention(*td, num_chunks=C, window=win)
    torch.cuda.synchronize()
    assert cops.chunk_attention.launches == 2
    assert torch.equal(o, o2) and torch.equal(m, m2)
    orf, mrf = _plain(chunk_attention_ref, *ins, device=dev, dtype=dt,
                      num_chunks=C, window=win)
    tol = F32 if dt == torch.float32 else BF16
    np.testing.assert_allclose(_np(o), _np(orf), **tol)
    np.testing.assert_allclose(_np(m), _np(mrf), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunk_cuda_g3_full_width(counts, dtype):
    """llama3.2-3b's heads (24 / 8: G 3) at D 128, A 256 over S 1024."""
    dev = _need_cuda()
    dt = getattr(torch, dtype)
    ins = _chunk_inputs(3128, 256, 1024, 24, 8, 128, 16)
    o, m = cops.chunk_attention(*_t(*ins, device=dev, dtype=dt),
                                num_chunks=16)
    torch.cuda.synchronize()
    assert cops.chunk_attention.launches == 1
    orf, mrf = _plain(chunk_attention_ref, *ins, device=dev, dtype=dt,
                      num_chunks=16)
    tol = F32 if dt == torch.float32 else BF16
    np.testing.assert_allclose(_np(o), _np(orf), **tol)
    np.testing.assert_allclose(_np(m), _np(mrf), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_cuda_head_dim_256_g2_full_width(counts, dtype):
    """gemma3-4b's decode: B 4, S 2048, H 8 / Hkv 4, D 256, the 1024-key
    window, over the dense arena and over the same keys as a pool of
    16-slot blocks in a shuffled order."""
    dev = _need_cuda()
    dt = getattr(torch, dtype)
    B, S, H, Hkv, D, bs, win = 4, 2048, 8, 4, 256, 16, 1024
    q, k, v, _qp, kpos = _decode_inputs(2562, B, S, H, Hkv, D)
    qpos = np.array([1530, 2000, 700, 1535], np.int32)
    nb = S // bs
    order = np.random.default_rng(5).permutation(B * nb).astype(np.int32)
    kb = np.zeros((B * nb, bs, Hkv, D), np.float32)
    vb = np.zeros_like(kb)
    pb = np.full((B * nb, bs), -1, np.int32)
    for b in range(B):
        blocks = order[b * nb:(b + 1) * nb]
        kb[blocks] = k[b].reshape(nb, bs, Hkv, D)
        vb[blocks] = v[b].reshape(nb, bs, Hkv, D)
        pb[blocks] = kpos[b].reshape(nb, bs)
    rows = order.reshape(B, nb)
    tol = F32 if dt == torch.float32 else BF16
    r = _plain(dops.decode_attention_ref, q, k, v, qpos, kpos, device=dev,
               dtype=dt, window=win)
    o = dops.decode_attention(*_t(q, k, v, qpos, kpos, device=dev,
                                  dtype=dt), window=win)
    op = dops.paged_decode_attention(*_t(q, kb, vb, pb, rows, qpos,
                                         device=dev, dtype=dt), window=win)
    torch.cuda.synchronize()
    assert dops.decode_attention.launches == 1
    assert dops.paged_decode_attention.launches == 1
    np.testing.assert_allclose(_np(o), _np(r), **tol)
    np.testing.assert_allclose(_np(op), _np(r), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunk_cuda_g16_head_dim_256_mqa_full_width(counts, dtype):
    """recurrentgemma-9b's local layers: 16 query heads on one KV head
    (64 query vectors per CTA are 4 positions x 16 heads, the chunk mass
    of one KV head), D 256, A 512 rows over S 4096 keys, the 2048-key
    window; two launches give the same bytes."""
    dev = _need_cuda()
    dt = getattr(torch, dtype)
    A, S, H, Hkv, D, C, win = 512, 4096, 16, 1, 256, 16, 2048
    ins = _chunk_inputs(1616, A, S, H, Hkv, D, C)
    td = _t(*ins, device=dev, dtype=dt)
    o, m = cops.chunk_attention(*td, num_chunks=C, window=win)
    o2, m2 = cops.chunk_attention(*td, num_chunks=C, window=win)
    torch.cuda.synchronize()
    assert cops.chunk_attention.launches == 2
    assert torch.equal(o, o2) and torch.equal(m, m2)
    orf, mrf = _plain(chunk_attention_ref, *ins, device=dev, dtype=dt,
                      num_chunks=C, window=win)
    tol = F32 if dt == torch.float32 else BF16
    np.testing.assert_allclose(_np(o), _np(orf), **tol)
    np.testing.assert_allclose(_np(m), _np(mrf), **tol)


# (A, S, H, Hkv, D, window, dead trailing keys): recurrentgemma-9b's local
# layers (16 heads summed) and llama-3.2-vision-90b's attn layers (A 2048
# rows over its 2056-slot cache, 64 heads summed)
MASS_SHAPES = {"recurrentgemma": (4096, 4096, 16, 1, 256, 2048, 0),
               "vision": (2048, 2056, 64, 8, 128, 0, 8)}


@pytest.mark.cuda
@pytest.mark.parametrize("chunks", [1, 16])
@pytest.mark.parametrize("shape", sorted(MASS_SHAPES))
def test_chunk_cuda_mass_long_rows_unbiased(counts, shape, chunks):
    """recurrentgemma-9b's prefill shape (A = S = 4096 positions, H 16 /
    Hkv 1, D 256, the 2048-key window) and llama-3.2-vision-90b's (A 2048
    rows, S 2056 slots of which the last 8 are dead, H 64 / Hkv 8, D 128),
    fp32, keys in one chunk (the mass is then H in every live row) or in
    16: the chunk mass within 3e-5 of an fp64 version and of the plain
    one, and unbiased (its mean error within 1e-6). A running mass that
    took every tile's products on the tensor cores drifted low over the
    tiles of a row. The errors are printed (``pytest -s``)."""
    dev = _need_cuda()
    A, S, H, Hkv, D, win, dead = MASS_SHAPES[shape]
    C = 16
    rng = np.random.default_rng(4096 + chunks)
    q = rng.normal(size=(A, H, D)).astype(np.float32)
    k = rng.normal(size=(S, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(S, Hkv, D)).astype(np.float32)
    qpos = np.arange(A, dtype=np.int32)
    kpos = np.arange(S, dtype=np.int32)
    if dead:
        kpos[-dead:] = -1
    kch = (np.maximum(kpos, 0) * chunks // max(A, S - dead)) \
        .astype(np.int32)
    td = _t(q, k, v, qpos, kpos, kch, device=dev)
    o, m = cops.chunk_attention(*td, num_chunks=C, window=win)
    _, mp = chunk_attention_ref(*td, num_chunks=C, window=win)
    torch.cuda.synchronize()
    assert cops.chunk_attention.launches == 1
    qd, kd = (torch.from_numpy(x).to(dev, torch.float64) for x in (q, k))
    kd = kd.repeat_interleave(H // Hkv, dim=1)            # [S, H, D]
    s = torch.einsum("ahd,shd->has", qd, kd) / np.sqrt(D)
    qt, kt = (torch.from_numpy(x).to(dev) for x in (qpos, kpos))
    live = (qt[:, None] >= kt[None]) & (kt[None] >= 0)
    if win:
        live &= qt[:, None] - kt[None] < win
    p = torch.softmax(s.masked_fill(~live[None], -np.inf), -1)
    del s
    onehot = torch.nn.functional.one_hot(td[5].long(), C).double()
    m64 = torch.einsum("has,sc->ac", p, onehot)
    err = (m.double() - m64)
    print(f"chunk mass {shape} chunks={chunks}: max abs err vs fp64 "
          f"{float(err.abs().max()):.3e}, mean err {float(err.mean()):.3e}")
    assert float(err.abs().max()) <= 3e-5, float(err.abs().max())
    assert abs(float(err.mean())) <= 1e-6, float(err.mean())
    np.testing.assert_allclose(_np(m), _np(mp), rtol=0, atol=3e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [2, 4, 8])
def test_paged_cuda_head_slices_read_in_place(monkeypatch, counts, n,
                                              dtype):
    """A head-sharded serving mesh's per-shard launch at llama3-8b's
    heads (H 32 / Hkv 8, D 128; pool 512 x 16, B 4, NBmax 64): the shard
    view ``[:, :, h0:h1]`` of the pool blocks reaches the kernel itself
    (no copy), each shard is within 3e-5 (bf16 3e-2) of the plain version
    on the same view, and the shards' outputs put together equal the
    unsharded launch byte for byte (the key split follows the pool's head
    count); views whose last dims are not dense raise."""
    dev = _need_cuda()
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(8 + n)
    B, NB, bs, NBmax, H, Hkv, D = 4, 512, 16, 64, 32, 8, 128
    q = rng.normal(size=(B, H, D)).astype(np.float32)
    kb = rng.normal(size=(NB, bs, Hkv, D)).astype(np.float32)
    vb = rng.normal(size=(NB, bs, Hkv, D)).astype(np.float32)
    kpos = (np.arange(NB * bs) % 1100).reshape(NB, bs).astype(np.int32)
    kpos[rng.random((NB, bs)) < 0.1] = -1
    rows = np.full((B, NBmax), -1, np.int32)
    for b, nblk in enumerate((64, 50, 30, 10)):
        rows[b, :nblk] = rng.choice(NB, size=nblk, replace=False)
    qpos = np.array([1023, 800, -1, 1099], np.int32)
    tq, tk, tv, tkp, trw, tqp = _t(q, kb, vb, kpos, rows, qpos, device=dev,
                                   dtype=dt)
    full = dops.paged_decode_attention(tq, tk, tv, tkp, trw, tqp)
    seen = []
    orig = dops._call

    def rec(what, entry, ptrs, ints, q_, nsplit):
        seen.append((ptrs[1], ptrs[2], ints[6], nsplit))
        return orig(what, entry, ptrs, ints, q_, nsplit)
    monkeypatch.setattr(dops, "_call", rec)
    hs, gs = Hkv // n, H // n
    outs = []
    for s in range(n):
        ks, vs = tk[:, :, s * hs:(s + 1) * hs], tv[:, :, s * hs:(s + 1) * hs]
        qs = tq[:, s * gs:(s + 1) * gs].contiguous()
        o = dops.paged_decode_attention(qs, ks, vs, tkp, trw, tqp)
        k_in, v_in, kvh, ns = seen[-1]
        assert k_in is ks and v_in is vs and not ks.is_contiguous()
        assert kvh == Hkv
        assert ns == dops.num_splits(B, NBmax * bs, Hkv, dt, block=bs)
        r = dops.paged_decode_attention_ref(qs, ks, vs, tkp, trw, tqp)
        np.testing.assert_allclose(_np(o), _np(r), **(
            F32 if dtype == "float32" else BF16))
        outs.append(o)
    torch.cuda.synchronize()
    assert dops.paged_decode_attention.launches == n + 1
    assert torch.equal(torch.cat(outs, dim=1), full)
    # every other column; every other head
    for bad in (tk[..., ::2], tk[:, :, ::2]):
        with pytest.raises(ValueError, match="dense"):
            dops.paged_decode_attention(
                tq[:, :bad.shape[2] * (H // Hkv), :bad.shape[3]]
                .contiguous(), bad, bad, tkp, trw, tqp)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_cuda_gd_4096_full_width(counts, dtype):
    """recurrentgemma-9b's decode: G 16 x D 256 = 4096 outputs per CTA,
    the wrapper's limit, over a ring of S 2048 slots on one KV head with
    the 2048-key window, B 2; past the limit the wrapper raises."""
    dev = _need_cuda()
    dt = getattr(torch, dtype)
    B, S, H, Hkv, D, win = 2, 2048, 16, 1, 256, 2048
    assert (H // Hkv) * D == dops._MAX_GD
    q, k, v, _qp, kpos = _decode_inputs(4096, B, S, H, Hkv, D)
    kpos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    kpos[1] += S                       # the ring after it wrapped once
    qpos = np.array([S - 1, 2 * S - 1], np.int32)
    r = _plain(dops.decode_attention_ref, q, k, v, qpos, kpos, device=dev,
               dtype=dt, window=win)
    o = dops.decode_attention(*_t(q, k, v, qpos, kpos, device=dev,
                                  dtype=dt), window=win)
    o2 = dops.decode_attention(*_t(q, k, v, qpos, kpos, device=dev,
                                   dtype=dt), window=win)
    torch.cuda.synchronize()
    assert dops.decode_attention.launches == 2 and torch.equal(o, o2)
    tol = F32 if dt == torch.float32 else BF16
    np.testing.assert_allclose(_np(o), _np(r), **tol)
    q2 = np.concatenate([q, q], axis=1)            # G 32: 8192 outputs
    with pytest.raises(ValueError, match="outputs per CTA"):
        dops.decode_attention(*_t(q2, k, v, qpos, kpos, device=dev,
                                  dtype=dt), window=win)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_scan_cuda_vs_cpu(dtype):
    """The RG-LRU's log-step scan (tensor ops, no kernel of its own) on
    the card against the same call on the CPU, with a carried state: the
    fp32 state within 1e-5, the output within 1e-5 in fp32 and one bf16
    step in bf16."""
    dev = _need_cuda()
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(17)
    R = 512
    b = rng.normal(size=(2, 257, R)).astype(np.float32)
    lam = np.log(np.expm1(-np.log(rng.uniform(0.35, 0.65, R)) / 8.0))
    alpha, beta = 1 + 0.3 * rng.normal(size=(2, R))
    h0 = rng.normal(size=(2, R))
    outs = []
    for device in ("cpu", dev):
        tb, tl, ta, tbt, th = _t(b, lam.astype(np.float32),
                                 alpha.astype(np.float32),
                                 beta.astype(np.float32),
                                 h0.astype(np.float32), device=device)
        outs.append(TL.rglru_scan(tb.to(dt), tl, ta, tbt, th))
    (yc, hc), (yg, hg) = outs
    assert yg.dtype == dt and hg.dtype == torch.float32
    np.testing.assert_allclose(_np(hg), _np(hc), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        _np(yg), _np(yc), **(dict(rtol=1e-5, atol=1e-5) if dtype == "float32"
                             else dict(rtol=2.0 ** -7, atol=1e-6)))


@pytest.mark.cuda
def test_chunk_cuda_wrapper_raises():
    """Head dims other than 32 / 64 / 128 / 256, more than 64 heads per KV
    head, too many chunks, mixed devices and int64 positions raise."""
    dev = _need_cuda()
    for D in (16, 48, 512):
        ins = _t(*_chunk_inputs(1, 8, 40, 4, 2, D, 4), device=dev)
        with pytest.raises(ValueError, match="head dim"):
            cops.chunk_attention(*ins, num_chunks=4)
    ins = _t(*_chunk_inputs(2, 8, 40, 4, 2, 32, 4), device=dev)
    with pytest.raises(ValueError, match="num_chunks"):
        cops.chunk_attention(*ins, num_chunks=65)
    with pytest.raises(ValueError, match="on cpu"):
        cops.chunk_attention(*ins[:5], ins[5].cpu(), num_chunks=4)
    with pytest.raises(TypeError):
        cops.chunk_attention(*ins[:3], ins[3].long(), *ins[4:], num_chunks=4)
    big_g = _t(*_chunk_inputs(4, 2, 40, 65, 1, 32, 4), device=dev)
    with pytest.raises(ValueError, match="H/Hkv"):
        cops.chunk_attention(*big_g, num_chunks=4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,Hkv,D,window", DECODE_CASES)
def test_decode_cuda_kernel_vs_plain(counts, B, S, H, Hkv, D, window,
                                     dtype):
    dev = _need_cuda()
    dt = getattr(torch, dtype)
    ins = _decode_inputs(S, B, S, H, Hkv, D)
    o = dops.decode_attention(*_t(*ins, device=dev, dtype=dt),
                              window=window)
    assert dops.decode_attention.launches == 1
    r = _plain(dops.decode_attention_ref, *ins, device=dev, dtype=dt,
               window=window)
    assert o.dtype == dt
    np.testing.assert_allclose(_np(o), _np(r), **(F32 if dtype == "float32"
                                                  else BF16))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,NB,bs,H,Hkv,D,window", PAGED_CASES)
def test_paged_cuda_kernel_vs_plain(counts, B, NB, bs, H, Hkv, D, window,
                                    dtype):
    dev = _need_cuda()
    dt = getattr(torch, dtype)
    ins = _paged_inputs(NB * bs, B, NB, bs, H, Hkv, D)
    o = dops.paged_decode_attention(*_t(*ins, device=dev, dtype=dt),
                                    window=window)
    assert dops.paged_decode_attention.launches == 1
    r = _plain(dops.paged_decode_attention_ref, *ins, device=dev, dtype=dt,
               window=window)
    assert o.dtype == dt
    np.testing.assert_allclose(_np(o), _np(r), **(F32 if dtype == "float32"
                                                  else BF16))


def _full_width_decode(seed):
    """llama3-8b's decode shape (B 4, S 1024, H 32 / Hkv 8, D 128) with
    per-request lengths 1000 / 700 / 300 / 0 and a window-free mask, plus
    the same keys laid out as a pool of 16-slot blocks (reversed block
    order, -1 padded rows)."""
    B, S, H, Hkv, D, bs = 4, 1024, 32, 8, 128, 16
    q, k, v, _, _ = _decode_inputs(seed, B, S, H, Hkv, D)
    lens = np.array([1000, 700, 300, 0])
    kpos = np.where(np.arange(S)[None] < lens[:, None], np.arange(S)[None],
                    -1).astype(np.int32)
    qpos = np.maximum(lens - 1, 0).astype(np.int32)
    qpos[3] = -1
    nblk = S // bs
    order = np.arange(B * nblk).reshape(B, nblk)[:, ::-1]
    kb = np.empty((B * nblk, bs, Hkv, D), np.float32)
    vb = np.empty_like(kb)
    pb = np.empty((B * nblk, bs), np.int32)
    for b in range(B):
        for j in range(nblk):
            kb[order[b, j]] = k[b, j * bs:(j + 1) * bs]
            vb[order[b, j]] = v[b, j * bs:(j + 1) * bs]
            pb[order[b, j]] = kpos[b, j * bs:(j + 1) * bs]
    rows = order.astype(np.int32).copy()
    rows[2, 40:] = -1                       # past request 2's 300 keys
    return (q, k, v, qpos, kpos), (q, kb, vb, pb, rows, qpos)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ns", [1, 2, 5, 11, 16])
def test_decode_cuda_forced_splits_full_width(monkeypatch, counts, ns,
                                              dtype):
    """Every forced number of key ranges at the full-width shape, through
    the wrappers (``num_splits`` held): dense and paged equal their plain
    versions, and the combine route equals the one-range route within the
    tolerance."""
    dev = _need_cuda()
    dt = getattr(torch, dtype)
    tol = F32 if dtype == "float32" else BF16
    dense, paged = _full_width_decode(4)
    rd = dops.decode_attention(*_t(*dense, dtype=dt))
    rp = dops.paged_decode_attention(*_t(*paged, dtype=dt))
    monkeypatch.setattr(dops, "num_splits", lambda *a, **k: ns)
    od = dops.decode_attention(*_t(*dense, device=dev, dtype=dt))
    op = dops.paged_decode_attention(*_t(*paged, device=dev, dtype=dt))
    torch.cuda.synchronize()
    assert dops.decode_attention.launches == 1
    assert dops.paged_decode_attention.launches == 1
    np.testing.assert_allclose(_np(od), _np(rd), **tol)
    np.testing.assert_allclose(_np(op), _np(rp), **tol)
    assert float(od[3].float().abs().sum()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_cuda_two_launches_bit_identical(counts, dtype):
    """No atomics: two launches on the same inputs give the same bytes,
    dense and paged, on the wrapper's split route."""
    dev = _need_cuda()
    dt = getattr(torch, dtype)
    dense, paged = _full_width_decode(5)
    td = _t(*dense, device=dev, dtype=dt)
    tp = _t(*paged, device=dev, dtype=dt)
    assert dops.num_splits(4, 1024, 8, dt) > 1
    o1, o2 = dops.decode_attention(*td), dops.decode_attention(*td)
    p1 = dops.paged_decode_attention(*tp)
    p2 = dops.paged_decode_attention(*tp)
    torch.cuda.synchronize()
    assert torch.equal(o1, o2) and torch.equal(p1, p2)
    assert dops.decode_attention.launches == 2
    assert dops.paged_decode_attention.launches == 2


@pytest.mark.cuda
def test_cuda_wrapper_raises_instead_of_falling_back(monkeypatch, counts):
    """Int64 positions, a non-contiguous K, head dims outside 16 / 32 / 64
    / 128 / 256, G * D > 4096, K/V or q off 16-byte alignment and mixed
    devices raise; D 16 and G 16 x D 256 launch; the plain versions are
    never reached with CUDA tensors."""
    dev = _need_cuda()

    def boom(*a, **k):
        raise AssertionError("plain version reached with CUDA tensors")
    monkeypatch.setattr(dops, "decode_attention_ref", boom)
    monkeypatch.setattr(dops, "paged_decode_attention_ref", boom)
    q, k, v, qpos, kpos = _decode_inputs(1, 2, 40, 4, 2, 16)
    tq, tk, tv, tqp, tkp = _t(q, k, v, qpos, kpos, device=dev)
    with pytest.raises(TypeError):
        dops.decode_attention(tq, tk, tv, tqp.long(), tkp)
    with pytest.raises(ValueError):
        dops.decode_attention(tq, tk.transpose(1, 2), tv, tqp, tkp)
    dops.decode_attention(tq, tk, tv, tqp, tkp)                  # D 16
    with pytest.raises(ValueError, match="on cpu"):
        dops.decode_attention(tq, tk, tv, tqp.cpu(), tkp)
    off = torch.empty(tk.numel() + 1, device=dev)[1:].view(tk.shape)
    off.copy_(tk)
    with pytest.raises(ValueError, match="aligned"):
        dops.decode_attention(tq, off, tv, tqp, tkp)
    for D in (8, 48, 512):
        ins = _t(*_decode_inputs(2, 2, 40, 4, 2, D), device=dev)
        with pytest.raises(ValueError, match="head dim"):
            dops.decode_attention(*ins)
    big = _t(*_decode_inputs(3, 1, 40, 32, 1, 256), device=dev)
    with pytest.raises(ValueError, match="4096"):
        dops.decode_attention(*big)
    g16 = _t(*_decode_inputs(3, 1, 40, 16, 1, 256), device=dev)
    dops.decode_attention(*g16)                                   # G*D 4096
    pq, pk, pv, ppos, prow, pqp = _t(*_paged_inputs(4, 2, 8, 4, 4, 2, 32),
                                     device=dev)
    with pytest.raises(TypeError):
        dops.paged_decode_attention(pq, pk, pv, ppos, prow.long(), pqp)
    offq = torch.empty(pq.numel() + 1, device=dev)[1:].view(pq.shape)
    offq.copy_(pq)
    with pytest.raises(ValueError, match="aligned"):
        dops.paged_decode_attention(offq, pk, pv, ppos, prow, pqp)
    dops.paged_decode_attention(pq, pk, pv, ppos, prow, pqp)
    torch.cuda.synchronize()
    assert dops.decode_attention.launches == 2
    assert dops.paged_decode_attention.launches == 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nC,L,H,P,N", SSD_CASES)
def test_ssd_cuda_kernel_vs_plain(counts, nC, L, H, P, N, dtype):
    dev = _need_cuda()
    dt = getattr(torch, dtype)
    ins = _ssd_inputs(nC * L, nC, L, H, P, N)
    y, st = sops.ssd_intra(*_t(*ins, device=dev, dtype=dt))
    torch.cuda.synchronize()
    assert sops.ssd_intra.launches == 1
    assert y.dtype == st.dtype == torch.float32
    yr, sr = _plain(sops.ssd_intra_ref, *ins, device=dev, dtype=dt)
    # both versions compute in fp32 from the same (rounded) inputs
    np.testing.assert_allclose(_np(y), _np(yr), **F32)
    np.testing.assert_allclose(_np(st), _np(sr), **F32)


@pytest.mark.cuda
def test_ssd_cuda_batched_form_never_reaches_plain(monkeypatch, counts):
    """A 5-D batch of CUDA tensors is folded into one launch; the plain
    version is never called for CUDA tensors."""
    dev = _need_cuda()
    ins = _ssd_inputs(3, 3, 16, 4, 32, 16, batch=2)
    yr, sr = sops.ssd_intra(*_t(*ins))

    def boom(*a, **k):
        raise AssertionError("plain version reached with CUDA tensors")
    monkeypatch.setattr(sops, "ssd_intra_ref", boom)
    y, st = sops.ssd_intra(*_t(*ins, device=dev))
    torch.cuda.synchronize()
    assert sops.ssd_intra.launches == 1
    assert tuple(y.shape) == (2, 3, 16, 4, 32)
    np.testing.assert_allclose(_np(y), _np(yr), **F32)
    np.testing.assert_allclose(_np(st), _np(sr), **F32)


@pytest.mark.cuda
def test_ssd_cuda_wrapper_raises():
    dev = _need_cuda()
    xdt, la, Bm, Cm = _t(*_ssd_inputs(4, 2, 8, 2, 16, 8), device=dev)
    with pytest.raises(TypeError):
        sops.ssd_intra(xdt, la.double(), Bm, Cm)
    with pytest.raises(ValueError):
        sops.ssd_intra(xdt, la, Bm.transpose(0, 1).contiguous(), Cm)
    big = _t(*_ssd_inputs(5, 1, 512, 1, 64, 128), device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        sops.ssd_intra(*big)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_cuda_head_groups_bit_identical(monkeypatch, counts, dtype):
    """Every number of heads per CTA gives the same bytes (the scores are
    formed the same way for each), H 6 leaving a partial last group."""
    dev = _need_cuda()
    dt = getattr(torch, dtype)
    ins = _t(*_ssd_model_inputs(7, 3, 64, 6, 32, 32), device=dev, dtype=dt)
    outs = {}
    for hg in (1, 2, 4, 6):
        monkeypatch.setattr(sops, "heads_per_cta", lambda *a, hg=hg: hg)
        outs[hg] = sops.ssd_intra(*ins)
    torch.cuda.synchronize()
    assert sops.ssd_intra.launches == 4
    for hg, (y, st) in outs.items():
        assert torch.equal(y, outs[1][0]) and torch.equal(st, outs[1][1]), hg


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_cuda_model_shape_within_bound(counts, dtype):
    """mamba2-370m's prefill shape (nC 60, L 128, H 32, P 64, N 128) at the
    model's distributions, with the wrapper's group size: within the
    reference's allclose bound of the plain version on the card, and two
    launches give the same bytes."""
    dev = _need_cuda()
    dt = getattr(torch, dtype)
    ins = _t(*_ssd_model_inputs(1, 60, 128, 32, 64, 128), device=dev,
             dtype=dt)
    y, st = sops.ssd_intra(*ins)
    y2, st2 = sops.ssd_intra(*ins)
    yr, sr = sops.ssd_intra_ref(*ins)
    torch.cuda.synchronize()
    assert sops.ssd_intra.launches == 2
    assert torch.equal(y, y2) and torch.equal(st, st2)
    np.testing.assert_allclose(_np(y), _np(yr), **F32)
    np.testing.assert_allclose(_np(st), _np(sr), **F32)


@pytest.mark.cuda
def test_ssd_chunked_cuda_vs_cpu(counts):
    """The model layer on the card, fed B / C as column slices of one
    projection (as the Mamba2 block does), against the same call on the
    CPU (plain version): one kernel launch, same outputs."""
    dev = _need_cuda()
    rng = np.random.default_rng(12)
    Bsz, S, H, P, N = 2, 40, 4, 16, 8
    x = rng.normal(size=(Bsz, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(Bsz, S, H)))).astype(np.float32)
    A_log = np.log(rng.uniform(1, 8, size=H)).astype(np.float32)
    BC = rng.normal(size=(Bsz, S, 2 * N + 3)).astype(np.float32)
    D = np.ones(H, np.float32)
    outs = []
    for device in ("cpu", dev):
        tx, tdt, ta, tbc, tD = _t(x, dt, A_log, BC, D, device=device)
        outs.append(TL.ssd_chunked(tx, tdt, ta, tbc[..., :N],
                                   tbc[..., N:2 * N], tD, 16))
    torch.cuda.synchronize()
    assert sops.ssd_intra.launches == 1
    for a, b in zip(*outs):
        np.testing.assert_allclose(_np(b), _np(a), rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,H,D,theta", ROPE_CASES)
def test_rope_cuda_kernel_vs_plain(counts, T, H, D, theta, dtype):
    dev = _need_cuda()
    dt = getattr(torch, dtype)
    tol = F32 if dt == torch.float32 else BF16
    x, pos = _rope_inputs(T * D, T, H, D)
    for inverse in (False, True):
        o = rops.rope(*_t(x, pos, device=dev, dtype=dt), theta=theta,
                      inverse=inverse)
        r = rops.rope(*_t(x, pos, dtype=dt), theta=theta, inverse=inverse)
        assert o.dtype == dt
        np.testing.assert_allclose(_np(o), _np(r), **tol)
    torch.cuda.synchronize()
    assert rops.rope.launches == 2


@pytest.mark.cuda
@pytest.mark.parametrize("shared_pos", [False, True])
def test_rope_cuda_batched_form_never_reaches_plain(monkeypatch, counts,
                                                    shared_pos):
    """[B,T,H,D] with pos [B,T] or a shared pos [T] is one launch; the
    plain version is never called for CUDA tensors."""
    dev = _need_cuda()
    x, pos = _rope_inputs(9, 20, 2, 32, lead=(3,))
    if shared_pos:
        pos = pos[0]
    r = rops.rope(*_t(x, pos), theta=1e4)

    def boom(*a, **k):
        raise AssertionError("plain version reached with CUDA tensors")
    monkeypatch.setattr(rops, "rope_ref", boom)
    o = rops.rope(*_t(x, pos, device=dev), theta=1e4)
    torch.cuda.synchronize()
    assert rops.rope.launches == 1 and tuple(o.shape) == x.shape
    np.testing.assert_allclose(_np(o), _np(r), **F32)


@pytest.mark.cuda
def test_rope_cuda_wrapper_raises():
    dev = _need_cuda()
    x, pos = _rope_inputs(2, 16, 2, 32)
    tx, tp = _t(x, pos, device=dev)
    with pytest.raises(ValueError, match="pos on cpu"):
        rops.rope(tx, torch.from_numpy(pos), theta=1e4)
    with pytest.raises(TypeError):
        rops.rope(tx, tp.long(), theta=1e4)
    with pytest.raises(ValueError, match="contiguous"):
        rops.rope(tx.transpose(0, 1), tp[:2], theta=1e4)


@pytest.mark.cuda
@pytest.mark.parametrize("inverse", [False, True])
def test_rope_cuda_whole_stack_equals_per_layer(counts, inverse):
    """K of a chunk over all layers [L, n, Hkv, D] in one call == L calls
    on [1, n, Hkv, D], byte for byte (the executor's streamed == eager
    contract: streamed loads re-rope one layer at a time)."""
    dev = _need_cuda()
    x, pos = _rope_inputs(3, 48, 8, 128, lead=(6,))
    tx, tp = _t(x, pos[0], device=dev)
    whole = rops.rope(tx, tp, theta=5e5, inverse=inverse)
    layers = torch.cat([rops.rope(tx[l:l + 1].contiguous(), tp, theta=5e5,
                                  inverse=inverse) for l in range(6)])
    torch.cuda.synchronize()
    assert torch.equal(whole, layers)
    assert rops.rope.launches == 7


# ---------------- no backward through a kernel; the training route ----------
def _grad_calls(dev):
    """One call of each wrapper on small CUDA inputs, the first argument
    the float input the test makes require grad."""
    q, k, v, qp, kp, kch = _t(*_chunk_inputs(0, 16, 64, 4, 2, 32, 8),
                              device=dev)
    dq, dk, dv, dqp, dkp = _t(*_decode_inputs(1, 2, 64, 4, 2, 32),
                              device=dev)
    pq, pk, pv, ppos, prow, pqp = _t(*_paged_inputs(2, 2, 8, 4, 4, 2, 32),
                                     device=dev)
    x, pos = _t(*_rope_inputs(3, 32, 4, 32), device=dev)
    sx, sla, sB, sC = _t(*_ssd_inputs(4, 2, 16, 4, 32, 16), device=dev)
    return {
        "chunk_attention": (q, lambda t: cops.chunk_attention(
            t, k, v, qp, kp, kch, num_chunks=8)),
        "decode_attention": (dq, lambda t: dops.decode_attention(
            t, dk, dv, dqp, dkp)),
        "paged_decode_attention": (pq, lambda t: dops.paged_decode_attention(
            t, pk, pv, ppos, prow, pqp)),
        "rope": (x, lambda t: rops.rope(t, pos, theta=1e4)),
        "ssd_intra": (sx, lambda t: sops.ssd_intra(t, sla, sB, sC)),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["chunk_attention", "decode_attention",
                                  "paged_decode_attention", "rope",
                                  "ssd_intra"])
def test_cuda_wrapper_raises_when_input_requires_grad(counts, name):
    """The kernels write fresh outputs with no grad_fn: with grad mode on
    and an input that requires grad, the wrapper raises (naming itself)
    instead of returning an output whose gradient would be lost. Under
    torch.no_grad the same call launches."""
    dev = _need_cuda()
    t, call = _grad_calls(dev)[name]
    fn = getattr({"chunk_attention": cops, "decode_attention": dops,
                  "paged_decode_attention": dops, "rope": rops,
                  "ssd_intra": sops}[name], name)
    with pytest.raises(RuntimeError, match=f"{name}.*no backward"):
        call(t.clone().requires_grad_(True))
    assert fn.launches == 0
    with torch.no_grad():
        call(t.clone().requires_grad_(True))
    call(t)
    torch.cuda.synchronize()
    assert fn.launches == 2


def _mamba2_layer(seed):
    """Full-width mamba2-370m: one ssd layer's params (non-zero norms and
    dt_bias, so every one matters) and its input, B 1 x T 256 (two
    chunks of 128), on the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as TM
    cfg = get_config("mamba2-370m").replace(num_layers=1)
    params = TM.init_params(cfg, torch.Generator().manual_seed(seed))
    p = {n: x[0].clone() for n, x in params["groups"][0].items()}
    g = torch.Generator().manual_seed(seed + 1)
    for n in ("ln1", "out_norm", "dt_bias"):
        p[n] = 0.1 * torch.randn(p[n].shape, generator=g)
    h = torch.randn((1, 256, cfg.d_model), generator=g)
    cot = torch.randn((1, 256, cfg.d_model), generator=g)
    return cfg, p, h, cot


@pytest.mark.cuda
def test_mamba2_layer_grad_cuda_equals_cpu(counts):
    """One full-width mamba2-370m ssd layer in train mode: its gradient
    (params and input) on the card equals the CPU's, fp32, rtol 1e-4
    (atol 1e-4 of each leaf's largest entry); no kernel launches."""
    from repro_torch.models import model as TM
    dev = _need_cuda()
    cfg, p, h, cot = _mamba2_layer(0)
    grads = []
    for device in ("cpu", dev):
        pd = {n: x.to(device).requires_grad_(True) for n, x in p.items()}
        hd = h.to(device).requires_grad_(True)
        ctx = TM.Ctx(cfg=cfg, mode="train", positions=torch.arange(
            256, dtype=torch.int32, device=device)[None])
        out = TM.apply_block(ctx, "ssd", pd, hd, None)[0]
        names = sorted(pd)
        gs = torch.autograd.grad((out * cot.to(device)).sum(),
                                 [hd] + [pd[n] for n in names])
        grads.append(dict(zip(["h"] + names, gs)))
    torch.cuda.synchronize()
    assert sops.ssd_intra.launches == 0
    for n, gc in grads[0].items():
        a, b = _np(gc), _np(grads[1][n])
        assert np.isfinite(b).all(), n
        np.testing.assert_allclose(b, a, rtol=1e-4,
                                   atol=1e-4 * np.abs(a).max(), err_msg=n)


@pytest.mark.cuda
def test_ssd_train_route_equals_kernel(counts):
    """ssd_chunked's training route (differentiable tensor ops) and its
    serving route (the ssd_intra kernel) on the same full-width inputs
    (B 2 x 512 tokens, H 32, P 64, N 128, chunk 128): within the kernel's
    3e-5 bound, so training and serving compute one function."""
    dev = _need_cuda()
    rng = np.random.default_rng(21)
    Bsz, S, H, P, N = 2, 512, 32, 64, 128
    x = rng.normal(size=(Bsz, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(Bsz, S, H)))).astype(np.float32)
    A_log = np.log(rng.uniform(1, 8, size=H)).astype(np.float32)
    Bm = rng.normal(size=(Bsz, S, N)).astype(np.float32)
    Cm = rng.normal(size=(Bsz, S, N)).astype(np.float32)
    D = np.ones(H, np.float32)
    ins = _t(x, dt, A_log, Bm, Cm, D, device=dev)
    y_k, s_k = TL.ssd_chunked(*ins, 128)
    assert sops.ssd_intra.launches == 1
    y_t, s_t = TL.ssd_chunked(*ins, 128, train=True)
    torch.cuda.synchronize()
    assert sops.ssd_intra.launches == 1
    np.testing.assert_allclose(_np(y_t), _np(y_k), **F32)
    np.testing.assert_allclose(_np(s_t), _np(s_k), **F32)


# ---------------- ROADMAP C8: the chunk kernel in fresh processes ------------
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.cuda
def test_chunk_cuda_fresh_process_stress():
    """ROADMAP C8: the first chunk case (A 16, S 64, H 4/4, D 32, C 8),
    launched first thing in 64 fresh processes, 8 at a time
    (``scripts/chunk_stress.py``): each process's first launch through the
    wrapper (fp32, 2 key ranges) within 3e-5 of the plain version on the
    card and of a float64 version, 64 more launches byte-equal to it, and
    the C entry point with 1 and 2 ranges in fp32 and 1 in bf16 on a
    NaN-poisoned workspace, output and mass, byte-equal across 8
    launches and within 3e-5 (bf16 3e-2) of the plain version."""
    _need_cuda()
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, os.path.join(ROOT, "scripts",
                                                     "chunk_stress.py"),
                        "--runs", "64", "--jobs", "8"], env=env,
                       capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-2000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["runs"] == res["passed"] == 64, res


# ---------------- the ZeRO-1 train step on the card --------------------------
@pytest.mark.cuda
def test_sharded_train_step_dp2_cuda_vs_unsharded(counts):
    """3 steps of tiny llama3-8b data-parallel over a (data 2, model 1)
    mesh on cuda:0 (``make_train_step(..., grad_specs=...)``) == 3
    unsharded steps from the same init on the card: each loss within
    1e-5, the params within the training tests' PARAM_TOL (rtol 2e-4,
    atol 1e-4), every ``m`` shard half of its leaf; training launches no
    kernel."""
    from repro_torch.configs import get_tiny
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.training import steps as TS
    from repro_torch.training.optimizer import AdamWConfig, tree_leaves
    dev = _need_cuda()
    cfg = get_tiny("llama3-8b")
    opt = AdamWConfig(peak_lr=1e-3, warmup_steps=2, total_steps=20)
    mesh = make_debug_mesh((2, 1), device=dev)
    shs = TS.train_shardings(cfg, mesh)

    def fresh():
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        return TS.init_train_state(cfg, gen)
    ref, sst = fresh(), TS.shard_state(fresh(), shs)
    step = TS.make_train_step(cfg, opt, accum=2)
    sstep = TS.make_train_step(cfg, opt, accum=2, grad_specs=shs["opt"]["m"])
    rng = np.random.default_rng(0)
    for _ in range(3):
        t = torch.from_numpy(rng.integers(0, cfg.vocab_size, (8, 33))
                             .astype(np.int32)).to(dev)
        b = {"tokens": t[:, :-1].contiguous(), "labels": t[:, 1:].contiguous()}
        ref, m1 = step(ref, b)
        sst, m2 = sstep(sst, b)
        np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]),
                                   rtol=1e-5)
    torch.cuda.synchronize()
    for a, st in zip(tree_leaves(ref.params), tree_leaves(sst.params)):
        np.testing.assert_allclose(_np(SH.unshard(st)), _np(a), rtol=2e-4,
                                   atol=1e-4)
    for a, st in zip(tree_leaves(ref.opt["m"]), tree_leaves(sst.opt["m"])):
        assert all(2 * x.numel() == a.numel() for x in st.shards.flat)
    assert cops.chunk_attention.launches == 0
    assert dops.decode_attention.launches == 0


# ---------------- the pure-bf16 kernels at the bf16 step roots' shapes ------
# (name, B, A, S, H, Hkv, D, window, live slots): llama3-8b's prefill of
# 512 tokens into a 576-slot cache and its Cache-Craft step of 160 active
# positions against it; gemma3-4b's (D 256, the 1024-key window);
# recurrentgemma-9b's 2048-token prompt filling its 2048-slot ring (G 16)
BF16_CHUNK_STEPS = [("llama3-8b prefill", 4, 512, 576, 32, 8, 128, 0, 512),
                    ("llama3-8b cc", 4, 160, 576, 32, 8, 128, 0, 512),
                    ("gemma3-4b prefill", 4, 512, 576, 8, 4, 256, 1024, 512),
                    ("recurrentgemma-9b prefill", 4, 2048, 2048, 16, 1, 256,
                     2048, 2048)]
# (name, B, S, H, Hkv, D, window, position): each one's decode over its
# cache; recurrentgemma's at B 1 and B 4 over its wrapped ring
BF16_DECODE_STEPS = [("llama3-8b", 4, 576, 32, 8, 128, 0, 515),
                     ("gemma3-4b", 4, 576, 8, 4, 256, 1024, 515),
                     ("recurrentgemma-9b B 1", 1, 2048, 16, 1, 256, 2048,
                      2051),
                     ("recurrentgemma-9b B 4", 4, 2048, 16, 1, 256, 2048,
                      2051)]


def _step_chunk_inputs(seed, B, A, S, H, Hkv, D, live):
    """A prefill (A == live: every position) or a Cache-Craft step (A
    sorted active positions) over ``live`` filled slots of S, per row."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, A, H, D)).astype(np.float32)
    k = rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
    kpos = np.where(np.arange(S) < live, np.arange(S), -1).astype(np.int32)
    kpos = np.tile(kpos, (B, 1))
    qpos = np.stack([np.arange(A) if A == live else
                     np.sort(rng.choice(live, A, replace=False))
                     for _ in range(B)]).astype(np.int32)
    kch = np.tile((np.maximum(kpos[0], 0) * 16 // S).astype(np.int32),
                  (B, 1))
    return q, k, v, qpos, kpos, kch


@pytest.mark.cuda
@pytest.mark.parametrize("case", BF16_CHUNK_STEPS, ids=lambda c: c[0])
def test_chunk_cuda_bf16_step_root_shapes(counts, case):
    """The pure-bf16 chunk instantiation at the bf16 step roots' call
    shapes against its plain version (3e-2); one launch, of that
    instantiation."""
    dev = _need_cuda()
    _, B, A, S, H, Hkv, D, win, live = case
    cops.chunk_attention.launches_by_type.clear()
    ins = _step_chunk_inputs(29, B, A, S, H, Hkv, D, live)
    td = _t(*ins, device=dev, dtype=torch.bfloat16)
    o, m = cops.chunk_attention(*td, num_chunks=16, window=win)
    torch.cuda.synchronize()
    assert dict(cops.chunk_attention.launches_by_type) == {"bfloat16": 1}
    for b in range(B):
        orf, mrf = chunk_attention_ref(*(t[b] for t in td), num_chunks=16,
                                       window=win)
        np.testing.assert_allclose(_np(o[b]), _np(orf), **BF16)
        np.testing.assert_allclose(_np(m[b]), _np(mrf), **BF16)


@pytest.mark.cuda
@pytest.mark.parametrize("case", BF16_DECODE_STEPS, ids=lambda c: c[0])
def test_decode_cuda_bf16_step_root_shapes(counts, case):
    """The pure-bf16 decode instantiation at the bf16 step roots' decode
    shapes (recurrentgemma-9b's G.D 4096 over its 2048-slot ring after it
    wrapped, at B 1 and B 4) against its plain version (3e-2)."""
    dev = _need_cuda()
    _, B, S, H, Hkv, D, win, pos = case
    dops.decode_attention.launches_by_type.clear()
    q, k, v, _qp, _kp = _decode_inputs(30, B, S, H, Hkv, D)
    ring = min(S, win) if win else S
    # slot s holds the latest position p <= pos with p % ring == s
    slots = np.arange(S)
    kpos = pos - ((pos - slots) % ring) if win else slots
    kpos = np.where((kpos >= 0) & (kpos <= pos), kpos, -1)
    kpos = np.tile(kpos.astype(np.int32), (B, 1))
    qpos = np.full(B, pos, np.int32)
    td = _t(q, k, v, qpos, kpos, device=dev, dtype=torch.bfloat16)
    o = dops.decode_attention(*td, window=win)
    torch.cuda.synchronize()
    assert dict(dops.decode_attention.launches_by_type) == {"bfloat16": 1}
    r = dops.decode_attention_ref(*td, window=win)
    np.testing.assert_allclose(_np(o), _np(r), **BF16)


@pytest.mark.cuda
def test_bf16_step_roots_launch_only_bf16_kernels(counts):
    """llama3-8b at full width cut to 2 layers in bf16 (bf16 params and
    caches) through the prefill, Cache-Craft and decode step roots on
    ``kernel``: every chunk and decode launch is the pure-bf16 one, one
    per layer and pass or step."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.training import steps as TS
    dev = _need_cuda()
    cfg = get_config("llama3-8b").replace(num_layers=2, dtype="bfloat16",
                                          param_dtype="bfloat16")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = M.init_params(cfg, gen)
    assert params["embed"].dtype == torch.bfloat16
    rng = np.random.default_rng(31)
    B, T, S, A = 2, 128, 144, 32
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, T)).astype(
        np.int32)).to(dev)
    for f in (cops.chunk_attention, dops.decode_attention):
        f.launches_by_type.clear()
    with torch.no_grad():
        cache = M.init_cache(cfg, B, S, device=dev)
        assert cache["groups"][0]["k"].dtype == torch.bfloat16
        lg, cache = TS.make_prefill_step(cfg, "kernel")(
            params, {"tokens": toks, "cache": cache})
        pos = torch.from_numpy(np.sort(np.stack([
            rng.choice(T, A, replace=False) for _ in range(B)]), 1).astype(
            np.int32)).to(dev)
        TS.make_cachecraft_prefill_step(cfg, "kernel")(
            params, {"tokens": toks[:, :A], "positions": pos,
                     "cache": {p: [{n: x.clone() for n, x in g.items()}
                                   for g in gs] for p, gs in cache.items()}})
        dec = TS.make_decode_step(cfg, "kernel")
        for i in range(2):
            lg, cache = dec(params, {
                "tokens": toks[:, i], "positions": torch.full(
                    (B,), T + i, dtype=torch.int32, device=dev),
                "cache": cache})
    torch.cuda.synchronize()
    assert lg.dtype == torch.bfloat16 and bool(torch.isfinite(lg).all())
    assert dict(cops.chunk_attention.launches_by_type) == {"bfloat16": 4}
    assert dict(dops.decode_attention.launches_by_type) == {"bfloat16": 4}
