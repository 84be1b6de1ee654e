"""The port's CUDA kernels against their plain PyTorch versions on the
card, on the parametrisations of ``tests/test_kernels.py``, in fp32
(3e-5) and bf16 (3e-2). Every test is ``cuda``-marked and skips on a host
without a GPU. This file imports neither jax nor the reference package,
so it also runs on a GPU host without them::

    PYTHONPATH=src python -m pytest --noconftest -m cuda \
        tests/test_torch_kernels_cuda.py

The numpy input makers here are shared with ``test_torch_kernels.py``."""
import numpy as np
import pytest
import torch

from repro_torch.kernels.chunk_attention import ops as cops
from repro_torch.kernels.decode_attention import ops as dops

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


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


@pytest.fixture
def counts():
    cops.chunk_attention.launches = 0
    dops.decode_attention.launches = 0
    dops.paged_decode_attention.launches = 0


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel; run on the card)")
    return torch.device("cuda")


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
    orf, mrf = cops.chunk_attention(*_t(*ins, dtype=dt), num_chunks=C,
                                    window=window)
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
@pytest.mark.parametrize("B,S,H,Hkv,D,window", DECODE_CASES)
def test_decode_cuda_kernel_vs_plain(counts, B, S, H, Hkv, D, window):
    dev = _need_cuda()
    ins = _decode_inputs(S, B, S, H, Hkv, D)
    o = dops.decode_attention(*_t(*ins, device=dev), window=window)
    assert dops.decode_attention.launches == 1
    r = dops.decode_attention(*_t(*ins), window=window)
    np.testing.assert_allclose(_np(o), _np(r), **F32)


@pytest.mark.cuda
@pytest.mark.parametrize("B,NB,bs,H,Hkv,D,window", PAGED_CASES)
def test_paged_cuda_kernel_vs_plain(counts, B, NB, bs, H, Hkv, D, window):
    dev = _need_cuda()
    ins = _paged_inputs(NB * bs, B, NB, bs, H, Hkv, D)
    o = dops.paged_decode_attention(*_t(*ins, device=dev), window=window)
    assert dops.paged_decode_attention.launches == 1
    r = dops.paged_decode_attention(*_t(*ins), window=window)
    np.testing.assert_allclose(_np(o), _np(r), **F32)


@pytest.mark.cuda
def test_cuda_wrapper_raises_instead_of_falling_back():
    dev = _need_cuda()
    q, k, v, qpos, kpos = _decode_inputs(1, 2, 40, 4, 2, 16)
    tq, tk, tv, tqp, tkp = _t(q, k, v, qpos, kpos, device=dev)
    with pytest.raises(TypeError):
        dops.decode_attention(tq, tk, tv, tqp.long(), tkp)
    with pytest.raises(ValueError):
        dops.decode_attention(tq, tk.transpose(1, 2), tv, tqp, tkp)
