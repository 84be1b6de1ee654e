"""The port's CUDA kernel sources, compiled for the CPU against the
emulation shim (``src/repro_torch/kernels/emu/cuda_emu.h``: one thread
per CUDA thread, real barriers and warp shuffles) and held against the
plain versions at 3e-5 on the parametrisations of ``tests/test_kernels.py``.

This checks the sources' indexing, masking, padding, tile skipping and
online-softmax logic, the SSD block's row tiling and causal skip, and
the RoPE kernel's vector lanes and shared positions, on a host without a
GPU; the card itself checks what
``nvcc`` makes of them (``chip_smoke.py``)."""
import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels.chunk_attention.ref import chunk_attention_ref
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_ref,
    paged_decode_attention_ref,
)
from repro_torch.kernels.rope.ref import rope_ref
from repro_torch.kernels.ssd.ref import ssd_intra_ref
from repro_torch.models.layers import _inv_freq
from test_torch_kernels_cuda import SSD_CASES, _rope_inputs, _ssd_inputs

torch.set_num_threads(2)
EMU = os.path.join(os.path.dirname(build.__file__), "emu")
F32 = dict(rtol=3e-5, atol=3e-5)


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler (g++) for the emulated build")
    out = tmp_path_factory.mktemp("emu")
    procs = {}
    for name in build.KERNEL_NAMES:
        so = out / f"lib{name}_emu.so"
        cmd = [cxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-x", "c++",
               f"-I{EMU}", "-include", os.path.join(EMU, "cuda_emu.h"),
               str(build.source(name)), "-o", str(so), "-lpthread"]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT,
                                        text=True), so)
    loaded = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate(timeout=300)
        assert proc.returncode == 0, log
        loaded[name] = ctypes.CDLL(str(so))
    fc = loaded["chunk_attention"].chunk_attention_fwd
    fc.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 9 + \
        [ctypes.c_void_p]
    fd = loaded["decode_attention"].decode_attention_fwd
    fd.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + \
        [ctypes.c_void_p]
    fp = loaded["decode_attention"].paged_decode_attention_fwd
    fp.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + \
        [ctypes.c_void_p]
    fs = loaded["ssd"].ssd_intra_fwd
    fs.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + \
        [ctypes.c_void_p]
    fr = loaded["rope"].rope_fwd
    fr.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + \
        [ctypes.c_void_p]
    for f in (fc, fd, fp, fs, fr):
        f.restype = ctypes.c_int
    return fc, fd, fp, fs, fr


def _t(x, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t.to(dtype) if dtype is not None else t


def _chunk(fc, q, k, v, qpos, kpos, kch, qseg, kseg, C, window):
    """[A,H,D] / [S,Hkv,D] inputs through the emulated kernel (B=1)."""
    A, H, D = q.shape
    S, Hkv = k.shape[:2]
    ts = [x[None].contiguous() for x in (q, k, v, qpos, kpos, kch, qseg,
                                          kseg)]
    out = torch.empty_like(ts[0])
    mass_part = torch.empty((1, Hkv, A, C))
    mass = torch.empty((1, A, C))
    err = fc(*[t.data_ptr() for t in ts], out.data_ptr(),
             mass_part.data_ptr(), mass.data_ptr(), 1, A, S, H, Hkv, D, C,
             window, int(q.dtype == torch.bfloat16), None)
    assert err == 0
    return out[0], mass[0]


@pytest.mark.parametrize("A,S,H,Hkv,D,C,window", [
    (16, 64, 4, 4, 32, 8, 0),       # MHA
    (48, 160, 8, 4, 32, 8, 0),      # GQA
    (32, 96, 8, 2, 64, 16, 0),      # deep GQA
    (32, 96, 4, 2, 32, 8, 48),      # sliding window
    (8, 32, 4, 1, 128, 4, 0),       # MQA, wide head
    (24, 70, 6, 2, 32, 8, 0),       # G = 3 (64 rows not a multiple)
])
def test_chunk_source_vs_plain(libs, A, S, H, Hkv, D, C, window):
    rng = np.random.default_rng(A * S)
    q = _t(rng.normal(size=(A, H, D)).astype(np.float32))
    k = _t(rng.normal(size=(S, Hkv, D)).astype(np.float32))
    v = _t(rng.normal(size=(S, Hkv, D)).astype(np.float32))
    qpos = np.sort(rng.choice(S, A, replace=False)).astype(np.int32)
    qpos[:2] = -1                                   # padding rows
    kpos = np.arange(S, dtype=np.int32)
    kpos[-S // 8:] = -1
    kch = np.minimum(np.maximum(kpos, 0) * C // S, C - 1).astype(np.int32)
    # two packed requests: segment 1 holds the upper halves
    qseg = (np.arange(A) >= A // 2).astype(np.int32)
    kseg = (np.arange(S) >= S // 2).astype(np.int32)
    ins = [q, k, v] + [_t(x) for x in (qpos, kpos, kch, qseg, kseg)]
    o, m = _chunk(libs[0], *ins, C, window)
    o_r, m_r = chunk_attention_ref(*ins[:6], num_chunks=C, window=window,
                                   q_seg=ins[6], k_seg=ins[7])
    torch.testing.assert_close(o, o_r, **F32)
    torch.testing.assert_close(m, m_r, **F32)
    assert float(o[:2].abs().sum()) == 0.0 and float(m[:2].sum()) == 0.0


def test_chunk_source_bf16_vs_plain(libs):
    rng = np.random.default_rng(3)
    A, S, H, Hkv, D, C = 16, 64, 4, 2, 32, 8
    q, k, v = (_t(rng.normal(size=s).astype(np.float32), torch.bfloat16)
               for s in ((A, H, D), (S, Hkv, D), (S, Hkv, D)))
    ints = [_t(x.astype(np.int32)) for x in (
        np.arange(A) * 2, np.arange(S), np.arange(S) // 8 % C,
        np.zeros(A), np.zeros(S))]
    o, m = _chunk(libs[0], q, k, v, *ints, C, 0)
    o_r, m_r = chunk_attention_ref(q, k, v, *ints[:3], num_chunks=C)
    assert o.dtype == torch.bfloat16
    torch.testing.assert_close(o.float(), o_r.float(), rtol=3e-2, atol=3e-2)
    torch.testing.assert_close(m, m_r, rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("B,S,H,Hkv,D,window", [
    (2, 64, 4, 2, 32, 0), (3, 100, 8, 2, 32, 0), (1, 48, 4, 4, 64, 16),
    (2, 130, 32, 8, 128, 0),
])
def test_decode_source_vs_plain(libs, B, S, H, Hkv, D, window):
    rng = np.random.default_rng(S)
    q = _t(rng.normal(size=(B, H, D)).astype(np.float32))
    k = _t(rng.normal(size=(B, S, Hkv, D)).astype(np.float32))
    v = _t(rng.normal(size=(B, S, Hkv, D)).astype(np.float32))
    kpos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    kpos[:, -S // 4:] = -1
    qpos = rng.integers(1, S, B).astype(np.int32)
    if B > 1:
        qpos[-1] = -1                               # masked batch row
    qp, kp = _t(qpos), _t(kpos)
    out = torch.empty_like(q)
    assert libs[1](q.data_ptr(), k.data_ptr(), v.data_ptr(), qp.data_ptr(),
                   kp.data_ptr(), out.data_ptr(), B, S, H, Hkv, D, window,
                   0, None) == 0
    torch.testing.assert_close(
        out, decode_attention_ref(q, k, v, qp, kp, window=window), **F32)


@pytest.mark.parametrize("B,NB,bs,H,Hkv,D,window,NBmax", [
    (2, 8, 4, 4, 2, 32, 0, 4), (3, 12, 8, 8, 2, 32, 0, 4),
    (1, 6, 4, 4, 4, 64, 8, 4), (4, 40, 16, 32, 8, 128, 0, 12),
])
def test_paged_source_vs_plain(libs, B, NB, bs, H, Hkv, D, window, NBmax):
    rng = np.random.default_rng(NB * bs)
    q = _t(rng.normal(size=(B, H, D)).astype(np.float32))
    kb = _t(rng.normal(size=(NB, bs, Hkv, D)).astype(np.float32))
    vb = _t(rng.normal(size=(NB, bs, Hkv, D)).astype(np.float32))
    kpos = rng.integers(0, 64, (NB, bs)).astype(np.int32)
    kpos[rng.random((NB, bs)) < 0.2] = -1           # dead pool slots
    rows = np.full((B, NBmax), -1, np.int32)
    for b in range(B):
        n = int(rng.integers(1, NBmax + 1))
        rows[b, :n] = rng.choice(NB, size=n, replace=False)
    rows[0, :2] = [-1, rows[0, 0]]                  # interior -1 entry
    qpos = rng.integers(1, 64, B).astype(np.int32)
    kp, rw, qp = _t(kpos), _t(rows), _t(qpos)
    out = torch.empty_like(q)
    assert libs[2](q.data_ptr(), kb.data_ptr(), vb.data_ptr(),
                   kp.data_ptr(), rw.data_ptr(), qp.data_ptr(),
                   out.data_ptr(), B, NBmax, bs, H, Hkv, D, window, 0,
                   None) == 0
    torch.testing.assert_close(
        out, paged_decode_attention_ref(q, kb, vb, kp, rw, qp,
                                        window=window), **F32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nC,L,H,P,N", SSD_CASES)
def test_ssd_source_vs_plain(libs, nC, L, H, P, N, dtype):
    """Includes chunk lengths 1 and 7 (ssd_chunked hands the kernel any L
    up to the chunk); bf16 inputs, fp32 arithmetic in both versions."""
    dt = getattr(torch, dtype)
    ins = [_t(x, dt) for x in _ssd_inputs(nC * L + 2, nC, L, H, P, N)]
    y = torch.empty((nC, L, H, P))
    st = torch.empty((nC, H, P, N))
    assert libs[3](*[x.data_ptr() for x in ins], y.data_ptr(),
                   st.data_ptr(), nC, L, H, P, N, int(dt == torch.bfloat16),
                   None) == 0
    yr, sr = ssd_intra_ref(*ins)
    torch.testing.assert_close(y, yr, **F32)
    torch.testing.assert_close(st, sr, **F32)


def test_ssd_source_row_blocks_and_padding(libs):
    """L 70 spans three row blocks of 32 (the last one ragged); P 6 and
    N 5 leave padding columns in the staged tiles."""
    nC, L, H, P, N = 1, 70, 2, 6, 5
    ins = [_t(x) for x in _ssd_inputs(70, nC, L, H, P, N)]
    y = torch.empty((nC, L, H, P))
    st = torch.empty((nC, H, P, N))
    assert libs[3](*[x.data_ptr() for x in ins], y.data_ptr(),
                   st.data_ptr(), nC, L, H, P, N, 0, None) == 0
    yr, sr = ssd_intra_ref(*ins)
    torch.testing.assert_close(y, yr, **F32)
    torch.testing.assert_close(st, sr, **F32)


def _rope(fr, x, pos, theta, inverse):
    """x [N,H,D] and pos [P] (row t reads pos[t % P]) through the
    emulated kernel."""
    N, H, D = x.shape
    freqs = _t(_inv_freq(D, theta).astype(np.float32))
    out = torch.empty_like(x)
    assert fr(x.data_ptr(), pos.data_ptr(), freqs.data_ptr(),
              out.data_ptr(), N, H, D, pos.numel(), int(inverse),
              int(x.dtype == torch.bfloat16), None) == 0
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("T", [1, 7, 70])
def test_rope_source_vs_plain(libs, T, D, dtype):
    """Odd T (the tail of a 256-thread block), D/2 a multiple of 4 (the
    4-wide vector lanes), fp32 at 3e-5 and bf16 at 3e-2 (both versions
    compute in fp32 and round once to bf16)."""
    dt = getattr(torch, dtype)
    tol = F32 if dtype == "float32" else dict(rtol=3e-2, atol=3e-2)
    x, pos = _rope_inputs(T * D, T, 3, D)
    x = _t(x, dt)
    pos = _t(pos)
    for inverse in (False, True):
        out = _rope(libs[4], x, pos, 5e5, inverse)
        assert out.dtype == dt
        torch.testing.assert_close(
            out.float(), rope_ref(x, pos, theta=5e5,
                                  inverse=inverse).float(), **tol)


def test_rope_source_scalar_lanes_and_shared_positions(libs):
    """D 10 (D/2 = 5, not a multiple of 4: one element per thread) and a
    batch of 3 rows sharing one position vector (P = T < N): row t reads
    pos[t % P], as ``ops.rope`` folds ``[B,T,H,D]`` with ``pos [T]``."""
    B, T, H, D = 3, 9, 2, 10
    x, pos = _rope_inputs(11, B * T, H, D)
    x = _t(x)
    pos = _t(pos[:T])
    out = _rope(libs[4], x, pos, 1e4, False)
    ref = rope_ref(x, pos.repeat(B), theta=1e4)
    torch.testing.assert_close(out, ref, **F32)
