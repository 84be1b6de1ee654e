"""The port's CUDA kernel sources, compiled for the CPU against the
emulation shim (``src/repro_torch/kernels/emu/cuda_emu.h``: one thread
per CUDA thread, real barriers and warp shuffles) and held against the
plain versions at 3e-5 on the parametrisations of ``tests/test_kernels.py``.

This checks the sources' indexing, masking, padding, tile skipping and
online-softmax logic (the chunk kernel's mma fragments, asynchronous
copies and split-key combine included), the SSD block's row tiling and
causal skip, and the RoPE kernel's vector lanes and shared positions, on
a host without a GPU; the card itself checks what ``nvcc`` makes of them
(``chip_smoke.py``). The shim's mma helpers are held against plain
products, and the chunk source's tf32 rounding against numpy."""
import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels.chunk_attention import ops as cops
from repro_torch.kernels.chunk_attention.ref import chunk_attention_ref
from repro_torch.kernels.decode_attention import ops as dops
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_ref,
    paged_decode_attention_ref,
)
from repro_torch.kernels.rope.ref import rope_ref
from repro_torch.kernels.ssd import ops as sops
from repro_torch.kernels.ssd.ref import ssd_intra_ref
from repro_torch.models.layers import _inv_freq
from test_torch_kernels_cuda import (
    SSD_CASES,
    _rope_inputs,
    _ssd_inputs,
    _ssd_model_inputs,
)

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
    fc.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 10 + \
        [ctypes.c_void_p]
    dlib = dops.bind(loaded["decode_attention"])
    fd, fp = dlib.decode_attention_fwd, dlib.paged_decode_attention_fwd
    fs = sops.bind(loaded["ssd"])
    fr = loaded["rope"].rope_fwd
    fr.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + \
        [ctypes.c_void_p]
    for f in (fc, fr):
        f.restype = ctypes.c_int
    return fc, fd, fp, fs, fr


def _t(x, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t.to(dtype) if dtype is not None else t


def _chunk(fc, q, k, v, qpos, kpos, kch, qseg, kseg, C, window,
           nsplit=None, fill=None):
    """[A,H,D] / [S,Hkv,D] inputs through the emulated kernel (B=1), with
    the wrapper's key split unless ``nsplit`` is given; output, workspace
    and mass filled with ``fill`` before the launch when it is given."""
    A, H, D = q.shape
    S, Hkv = k.shape[:2]
    if nsplit is None:
        nsplit = cops.num_splits(1, A, S, H, Hkv, q.dtype)
    ts = [x[None].contiguous() for x in (q, k, v, qpos, kpos, kch, qseg,
                                          kseg)]
    out = torch.empty_like(ts[0])
    work = torch.empty(cops.workspace_floats(1, A, H, Hkv, D, C, nsplit))
    mass = torch.empty((1, A, C))
    if fill is not None:
        for t in (out, work, mass):
            t.fill_(fill)
    err = fc(*[t.data_ptr() for t in ts], out.data_ptr(), work.data_ptr(),
             mass.data_ptr(), 1, A, S, H, Hkv, D, C, window,
             int(q.dtype == torch.bfloat16), nsplit, None)
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunk_source_split_routes_agree(libs, dtype):
    """One input through the kernel with 1 (self-normalising CTAs, per-KV
    -head mass reduce), 2, 3 and (fp32, 32-key tiles) 5 key ranges
    (partial rows, fixed-order combine): every route equals the plain
    version, and a route run twice gives the same bytes. S 150 leaves a
    ragged last tile; G 3."""
    rng = np.random.default_rng(21)
    A, S, H, Hkv, D, C = 40, 150, 6, 2, 64, 12
    dt = getattr(torch, dtype)
    q = _t(rng.normal(size=(A, H, D)).astype(np.float32), dt)
    k = _t(rng.normal(size=(S, Hkv, D)).astype(np.float32), dt)
    v = _t(rng.normal(size=(S, Hkv, D)).astype(np.float32), dt)
    qpos = np.sort(rng.choice(S, A, replace=False)).astype(np.int32)
    qpos[-3:] = -1                                   # padding rows
    kpos = np.arange(S, dtype=np.int32)
    kch = (np.arange(S) * C // S).astype(np.int32)
    zeros = np.zeros
    ins = [q, k, v] + [_t(x) for x in (qpos, kpos, kch,
                                       zeros(A, np.int32),
                                       zeros(S, np.int32))]
    o_r, m_r = chunk_attention_ref(*ins[:6], num_chunks=C)
    tol = F32 if dtype == "float32" else dict(rtol=3e-2, atol=3e-2)
    tiles = -(-S // (32 if dtype == "float32" else 64))
    for ns in (n for n in (1, 2, 3, 5) if n <= tiles):
        o, m = _chunk(libs[0], *ins, C, 0, nsplit=ns)
        torch.testing.assert_close(o.float(), o_r.float(), **tol)
        torch.testing.assert_close(m, m_r, **tol)
        o2, m2 = _chunk(libs[0], *ins, C, 0, nsplit=ns)
        assert torch.equal(o, o2) and torch.equal(m, m2)
        assert float(o[-3:].float().abs().sum()) == 0.0
        assert float(m[-3:].sum()) == 0.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 40])
def test_chunk_source_head_dim_256(libs, dtype, window):
    """D 256 (gemma3; two warps per 16 query vectors, one per half of the
    output columns, the first keeping the chunk mass), G 2, with padding
    rows and keys, two packed segments and a sliding window, through 1,
    3 key ranges: both routes equal the plain version, and the split
    route run twice gives the same bytes."""
    rng = np.random.default_rng(256 + window)
    A, S, H, Hkv, D, C = 24, 130, 4, 2, 256, 12
    dt = getattr(torch, dtype)
    q, k, v = (_t(rng.normal(size=s).astype(np.float32), dt)
               for s in ((A, H, D), (S, Hkv, D), (S, Hkv, D)))
    qpos = np.sort(rng.choice(S, A, replace=False)).astype(np.int32)
    qpos[:2] = -1
    kpos = np.arange(S, dtype=np.int32)
    kpos[-S // 8:] = -1
    kch = np.minimum(np.maximum(kpos, 0) * C // S, C - 1).astype(np.int32)
    qseg = (np.arange(A) >= A // 2).astype(np.int32)
    kseg = (np.arange(S) >= S // 2).astype(np.int32)
    ins = [q, k, v] + [_t(x) for x in (qpos, kpos, kch, qseg, kseg)]
    o_r, m_r = chunk_attention_ref(*ins[:6], num_chunks=C, window=window,
                                   q_seg=ins[6], k_seg=ins[7])
    tiles = -(-S // (32 if dtype == "float32" else 64))
    for ns in (1, 3):
        assert ns <= tiles
        o, m = _chunk(libs[0], *ins, C, window, nsplit=ns)
        torch.testing.assert_close(o.float(), o_r.float(), **_tol(dtype))
        torch.testing.assert_close(m, m_r, **_tol(dtype))
        assert float(o[:2].float().abs().sum()) == 0.0
    o2, m2 = _chunk(libs[0], *ins, C, window, nsplit=3)
    assert torch.equal(o, o2) and torch.equal(m, m2)


@pytest.mark.parametrize("ns", [1, 2])
def test_chunk_source_g3_head_dim_128(libs, ns):
    """llama3.2-3b's heads (24 / 8: G 3, the first group size that is not
    a power of two; 21 rows x 3 heads per CTA) at D 128."""
    rng = np.random.default_rng(3128 + ns)
    A, S, H, Hkv, D, C = 45, 100, 6, 2, 128, 8
    q = _t(rng.normal(size=(A, H, D)).astype(np.float32))
    k = _t(rng.normal(size=(S, Hkv, D)).astype(np.float32))
    v = _t(rng.normal(size=(S, Hkv, D)).astype(np.float32))
    qpos = np.sort(rng.choice(S, A, replace=False)).astype(np.int32)
    kpos = np.arange(S, dtype=np.int32)
    kch = (np.arange(S) * C // S).astype(np.int32)
    zeros = np.zeros
    ins = [q, k, v] + [_t(x) for x in (qpos, kpos, kch, zeros(A, np.int32),
                                       zeros(S, np.int32))]
    o, m = _chunk(libs[0], *ins, C, 0, nsplit=ns)
    o_r, m_r = chunk_attention_ref(*ins[:6], num_chunks=C)
    torch.testing.assert_close(o, o_r, **F32)
    torch.testing.assert_close(m, m_r, **F32)


def test_chunk_split_count_from_shapes():
    """The path's shapes (llama3-8b, H 32 / Hkv 8): fp32 splits the keys
    up to 3 x 132 CTAs, bf16 only up to 132 (one per SM); full-size
    prefill runs one range; ranges are whole tiles, never empty."""
    f32, b16 = torch.float32, torch.bfloat16
    assert cops.num_splits(1, 160, 224, 32, 8, f32) == 4     # 80 CTAs
    assert cops.num_splits(1, 256, 1024, 32, 8, f32) == 3    # 128 CTAs
    assert cops.num_splits(1, 512, 768, 32, 8, f32) == 1     # 256 CTAs
    assert cops.num_splits(1, 32, 768, 32, 8, f32) == 12     # 24 tiles, 2 each
    assert cops.num_splits(1, 160, 224, 32, 8, b16) == 1
    assert cops.num_splits(1, 256, 1024, 32, 8, b16) == 1
    assert cops.num_splits(1, 32, 768, 32, 8, b16) == 6      # 12 tiles of 64
    assert cops.num_splits(1, 16, 20, 4, 4, f32) == 1        # one tile
    for args in ((1, 160, 192, 32, 8), (2, 50, 70, 6, 2), (1, 24, 800, 8, 1)):
        for dt, bk in ((f32, 32), (b16, 64)):
            ns = cops.num_splits(*args, dt)
            tiles = -(-args[2] // bk)
            per = -(-tiles // ns)
            assert 1 <= ns <= tiles and (ns - 1) * per < tiles


# The shim's mma helpers, called from one emulated warp, and the chunk
# source's tf32 rounding (the source is included whole). Fragments
# are placed here by the PTX ISA's layouts, written out independently of
# the shim: groupID g = lane / 4, threadID_in_group t = lane % 4;
# m16n8k8 tf32 A a0..a3 = (g, t) (g+8, t) (g, t+4) (g+8, t+4), B b0, b1 =
# (t, g) (t+4, g); m16n8k16 bf16 A a0..a3 = (g, 2t..2t+1) (g+8, 2t..)
# (g, 2t+8..) (g+8, 2t+8..), B b0, b1 = (2t..2t+1, g) (2t+8.., g); C c0..c3
# = (g, 2t) (g, 2t+1) (g+8, 2t) (g+8, 2t+1).
FRAG_SRC = r"""
#include "@CHUNK_SOURCE@"
static uint32_t bfpair(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16(hi)) << 16);
}
__global__ void tile_kernel(const float* A, const float* B, float* C,
                            int bf16) {
  const int lane = threadIdx.x, g = lane / 4, t = lane % 4;
  uint32_t a[4], b[2];
  if (bf16) {      // A [16][16], B [16][8]
    for (int i = 0; i < 4; ++i) {
      const int r = g + 8 * (i % 2), c = 2 * t + 8 * (i / 2);
      a[i] = bfpair(A[r * 16 + c], A[r * 16 + c + 1]);
    }
    for (int i = 0; i < 2; ++i) {
      const int kk = 2 * t + 8 * i;
      b[i] = bfpair(B[kk * 8 + g], B[(kk + 1) * 8 + g]);
    }
  } else {         // A [16][8], B [8][8], values already tf32
    for (int i = 0; i < 4; ++i)
      a[i] = __float_as_uint(A[(g + 8 * (i % 2)) * 8 + t + 4 * (i / 2)]);
    for (int i = 0; i < 2; ++i) b[i] = __float_as_uint(B[(t + 4 * i) * 8 + g]);
  }
  float d[4];
  for (int e = 0; e < 4; ++e) d[e] = C[(g + 8 * (e / 2)) * 8 + 2 * t + e % 2];
  if (bf16) mma_m16n8k16_bf16(d, a, b); else mma_m16n8k8_tf32(d, a, b);
  for (int e = 0; e < 4; ++e) C[(g + 8 * (e / 2)) * 8 + 2 * t + e % 2] = d[e];
}
extern "C" int mma_tile(const float* A, const float* B, float* C, int bf16) {
  LAUNCH(tile_kernel, dim3(1), dim3(32), 0, 0)(A, B, C, bf16);
  return 0;
}
// bf16 fragments by ldmatrix: A [16][16] row-major (x4), B once as [k][n]
// (x4.trans, as V is stored) and once as [n][k] (x4, as K is stored);
// C1 = A B through the first, C2 through the second
__global__ void ldm_kernel(const uint16_t* A, const uint16_t* Bkn,
                           const uint16_t* Bnk, float* C1, float* C2) {
  const int lane = threadIdx.x, mi = lane / 8, mr = lane % 8;
  const int g = lane / 4, t = lane % 4;
  uint32_t a[4], bt[4], bn[4];
  ldmatrix_x4(a, A + (mr + 8 * (mi % 2)) * 16 + 8 * (mi / 2));
  ldmatrix_x4_trans(bt, Bkn + (mr + 8 * (mi % 2)) * 8);
  ldmatrix_x4(bn, Bnk + mr * 16 + 8 * (mi % 2));
  float d1[4] = {0, 0, 0, 0}, d2[4] = {0, 0, 0, 0};
  mma_m16n8k16_bf16(d1, a, bt);
  mma_m16n8k16_bf16(d2, a, bn);
  for (int e = 0; e < 4; ++e) {
    C1[(g + 8 * (e / 2)) * 8 + 2 * t + e % 2] = d1[e];
    C2[(g + 8 * (e / 2)) * 8 + 2 * t + e % 2] = d2[e];
  }
}
extern "C" int ldm_tile(const uint16_t* A, const uint16_t* Bkn,
                        const uint16_t* Bnk, float* C1, float* C2) {
  LAUNCH(ldm_kernel, dim3(1), dim3(32), 0, 0)(A, Bkn, Bnk, C1, C2);
  return 0;
}
extern "C" void tf32_round(const float* x, uint32_t* out, int n) {
  for (int i = 0; i < n; ++i) out[i] = tf32_rna(x[i]);
}
// the shim's cp.async: two groups of 16 bytes into poisoned shared
// memory, read before any wait, after the wait that leaves one group in
// flight, and after the last wait
__global__ void cp_kernel(const float* src, float* out) {
  float* s = reinterpret_cast<float*>(dyn_smem());
  cp_async_cg16(s, src, true);
  cp_async_commit();
  cp_async_cg16(s + 4, src + 4, true);
  cp_async_commit();
  out[0] = s[0];
  cp_async_wait<1>();
  out[1] = s[0];
  out[2] = s[4];
  cp_async_wait<0>();
  out[3] = s[4];
}
extern "C" int cp_order(const float* src, float* out) {
  LAUNCH(cp_kernel, dim3(1), dim3(1), 32, 0)(src, out);
  return 0;
}
"""


@pytest.fixture(scope="module")
def frag(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler (g++) for the emulated build")
    out = tmp_path_factory.mktemp("frag")
    src, so = out / "frag.cu", out / "libfrag.so"
    src.write_text(FRAG_SRC.replace(
        "@CHUNK_SOURCE@", str(build.source("chunk_attention"))))
    proc = subprocess.run(
        [cxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-x", "c++",
         f"-I{EMU}", "-include", os.path.join(EMU, "cuda_emu.h"), str(src),
         "-o", str(so), "-lpthread"], capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lib = ctypes.CDLL(str(so))
    lib.mma_tile.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int]
    lib.tf32_round.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int]
    lib.ldm_tile.argtypes = [ctypes.c_void_p] * 5
    lib.cp_order.argtypes = [ctypes.c_void_p] * 2
    return lib


def _tf32_np(x):
    """Round fp32 to tf32 (11 significant bits) to nearest, ties away from
    zero, in float64 arithmetic: m * 2^e with |m| in [0.5, 1), m scaled to
    11 bits and rounded half away from zero."""
    m, e = np.frexp(np.asarray(x, np.float64))
    r = np.sign(m) * np.floor(np.abs(m) * 2.0 ** 11 + 0.5)
    return (r * np.exp2(e - 11.0)).astype(np.float32)


@pytest.mark.parametrize("bf16", [False, True])
def test_emulated_mma_tile_vs_plain_product(frag, bf16):
    """One 16x8xK tile through the shim's mma helper (fragments placed by
    the ISA's layouts) == C + A @ B in float64 on the rounded operands:
    products of tf32 / bf16 values are exact in fp32, so only the fp32
    accumulation rounds."""
    rng = np.random.default_rng(7 + bf16)
    K = 16 if bf16 else 8
    A = rng.normal(size=(16, K)).astype(np.float32)
    B = rng.normal(size=(K, 8)).astype(np.float32)
    C = rng.normal(size=(16, 8)).astype(np.float32)
    if bf16:
        Ar = torch.from_numpy(A).bfloat16().float().numpy()
        Br = torch.from_numpy(B).bfloat16().float().numpy()
    else:
        A, B = _tf32_np(A), _tf32_np(B)
        Ar, Br = A, B
    want = C.astype(np.float64) + Ar.astype(np.float64) @ Br
    got = C.copy()
    frag.mma_tile(A.ctypes.data, B.ctypes.data, got.ctypes.data, int(bf16))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # every element of A and B is read from its own lane and register
    assert not np.allclose(got, C)


def test_emulated_ldmatrix_fragments_vs_plain_product(frag):
    """ldmatrix x4 (Q / K as stored, row-major) and x4.trans (V as stored,
    key-major) in the shim place the elements where m16n8k16 expects them:
    both routes give A @ B of the bf16 values."""
    rng = np.random.default_rng(5)
    A = torch.from_numpy(rng.normal(size=(16, 16)).astype(np.float32))
    B = torch.from_numpy(rng.normal(size=(16, 8)).astype(np.float32))
    Ab, Bb = A.bfloat16(), B.bfloat16()
    bits = lambda t: np.ascontiguousarray(  # noqa: E731
        t.contiguous().view(torch.int16).numpy())
    a16, bkn, bnk = bits(Ab), bits(Bb), bits(Bb.t())
    c1 = np.zeros((16, 8), np.float32)
    c2 = np.zeros((16, 8), np.float32)
    frag.ldm_tile(a16.ctypes.data, bkn.ctypes.data, bnk.ctypes.data,
                  c1.ctypes.data, c2.ctypes.data)
    want = Ab.double().numpy() @ Bb.double().numpy()
    np.testing.assert_allclose(c1, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(c2, want, rtol=1e-6, atol=1e-6)


def test_source_tf32_rounding_vs_numpy(frag):
    """The chunk source's tf32 rounding (cvt.rna.tf32.f32's function, in
    integer operations) == numpy's round-half-away on 11 significant bits,
    on random values, exact ties (the 13 dropped bits 0x1000) of both
    signs, values just below and above a tie, and a carry into the
    exponent."""
    rng = np.random.default_rng(11)
    base = rng.normal(size=4096).astype(np.float32) * \
        np.exp2(rng.integers(-40, 40, 4096)).astype(np.float32)
    u = base.view(np.uint32) & np.uint32(0xFFFFE000)
    ties = np.concatenate([u | np.uint32(0x1000), u | np.uint32(0x0FFF),
                           u | np.uint32(0x1001)]).view(np.float32)
    carry = np.array([0x3FFFF000, 0xBFFFF000, 0x3F7FF000],
                     np.uint32).view(np.float32)
    x = np.concatenate([base, ties, carry, np.float32([1.0, -2.5])])
    out = np.empty(x.size, np.uint32)
    frag.tf32_round(x.ctypes.data, out.ctypes.data, x.size)
    want = _tf32_np(x).view(np.uint32)
    np.testing.assert_array_equal(out, want)
    assert not np.any(out & np.uint32(0x1FFF))


def test_emulated_cp_async_lands_at_its_wait(frag):
    """In the shim a cp.async copy lands when the issuing thread's
    cp.async.wait_group lets its group complete, the latest moment the
    card may complete it, and shared memory starts as NaN: a kernel that
    reads a stage before waiting for it reads NaN here, whatever the card
    happened to do."""
    src = np.arange(8, dtype=np.float32) + 1
    out = np.zeros(4, np.float32)
    frag.cp_order(src.ctypes.data, out.ctypes.data)
    assert np.isnan(out[0]) and np.isnan(out[2])
    assert out[1] == src[0] and out[3] == src[4]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunk_source_poisoned_buffers(libs, dtype):
    """The intermittent card mismatch's shape (tests/test_torch_kernels_
    cuda.py's first chunk case: A 16, S 64, H 4/4, D 32, C 8) through
    every key split its tiles allow (fp32 1 and 2 ranges, bf16 1), with
    the workspace, output and mass NaN before the launch: every output
    within the tolerance of the plain version and NaN-free (the split
    route reads only workspace rows it wrote), two launches byte-equal,
    and equal to a launch on zeroed buffers."""
    rng = np.random.default_rng(16 + 64)
    A, S, H, Hkv, D, C = 16, 64, 4, 4, 32, 8
    dt = getattr(torch, dtype)
    q = _t(rng.normal(size=(A, H, D)).astype(np.float32), dt)
    k = _t(rng.normal(size=(S, Hkv, D)).astype(np.float32), dt)
    v = _t(rng.normal(size=(S, Hkv, D)).astype(np.float32), dt)
    qpos = np.sort(rng.choice(S, A, replace=False)).astype(np.int32)
    kpos = np.arange(S, dtype=np.int32)
    kpos[-S // 8:] = -1
    kch = np.minimum(np.maximum(kpos, 0) * C // S, C - 1).astype(np.int32)
    ins = [q, k, v] + [_t(x) for x in (qpos, kpos, kch,
                                       np.zeros(A, np.int32),
                                       np.zeros(S, np.int32))]
    o_r, m_r = chunk_attention_ref(*ins[:6], num_chunks=C)
    tiles = -(-S // (32 if dtype == "float32" else 64))
    for ns in range(1, min(2, tiles) + 1):
        runs = [_chunk(libs[0], *ins, C, 0, nsplit=ns, fill=f)
                for f in (float("nan"), float("nan"), 0.0)]
        for o, m in runs:
            assert not (o.float().isnan().any() or m.isnan().any())
            torch.testing.assert_close(o.float(), o_r.float(), **_tol(dtype))
            torch.testing.assert_close(m, m_r, **_tol(dtype))
        for o, m in runs[1:]:
            assert torch.equal(o, runs[0][0]) and torch.equal(m, runs[0][1])


def _decode(fd, q, k, v, qp, kp, window, nsplit=None):
    """[B,H,D] / [B,S,Hkv,D] inputs through the emulated dense kernel,
    with the wrapper's key split unless ``nsplit`` is given."""
    B, H, D = q.shape
    S, Hkv = k.shape[1:3]
    if nsplit is None:
        nsplit = dops.num_splits(B, S, Hkv, q.dtype)
    out = torch.empty_like(q)
    work = torch.empty(max(1, dops.workspace_floats(B, H, D, nsplit)))
    assert fd(q.data_ptr(), k.data_ptr(), v.data_ptr(), qp.data_ptr(),
              kp.data_ptr(), out.data_ptr(), work.data_ptr(), B, S, H, Hkv,
              D, window, int(q.dtype == torch.bfloat16), nsplit,
              None) == 0
    return out


def _paged(fp, q, kb, vb, kp, rw, qp, window, nsplit=None):
    """Pool-block inputs (or a head slice of the pool blocks) through the
    emulated paged kernel, with the wrapper's slot stride and split over
    whole blocks unless ``nsplit`` is given."""
    B, H, D = q.shape
    NB, bs, Hkv = kb.shape[:3]
    NBmax = rw.shape[1]
    kvh = dops._slot_heads("paged", kb, vb, tuple(kb.shape), q.dtype,
                           q.device)
    if nsplit is None:
        nsplit = dops.num_splits(B, NBmax * bs, kvh, q.dtype, block=bs)
    out = torch.empty_like(q)
    work = torch.empty(max(1, dops.workspace_floats(B, H, D, nsplit)))
    assert fp(q.data_ptr(), kb.data_ptr(), vb.data_ptr(), kp.data_ptr(),
              rw.data_ptr(), qp.data_ptr(), out.data_ptr(), work.data_ptr(),
              B, NB, NBmax, bs, H, Hkv, kvh, D, window,
              int(q.dtype == torch.bfloat16), nsplit, None) == 0
    return out


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
    out = _decode(libs[1], q, k, v, qp, kp, window)
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
    out = _paged(libs[2], q, kb, vb, kp, rw, qp, window)
    torch.testing.assert_close(
        out, paged_decode_attention_ref(q, kb, vb, kp, rw, qp,
                                        window=window), **F32)


def _tol(dtype):
    return F32 if dtype == "float32" else dict(rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_source_split_routes_agree(libs, dtype):
    """One input through the dense kernel with 1 range (the CTA writes the
    output) and 2, 3 and 7 ranges (partial rows, fixed-order combine):
    every route equals nsplit 1 and the plain version, and a route run
    twice gives the same bytes. Row 1 is masked (q_pos -1), row 2 has no
    live key at all (every range empty: zeros), row 3's live keys sit in
    the last range only; S 200 leaves a ragged last tile."""
    rng = np.random.default_rng(31)
    B, S, H, Hkv, D = 4, 200, 8, 2, 32
    dt = getattr(torch, dtype)
    q, k, v = (_t(rng.normal(size=s).astype(np.float32), dt)
               for s in ((B, H, D), (B, S, Hkv, D), (B, S, Hkv, D)))
    kpos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    kpos[0, 150:] = -1
    kpos[2] = -1
    kpos[3, :190] = -1
    qpos = np.array([140, -1, 50, 199], np.int32)
    qp, kp = _t(qpos), _t(kpos)
    ref = decode_attention_ref(q, k, v, qp, kp)
    one = _decode(libs[1], q, k, v, qp, kp, 0, nsplit=1)
    tiles = -(-S // dops._TK[dt])
    for ns in (n for n in (1, 2, 3, 7) if n <= tiles):
        o = _decode(libs[1], q, k, v, qp, kp, 0, nsplit=ns)
        torch.testing.assert_close(o.float(), ref.float(), **_tol(dtype))
        torch.testing.assert_close(o.float(), one.float(), **_tol(dtype))
        assert torch.equal(o, _decode(libs[1], q, k, v, qp, kp, 0,
                                      nsplit=ns))
        assert float(o[1:3].float().abs().sum()) == 0.0
        assert torch.isfinite(o.float()).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_sources_head_dim_256_g2(libs, dtype):
    """gemma3's decode shape, cut: D 256, G 2 (8 / 4 heads), a 64-key
    window, dense and paged (16-slot blocks in a shuffled order), through
    the wrappers' key split and 1 and 3 ranges."""
    rng = np.random.default_rng(2562)
    B, S, H, Hkv, D, bs, win = 2, 192, 8, 4, 256, 16, 64
    dt = getattr(torch, dtype)
    q, k, v = (_t(rng.normal(size=s).astype(np.float32), dt)
               for s in ((B, H, D), (B, S, Hkv, D), (B, S, Hkv, D)))
    kpos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    kpos[1, 150:] = -1
    qp, kp = _t(np.array([180, 149], np.int32)), _t(kpos)
    ref = decode_attention_ref(q, k, v, qp, kp, window=win)
    nb = S // bs
    order = rng.permutation(B * nb).astype(np.int32)
    kb, vb = (torch.zeros((B * nb, bs, Hkv, D), dtype=dt) for _ in range(2))
    pb = torch.full((B * nb, bs), -1, dtype=torch.int32)
    for b in range(B):
        blocks = order[b * nb:(b + 1) * nb]
        kb[blocks] = k[b].reshape(nb, bs, Hkv, D)
        vb[blocks] = v[b].reshape(nb, bs, Hkv, D)
        pb[blocks] = kp[b].reshape(nb, bs)
    rows = _t(order.reshape(B, nb))
    for ns in (None, 1, 3):
        o = _decode(libs[1], q, k, v, qp, kp, win, nsplit=ns)
        torch.testing.assert_close(o.float(), ref.float(), **_tol(dtype))
        o = _paged(libs[2], q, kb, vb, pb, rows, qp, win, nsplit=ns)
        torch.testing.assert_close(o.float(), ref.float(), **_tol(dtype))


@pytest.mark.parametrize("ns", [1, 3, 5])
def test_decode_source_window_across_ranges(libs, ns):
    """A 40-key sliding window whose live keys straddle the boundary of
    key ranges (32-key tiles in fp32: ranges of 2, 1 tiles at 3 and 5
    splits), beside a row whose window sits inside one tile."""
    rng = np.random.default_rng(7 + ns)
    B, S, H, Hkv, D = 2, 160, 4, 1, 64
    q = _t(rng.normal(size=(B, H, D)).astype(np.float32))
    k = _t(rng.normal(size=(B, S, Hkv, D)).astype(np.float32))
    v = _t(rng.normal(size=(B, S, Hkv, D)).astype(np.float32))
    kp = _t(np.tile(np.arange(S, dtype=np.int32), (B, 1)))
    qp = _t(np.array([83, 20], np.int32))
    out = _decode(libs[1], q, k, v, qp, kp, 40, nsplit=ns)
    torch.testing.assert_close(
        out, decode_attention_ref(q, k, v, qp, kp, window=40), **F32)


@pytest.mark.parametrize("ns", [1, 2])
def test_decode_source_ranges_longer_than_metadata_window(libs, ns):
    """Key ranges of 1100 and 576 keys, longer than the 512 keys whose
    metadata one pass stages: the CTA walks several passes, dense and
    paged (blocks of 20 slots, which do not divide a tile), with a
    700-key window that starts in the first pass."""
    rng = np.random.default_rng(1100 + ns)
    B, S, H, Hkv, D, bs = 1, 1100, 2, 1, 16, 20
    q = _t(rng.normal(size=(B, H, D)).astype(np.float32))
    k = _t(rng.normal(size=(B, S, Hkv, D)).astype(np.float32))
    v = _t(rng.normal(size=(B, S, Hkv, D)).astype(np.float32))
    kp = _t(np.arange(S, dtype=np.int32)[None])
    qp = _t(np.array([1050], np.int32))
    ref = decode_attention_ref(q, k, v, qp, kp, window=700)
    o = _decode(libs[1], q, k, v, qp, kp, 700, nsplit=ns)
    torch.testing.assert_close(o, ref, **F32)
    rw = _t(np.arange(S // bs, dtype=np.int32)[None])
    kb, vb = (x.reshape(-1, bs, Hkv, D) for x in (k, v))
    o = _paged(libs[2], q, kb, vb, kp.reshape(-1, bs), rw, qp, 700,
               nsplit=ns)
    torch.testing.assert_close(o, ref, **F32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bs", [4, 8, 16])
def test_paged_source_block_sizes_and_splits(libs, bs, dtype):
    """Pool blocks of 4, 8 and 16 slots: interior -1 entries in the block
    rows, dead slots, a block shared by requests 0 and 1 (read by both,
    written by neither), a masked row; the wrapper's split, 1 and 2
    ranges and one range per run of blocks all equal the plain version,
    and two launches give the same bytes."""
    rng = np.random.default_rng(bs)
    B, NB, NBmax, H, Hkv, D = 3, 40, 10, 8, 2, 32
    dt = getattr(torch, dtype)
    q, kb, vb = (_t(rng.normal(size=s).astype(np.float32), dt)
                 for s in ((B, H, D), (NB, bs, Hkv, D), (NB, bs, Hkv, D)))
    kpos = (np.arange(NB * bs).reshape(NB, bs) % 97).astype(np.int32)
    kpos[rng.random((NB, bs)) < 0.15] = -1
    perm = rng.permutation(NB)
    rows = np.full((B, NBmax), -1, np.int32)
    rows[0, :8] = perm[:8]
    rows[0, 3] = -1                                 # interior -1 entry
    rows[1, :6] = np.concatenate([perm[:2], perm[8:12]])   # shares 2
    rows[1, 4] = -1
    rows[2, :5] = perm[12:17]
    qpos = np.array([90, 70, -1], np.int32)
    kp, rw, qp = _t(kpos), _t(rows), _t(qpos)
    ref = paged_decode_attention_ref(q, kb, vb, kp, rw, qp)
    kb0, vb0 = kb.clone(), vb.clone()
    units = dops.split_units(NBmax * bs, dt, block=bs)
    for ns in sorted({1, 2, units} & set(range(1, units + 1))) + [None]:
        o = _paged(libs[2], q, kb, vb, kp, rw, qp, 0, nsplit=ns)
        torch.testing.assert_close(o.float(), ref.float(), **_tol(dtype))
        assert torch.equal(o, _paged(libs[2], q, kb, vb, kp, rw, qp, 0,
                                     nsplit=ns))
        assert float(o[2].float().abs().sum()) == 0.0
    assert torch.equal(kb, kb0) and torch.equal(vb, vb0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [2, 4])
def test_paged_source_head_slices(libs, n, dtype):
    """A head-sharded serving mesh's per-shard launches: each shard reads
    its head slice ``[:, :, h0:h1]`` of the pool blocks in place (a view
    strided in the head axis) and equals the plain version on that view;
    the shards' outputs put together equal the unsharded launch byte for
    byte (the split follows the pool's head count); a slice whose last
    dim is not dense is refused."""
    rng = np.random.default_rng(40 + n)
    B, NB, bs, NBmax, H, Hkv, D = 3, 24, 8, 6, 16, 4, 32
    dt = getattr(torch, dtype)
    q, kb, vb = (_t(rng.normal(size=s).astype(np.float32), dt)
                 for s in ((B, H, D), (NB, bs, Hkv, D), (NB, bs, Hkv, D)))
    kpos = rng.integers(0, 60, (NB, bs)).astype(np.int32)
    kpos[rng.random((NB, bs)) < 0.2] = -1
    rows = np.full((B, NBmax), -1, np.int32)
    for b in range(B):
        m = int(rng.integers(2, NBmax + 1))
        rows[b, :m] = rng.choice(NB, size=m, replace=False)
    qpos = np.array([50, -1, 59], np.int32)
    kp, rw, qp = _t(kpos), _t(rows), _t(qpos)
    full = _paged(libs[2], q, kb, vb, kp, rw, qp, 0)
    hs, gs = Hkv // n, H // n
    outs = []
    for s in range(n):
        ks, vs = kb[:, :, s * hs:(s + 1) * hs], vb[:, :, s * hs:(s + 1) * hs]
        assert not ks.is_contiguous() and ks.data_ptr() == \
            kb.data_ptr() + s * hs * D * kb.element_size()
        qs = q[:, s * gs:(s + 1) * gs].contiguous()
        o = _paged(libs[2], qs, ks, vs, kp, rw, qp, 0)
        torch.testing.assert_close(
            o.float(), paged_decode_attention_ref(qs, ks, vs, kp, rw,
                                                  qp).float(),
            **_tol(dtype))
        outs.append(o)
    assert torch.equal(torch.cat(outs, dim=1), full)
    bad = kb.transpose(2, 3)[:, :, :, :hs]
    with pytest.raises(ValueError, match="dense"):
        dops._slot_heads("paged", bad, bad, tuple(bad.shape), dt, q.device)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_source_g16_d256(libs, dtype):
    """G 16 heads of D 256 per KV head (recurrentgemma-9b's G * D = 4096,
    the cap of 2048 lifted), dense and paged, with a split."""
    rng = np.random.default_rng(16)
    B, S, H, Hkv, D = 2, 80, 16, 1, 256
    dt = getattr(torch, dtype)
    q, k, v = (_t(rng.normal(size=s).astype(np.float32), dt)
               for s in ((B, H, D), (B, S, Hkv, D), (B, S, Hkv, D)))
    kp = _t(np.tile(np.arange(S, dtype=np.int32), (B, 1)))
    qp = _t(np.array([79, 33], np.int32))
    o = _decode(libs[1], q, k, v, qp, kp, 0, nsplit=2)
    torch.testing.assert_close(
        o.float(), decode_attention_ref(q, k, v, qp, kp).float(),
        **_tol(dtype))
    bs = 8                                          # the same keys as blocks
    kb, vb = (x.reshape(B * S // bs, bs, Hkv, D) for x in (k, v))
    rw = _t(np.arange(B * S // bs, dtype=np.int32).reshape(B, S // bs))
    o = _paged(libs[2], q, kb, vb, kp.reshape(-1, bs), rw, qp, 0, nsplit=2)
    torch.testing.assert_close(
        o.float(), decode_attention_ref(q, k, v, qp, kp).float(),
        **_tol(dtype))


def test_decode_split_count_from_shapes():
    """The count depends on the shapes and dtype only: llama3-8b (Hkv 8)
    at the kernel table's shapes (B 4, S 1024; paged NBmax 64 x bs 16) and
    at the engines' (dense B 4, S 256-320; paged NBmax 16-24) splits up to
    2 x 132 CTAs; a batch whose B x Hkv already fills that runs one range;
    ranges are whole, non-empty tiles (dense) or runs of blocks holding a
    tile's keys (paged)."""
    f32, b16 = torch.float32, torch.bfloat16
    ns = dops.num_splits
    assert ns(4, 1024, 8, f32) == 8                 # 32 tiles, 4 each
    assert ns(4, 1024, 8, b16) == 8                 # 16 tiles, 2 each
    assert ns(4, 1024, 8, f32, block=16) == 8       # 32 runs of 2 blocks
    assert ns(4, 1024, 8, b16, block=16) == 8       # 16 runs of 4 blocks
    assert ns(4, 256, 8, f32) == 8 and ns(4, 320, 8, f32) == 5
    assert ns(4, 256, 8, b16) == 4
    assert ns(4, 384, 8, f32, block=16) == 6 and ns(4, 384, 8, b16,
                                                    block=16) == 6
    assert ns(64, 1024, 8, f32) == 1 and ns(50, 4096, 8, b16) == 1
    assert ns(1, 20, 1, f32) == 1                   # one tile
    assert dops.split_units(80, f32, block=20) == 4   # blocks over a tile
    for B, S, Hkv, block in ((4, 1024, 8, 0), (2, 200, 2, 0),
                             (1, 5000, 1, 0), (4, 1024, 8, 16),
                             (3, 40, 2, 4), (1, 72, 1, 8), (2, 96, 1, 32),
                             (1, 1100, 1, 20)):
        for dt in (f32, b16):
            n = ns(B, S, Hkv, dt, block=block)
            units = dops.split_units(S, dt, block=block)
            per = -(-units // n)            # the source's range length
            assert 1 <= n <= units and (n - 1) * per < units
            assert n == ns(B, S, Hkv, dt, block=block)

def _ssd(fs, ins, hg=None):
    """xdt, log_a, B, C (CPU tensors of one type) through the emulated
    kernel with ``hg`` heads per CTA (the wrapper's rule when None)."""
    nC, L, H, P = ins[0].shape
    N = ins[2].shape[-1]
    if hg is None:
        hg = sops.heads_per_cta(nC, L, H, P, N, ins[0].dtype)
    y = torch.empty((nC, L, H, P))
    st = torch.empty((nC, H, P, N))
    assert fs.ssd_intra_fwd(*[x.data_ptr() for x in ins], y.data_ptr(),
                            st.data_ptr(), nC, L, H, P, N,
                            int(ins[0].dtype == torch.bfloat16), hg,
                            None) == 0
    return y, st


def _worst_ratio(pairs, tol):
    """Largest |a - b| / (tol + tol |b|): <= 1 is allclose(rtol=atol=tol)."""
    return max(float(((a - b).abs() / (tol + tol * b.abs())).max())
               for a, b in pairs)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nC,L,H,P,N", SSD_CASES)
def test_ssd_source_vs_plain(libs, nC, L, H, P, N, dtype):
    """Includes chunk lengths 1 and 7 (ssd_chunked hands the kernel any L
    up to the chunk); bf16 inputs, fp32 arithmetic in both versions."""
    dt = getattr(torch, dtype)
    ins = [_t(x, dt) for x in _ssd_inputs(nC * L + 2, nC, L, H, P, N)]
    y, st = _ssd(libs[3], ins)
    yr, sr = ssd_intra_ref(*ins)
    torch.testing.assert_close(y, yr, **F32)
    torch.testing.assert_close(st, sr, **F32)


def test_ssd_source_row_blocks_and_padding(libs):
    """L 70 spans five 16-row strips (the last one ragged); P 6 and N 5
    leave padding columns in the staged tiles and rows whose width is not
    a multiple of 16 bytes (plain loads instead of cp.async)."""
    nC, L, H, P, N = 1, 70, 2, 6, 5
    ins = [_t(x) for x in _ssd_inputs(70, nC, L, H, P, N)]
    y, st = _ssd(libs[3], ins)
    yr, sr = ssd_intra_ref(*ins)
    torch.testing.assert_close(y, yr, **F32)
    torch.testing.assert_close(st, sr, **F32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nC,L,H,P,N", [(2, 32, 6, 16, 16),
                                        (1, 70, 5, 6, 5)])
def test_ssd_source_head_groups_bit_identical(libs, nC, L, H, P, N, dtype):
    """The scores are formed the same way whatever the number of heads per
    CTA, so every group size gives the same bytes (1, 2, 4 and H; with H
    6 and 5 the last group is partial); and they hold the plain version."""
    dt = getattr(torch, dtype)
    ins = [_t(x, dt) for x in _ssd_inputs(nC + L + H, nC, L, H, P, N)]
    y1, s1 = _ssd(libs[3], ins, hg=1)
    for hg in (2, 4, H):
        y, st = _ssd(libs[3], ins, hg=hg)
        assert torch.equal(y, y1) and torch.equal(st, s1), hg
    yr, sr = ssd_intra_ref(*ins)
    torch.testing.assert_close(y1, yr, **F32)
    torch.testing.assert_close(s1, sr, **F32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_source_full_width_slice(libs, dtype):
    """mamba2-370m's widths (L 128, H 32, P 64, N 128) on two chunks, at
    the model's distributions (chip_smoke.ssd_inputs), with the wrapper's
    group size: within the reference's allclose bound (3e-5; bf16 inputs
    are exact in fp32, so the same bound). The worst ratio to it is
    printed (PERF.md); ~6 s per dtype under the emulator."""
    dt = getattr(torch, dtype)
    ins = [_t(x, dt) for x in _ssd_model_inputs(1, 2, 128, 32, 64, 128)]
    y, st = _ssd(libs[3], ins)
    yr, sr = ssd_intra_ref(*ins)
    ratio = _worst_ratio(((y, yr), (st, sr)), 3e-5)
    print(f"ssd_intra full-width slice {dtype}: worst ratio to the "
          f"allclose bound {ratio:.3f}, max |y| {float(yr.abs().max()):.1f}")
    assert ratio <= 1.0
    assert torch.isfinite(y).all() and torch.isfinite(st).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_source_two_launches_identical(libs, dtype):
    dt = getattr(torch, dtype)
    ins = [_t(x, dt) for x in _ssd_model_inputs(5, 1, 48, 4, 32, 32)]
    y1, s1 = _ssd(libs[3], ins)
    y2, s2 = _ssd(libs[3], ins)
    assert torch.equal(y1, y2) and torch.equal(s1, s2)


def test_ssd_smem_plan_matches_source(libs):
    """ops.smem_bytes states the source's shared-memory plan exactly."""
    for L, N, P in ((1, 8, 16), (7, 5, 6), (70, 5, 6), (128, 128, 64),
                    (160, 64, 32), (33, 130, 70), (64, 128, 16)):
        for hg in (1, 3, 8):
            for dt in (torch.float32, torch.bfloat16):
                assert libs[3].ssd_intra_smem_bytes(
                    L, N, P, hg, int(dt == torch.bfloat16)) == \
                    sops.smem_bytes(L, N, P, hg, dt)


def test_ssd_heads_per_cta_rule():
    """The group size is a function of the shapes alone; at mamba2-370m's
    prefill shape it keeps a full wave of CTAs; it never exceeds H and
    always fits a CTA; a lone chunk takes one head per CTA."""
    f32, b16 = torch.float32, torch.bfloat16
    for dt in (f32, b16):
        hg = sops.heads_per_cta(60, 128, 32, 64, 128, dt)
        assert hg == 8 and 60 * -(-32 // hg) >= 132
        assert sops.heads_per_cta(1, 128, 32, 64, 128, dt) == 1
        assert sops.heads_per_cta(3, 16, 4, 32, 16, dt) == 1
        for nC, L, H, P, N in ((500, 128, 32, 64, 128), (2, 8, 2, 16, 8),
                               (900, 160, 3, 6, 5), (400, 64, 1, 64, 64)):
            hg = sops.heads_per_cta(nC, L, H, P, N, dt)
            assert 1 <= hg <= H
            assert sops.smem_bytes(L, N, P, hg, dt) <= sops._SMEM_MAX
            assert hg == sops.heads_per_cta(nC, L, H, P, N, dt)
    assert sops.smem_bytes(512, 128, 64, 1, f32) > sops._SMEM_MAX


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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,D,theta", [(4, 256, 1e6), (8, 64, 1e4)])
def test_rope_source_family_shapes(libs, H, D, theta, dtype):
    """The engine's RPE transform at gemma3-4b's heads (Hkv 4, D 256,
    theta 1e6) and granite-moe-1b's (Hkv 8, D 64, theta 1e4): K of 3
    layers x 40 tokens sharing one position vector within a 2.6k-token
    layout span, applying and removing, fp32 at 3e-5 and bf16 at 3e-2."""
    L, n = 3, 40
    dt = getattr(torch, dtype)
    tol = F32 if dtype == "float32" else dict(rtol=3e-2, atol=3e-2)
    x, _ = _rope_inputs(D, L * n, H, D)
    start = np.random.default_rng(D).integers(0, 2600 - n)
    pos = _t(np.arange(start, start + n, dtype=np.int32))
    x = _t(x, dt)
    for inverse in (False, True):
        out = _rope(libs[4], x, pos, theta, inverse)
        torch.testing.assert_close(
            out.float(), rope_ref(x, pos.repeat(L), theta=theta,
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
