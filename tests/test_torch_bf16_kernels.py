"""The chunk and decode kernels' mixed instantiation, bf16 q and out over
fp32 K/V (a bf16 model over the engine's fp32 caches), against their
plain versions: compiled for the CPU against the emulation shim
(``src/repro_torch/kernels/emu``), and ``cuda``-marked on the card. This
file imports neither jax nor the reference package, so it also runs on
a GPU host without them::

    PYTHONPATH=src python -m pytest --noconftest -m cuda \\
        tests/test_torch_bf16_kernels.py

The standard: out within one bf16 rounding of the plain version's value
before it rounds, ``|out - ref32| <= 2^-8 |ref32| + 3e-5`` (the plain
version on q upcast to fp32, which is what it computes before its final
cast), and the fp32 mass within 3e-5."""
import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from repro_torch import device as devmod
from repro_torch.kernels import build
from repro_torch.kernels.chunk_attention import ops as cops
from repro_torch.kernels.chunk_attention.ref import chunk_attention_ref
from repro_torch.kernels.decode_attention import ops as dops
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

torch.set_num_threads(2)
EMU = os.path.join(os.path.dirname(build.__file__), "emu")
ONE_ROUNDING = 2.0 ** -8
ATOL = 3e-5
MIXED = 2            # the C entry points' type code of the mix


def _chunk_inputs(seed, A, S, H, Hkv, D, C, B=1):
    """B rows of two packed requests (segments 0 / 1) over one KV row
    each, padding rows and slots, C chunks: bf16 q, fp32 K/V."""
    rng = np.random.default_rng(seed)
    kpos = np.full((B, S), -1, np.int32)
    kseg = np.full((B, S), -1, np.int32)
    kch = np.full((B, S), C - 1, np.int32)
    qpos = np.full((B, A), -1, np.int32)
    qseg = np.full((B, A), -1, np.int32)
    for b in range(B):
        sl = (S * 5 // 8, S // 4)
        al = (A // 2, A // 4)
        k0 = a0 = 0
        for r in range(2):
            kpos[b, k0:k0 + sl[r]] = np.arange(sl[r])
            kseg[b, k0:k0 + sl[r]] = r
            kch[b, k0:k0 + sl[r]] = np.minimum(np.arange(sl[r]) // 7, C - 2)
            qpos[b, a0:a0 + al[r]] = np.sort(rng.choice(sl[r], al[r],
                                                        replace=False))
            qseg[b, a0:a0 + al[r]] = r
            k0 += sl[r]
            a0 += al[r]
    f = lambda *s: torch.from_numpy(  # noqa: E731
        rng.normal(size=s).astype(np.float32))
    t = torch.from_numpy
    return dict(q=f(B, A, H, D).bfloat16(), k=f(B, S, Hkv, D),
                v=f(B, S, Hkv, D), q_pos=t(qpos), k_pos=t(kpos),
                k_chunk=t(kch), q_seg=t(qseg), k_seg=t(kseg))


def _decode_inputs(seed, B, S, H, Hkv, D):
    """bf16 q [B, H, D] over an fp32 arena; the last row masked (q_pos
    -1), the others of assorted lengths."""
    rng = np.random.default_rng(seed)
    lens = np.linspace(S, S // 3, B).astype(int)
    kpos = np.where(np.arange(S)[None] < lens[:, None], np.arange(S)[None],
                    -1).astype(np.int32)
    qpos = (lens - 1).astype(np.int32)
    qpos[-1] = -1
    f = lambda *s: torch.from_numpy(  # noqa: E731
        rng.normal(size=s).astype(np.float32))
    return dict(q=f(B, H, D).bfloat16(), k=f(B, S, Hkv, D),
                v=f(B, S, Hkv, D), q_pos=torch.from_numpy(qpos),
                k_pos=torch.from_numpy(kpos))


def _chunk_plain(x, C, window, q):
    outs = [chunk_attention_ref(q[b], x["k"][b], x["v"][b], x["q_pos"][b],
                                x["k_pos"][b], x["k_chunk"][b],
                                num_chunks=C, window=window,
                                q_seg=x["q_seg"][b], k_seg=x["k_seg"][b])
            for b in range(q.shape[0])]
    return torch.stack([o for o, _ in outs]), torch.stack([m for _, m in
                                                           outs])


def _hold(name, out, ref32):
    assert out.dtype == torch.bfloat16 and ref32.dtype == torch.float32
    d = (out.float() - ref32).abs()
    bound = ONE_ROUNDING * ref32.abs() + ATOL
    assert bool((d <= bound).all()), (name, float((d / bound).max()))
    return float((d / bound).max())


# ---------------- the sources on the CPU (emulation shim) -------------------
@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler (g++) for the emulated build")
    out = tmp_path_factory.mktemp("emu-mixed")
    procs = {}
    for name in ("chunk_attention", "decode_attention"):
        so = out / f"lib{name}_emu.so"
        cmd = [cxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-x", "c++",
               f"-I{EMU}", "-include", os.path.join(EMU, "cuda_emu.h"),
               str(build.source(name)), "-o", str(so), "-lpthread"]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT,
                                        text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate(timeout=300)
        assert proc.returncode == 0, log
        libs[name] = ctypes.CDLL(str(so))
    fc = libs["chunk_attention"].chunk_attention_fwd
    fc.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 10 + \
        [ctypes.c_void_p]
    fc.restype = ctypes.c_int
    sm = libs["chunk_attention"].chunk_attention_smem_bytes
    sm.argtypes, sm.restype = [ctypes.c_int] * 4, ctypes.c_longlong
    return libs["chunk_attention"], dops.bind(libs["decode_attention"])


@pytest.mark.parametrize("A,S,H,Hkv,D,C,window,nsplit", [
    (40, 96, 8, 2, 32, 16, 48, 1),     # G 4, a window, C 16
    (40, 96, 8, 2, 32, 16, 48, 3),     # the same over 3 key ranges
    (24, 70, 6, 2, 64, 8, 0, 2),       # G 3 (64 rows not a multiple)
])
def test_chunk_mixed_source_vs_plain(emu, A, S, H, Hkv, D, C, window,
                                     nsplit):
    lib, _ = emu
    x = _chunk_inputs(A + nsplit, A, S, H, Hkv, D, C)
    out = torch.full_like(x["q"], float("nan"))
    mass = torch.full((1, A, C), float("nan"))
    work = torch.full((cops.workspace_floats(1, A, H, Hkv, D, C, nsplit),),
                      float("nan"))
    ts = [x[n] for n in ("q", "k", "v", "q_pos", "k_pos", "k_chunk",
                         "q_seg", "k_seg")]
    assert lib.chunk_attention_fwd(
        *[t.data_ptr() for t in ts], out.data_ptr(), work.data_ptr(),
        mass.data_ptr(), 1, A, S, H, Hkv, D, C, window, MIXED, nsplit,
        None) == 0
    ref32, mref = _chunk_plain(x, C, window, x["q"].float())
    _hold("chunk", out, ref32)
    # the plain version's own bf16 output (the wrapper's CPU path): the
    # two roundings of fp32 values this close land at most one ulp apart
    ref16, _ = _chunk_plain(x, C, window, x["q"])
    assert ref16.dtype == torch.bfloat16
    d16 = (out.float() - ref16.float()).abs()
    assert bool((d16 <= 2 * ONE_ROUNDING * ref16.float().abs() + ATOL)
                .all()), float(d16.max())
    torch.testing.assert_close(mass, mref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("nsplit", [1, 3])
def test_decode_mixed_source_vs_plain(emu, nsplit):
    _, lib = emu
    B, S, H, Hkv, D = 3, 100, 8, 2, 32
    x = _decode_inputs(nsplit, B, S, H, Hkv, D)
    for window in (0, 40):
        out = torch.full_like(x["q"], float("nan"))
        nw = dops.workspace_floats(B, H, D, nsplit)
        work = torch.full((max(nw, 1),), float("nan"))
        assert lib.decode_attention_fwd(
            *[x[n].data_ptr() for n in ("q", "k", "v", "q_pos", "k_pos")],
            out.data_ptr(), work.data_ptr() if nw else None, B, S, H, Hkv,
            D, window, MIXED, nsplit, None) == 0
        ref32 = decode_attention_ref(x["q"].float(), x["k"], x["v"],
                                     x["q_pos"], x["k_pos"], window=window)
        _hold("decode", out, ref32)
        assert float(out[-1].float().abs().max()) == 0.0


def test_mixed_entries_plan_and_refusals(emu):
    """The mix takes the fp32 plan (K/V tiles and shared memory); the
    paged entry and unknown type codes refuse it."""
    clib, dlib = emu
    for D in (32, 64, 128, 256):
        assert clib.chunk_attention_smem_bytes(D, 16, MIXED, 8) == \
            clib.chunk_attention_smem_bytes(D, 16, 0, 8) > 0
        assert dlib.decode_attention_smem_bytes(D, 4, MIXED, 0) == \
            dlib.decode_attention_smem_bytes(D, 4, 0, 0) > 0
    assert clib.chunk_attention_smem_bytes(128, 16, 3, 8) == -1
    assert dlib.decode_attention_smem_bytes(128, 4, MIXED, 1) == -1
    x = _decode_inputs(0, 2, 32, 4, 2, 32)
    out = torch.empty_like(x["q"])
    rows = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32)
    assert dlib.paged_decode_attention_fwd(
        x["q"].data_ptr(), x["k"].data_ptr(), x["v"].data_ptr(),
        x["k_pos"].data_ptr(), rows.data_ptr(), x["q_pos"].data_ptr(),
        out.data_ptr(), None, 2, 4, 2, 16, 4, 2, 2, 32, 0, MIXED, 1,
        None) != 0


# ---------------- the CUDA kernels on the card ------------------------------
def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel; run on the card)")
    return devmod.resolve("cuda")     # fp32 products in IEEE fp32, no TF32


@pytest.mark.cuda
@pytest.mark.parametrize("A,S,H,Hkv,D,C,window,B", [
    (40, 96, 8, 2, 32, 16, 48, 1),
    (256, 1024, 32, 8, 128, 16, 0, 1),    # llama3-8b's width, key splits
    (160, 640, 32, 8, 128, 16, 0, 2),
    (64, 512, 8, 4, 256, 16, 200, 1),     # D 256, a window
])
def test_chunk_mixed_cuda_vs_plain(A, S, H, Hkv, D, C, window, B):
    dev = _need_cuda()
    x = {n: t.to(dev) for n, t in _chunk_inputs(A, A, S, H, Hkv, D, C,
                                                  B).items()}
    cops.chunk_attention.launches_by_type.clear()
    args = [x[n] for n in ("q", "k", "v", "q_pos", "k_pos", "k_chunk")]
    kw = dict(q_seg=x["q_seg"], k_seg=x["k_seg"], num_chunks=C,
              window=window)
    out, mass = cops.chunk_attention(*args, **kw)
    out2, mass2 = cops.chunk_attention(*args, **kw)
    torch.cuda.synchronize()
    assert dict(cops.chunk_attention.launches_by_type) == {
        build.ATTN_TYPE_NAMES[MIXED]: 2}
    assert torch.equal(out, out2) and torch.equal(mass, mass2)
    ref32, mref = _chunk_plain(x, C, window, x["q"].float())
    _hold("chunk", out, ref32)
    torch.testing.assert_close(mass, mref, rtol=0, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,Hkv,D,window", [
    (3, 100, 8, 2, 32, 0), (4, 256, 32, 8, 128, 0), (4, 1024, 32, 8, 128, 0),
    (4, 2048, 8, 4, 256, 1024)])
def test_decode_mixed_cuda_vs_plain(B, S, H, Hkv, D, window):
    dev = _need_cuda()
    x = {n: t.to(dev) for n, t in _decode_inputs(S, B, S, H, Hkv,
                                                 D).items()}
    dops.decode_attention.launches_by_type.clear()
    args = [x[n] for n in ("q", "k", "v", "q_pos", "k_pos")]
    out = dops.decode_attention(*args, window=window)
    out2 = dops.decode_attention(*args, window=window)
    torch.cuda.synchronize()
    assert dict(dops.decode_attention.launches_by_type) == {
        build.ATTN_TYPE_NAMES[MIXED]: 2}
    assert torch.equal(out, out2)
    ref32 = decode_attention_ref(x["q"].float(), *args[1:], window=window)
    _hold("decode", out, ref32)
    assert float(out[-1].float().abs().max()) == 0.0
    with pytest.raises(TypeError, match="the kernel takes"):
        blocks = torch.zeros((4, 16, Hkv, D), device=dev)
        dops.paged_decode_attention(
            x["q"], blocks, blocks, torch.zeros((4, 16), dtype=torch.int32,
                                                device=dev),
            torch.zeros((B, 1), dtype=torch.int32, device=dev), x["q_pos"])
