"""Port kernels: each plain PyTorch version against the JAX oracle
(``ref.py``) and the Pallas TPU kernel run in interpret mode, on the
parametrisations of ``tests/test_kernels.py``, at 3e-5 (fp32) / 3e-2
(bf16). On the CPU the wrappers take the plain version and never count a
launch. The CUDA kernels themselves are checked against the plain
versions in ``test_torch_kernels_cuda.py`` (on a GPU) and by
``python3 chip_smoke.py`` at full width on the card."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.chunk_attention.ops import chunk_attention as j_chunk
from repro.kernels.chunk_attention.ref import chunk_attention_ref as j_cref
from repro.kernels.decode_attention.ops import decode_attention as j_dec
from repro.kernels.decode_attention.ops import \
    paged_decode_attention as j_paged
from repro.kernels.decode_attention.ref import decode_attention_ref as j_dref
from repro.kernels.decode_attention.ref import \
    paged_decode_attention_ref as j_pref
from repro_torch.kernels.chunk_attention import ops as cops
from repro_torch.kernels.decode_attention import ops as dops
from test_torch_kernels_cuda import (BF16, CHUNK_CASES, DECODE_CASES, F32,
                                     PAGED_CASES, _chunk_inputs,
                                     _decode_inputs, _np, _paged_inputs,
                                     _segment_inputs, _t)

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _zero_counts():
    cops.chunk_attention.launches = 0
    dops.decode_attention.launches = 0
    dops.paged_decode_attention.launches = 0
    yield
    # the CPU path never launches a kernel
    if not torch.cuda.is_available():
        assert cops.chunk_attention.launches == 0
        assert dops.decode_attention.launches == 0
        assert dops.paged_decode_attention.launches == 0


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


# ---------------- chunk attention -------------------------------------------
@pytest.mark.parametrize("A,S,H,Hkv,D,C,window", CHUNK_CASES)
def test_chunk_plain_vs_jax_ref(A, S, H, Hkv, D, C, window):
    ins = _chunk_inputs(A + S, A, S, H, Hkv, D, C)
    o, m = cops.chunk_attention(*_t(*ins), num_chunks=C, window=window)
    oref, mref = j_cref(*_j(*ins), num_chunks=C, window=window)
    np.testing.assert_allclose(_np(o), _np(oref), **F32)
    np.testing.assert_allclose(_np(m), _np(mref), **F32)


@pytest.mark.kernel_interpret
@pytest.mark.parametrize("A,S,H,Hkv,D,C,window", CHUNK_CASES)
def test_chunk_plain_vs_pallas(A, S, H, Hkv, D, C, window):
    ins = _chunk_inputs(A + S, A, S, H, Hkv, D, C)
    o, m = cops.chunk_attention(*_t(*ins), num_chunks=C, window=window)
    ok, mk = j_chunk(*_j(*ins), num_chunks=C, window=window, block_q=16,
                     block_k=32)
    np.testing.assert_allclose(_np(o), _np(ok), **F32)
    np.testing.assert_allclose(_np(m), _np(mk), **F32)


def _bf16_inputs():
    A, S, H, Hkv, D, C = 16, 64, 4, 2, 32, 8
    rng = np.random.default_rng(3)
    q = rng.normal(size=(A, H, D)).astype(np.float32)
    k = rng.normal(size=(S, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(S, Hkv, D)).astype(np.float32)
    qpos = (np.arange(A) * 2).astype(np.int32)
    kpos = np.arange(S, dtype=np.int32)
    kch = (np.arange(S) // 8 % C).astype(np.int32)
    return (q, k, v, qpos, kpos, kch), C


@pytest.mark.kernel_interpret
def test_chunk_plain_bf16_vs_jax():
    ins, C = _bf16_inputs()
    o, m = cops.chunk_attention(*_t(*ins, dtype=torch.bfloat16),
                                num_chunks=C)
    assert o.dtype == torch.bfloat16 and m.dtype == torch.float32
    jq, jk, jv, *rest = _j(*ins)
    jb = [x.astype(jnp.bfloat16) for x in (jq, jk, jv)] + rest
    oref, mref = j_cref(*jb, num_chunks=C)
    ok, _mk = j_chunk(*jb, num_chunks=C, block_q=16, block_k=32)
    np.testing.assert_allclose(_np(o), _np(oref), **BF16)
    np.testing.assert_allclose(_np(o), _np(ok), **BF16)
    np.testing.assert_allclose(_np(m), _np(mref), **BF16)


@pytest.mark.kernel_interpret
def test_chunk_plain_segment_mask_vs_jax():
    """Packed two-request masking: the plain version equals the oracle
    and the Pallas kernel with the same segment ids, and two separate
    per-segment calls."""
    (q, k, v, qpos, kpos, kch, qseg, kseg), C = _segment_inputs(5)
    o, m = cops.chunk_attention(*_t(q, k, v, qpos, kpos, kch),
                                q_seg=_t(qseg)[0], k_seg=_t(kseg)[0],
                                num_chunks=C)
    jq, jk, jv, jqp, jkp, jkc, jqs, jks = _j(q, k, v, qpos, kpos, kch,
                                             qseg, kseg)
    oref, mref = j_cref(jq, jk, jv, jqp, jkp, jkc, q_seg=jqs, k_seg=jks,
                        num_chunks=C)
    ok, mk = j_chunk(jq, jk, jv, jqp, jkp, jkc, q_seg=jqs, k_seg=jks,
                     num_chunks=C, block_q=16, block_k=32)
    for ref_o, ref_m in ((oref, mref), (ok, mk)):
        np.testing.assert_allclose(_np(o), _np(ref_o), **F32)
        np.testing.assert_allclose(_np(m), _np(ref_m), **F32)
    o1, m1 = cops.chunk_attention(*_t(q[:16], k[:48], v[:48], qpos[:16],
                                      kpos[:48], kch[:48]), num_chunks=C)
    np.testing.assert_allclose(_np(o[:16]), _np(o1), **F32)
    np.testing.assert_allclose(_np(m[:16]), _np(m1), **F32)


def test_chunk_plain_mass_rows_sum_to_heads():
    A, S, H, Hkv, D, C = 24, 96, 6, 2, 32, 8
    rng = np.random.default_rng(11)
    q = rng.normal(size=(A, H, D)).astype(np.float32)
    k = rng.normal(size=(S, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(S, Hkv, D)).astype(np.float32)
    qpos = (np.arange(A) + 8).astype(np.int32)
    kpos = np.arange(S, dtype=np.int32)
    kch = (np.arange(S) % C).astype(np.int32)
    _, m = cops.chunk_attention(*_t(q, k, v, qpos, kpos, kch), num_chunks=C)
    np.testing.assert_allclose(_np(m).sum(-1), H, rtol=1e-4)


def test_chunk_plain_masked_rows_zero():
    """A row with no allowed key (pos -1) gives 0 output and 0 mass."""
    q, k, v, qpos, kpos, kch = _chunk_inputs(2, 8, 32, 4, 2, 16, 4)
    qpos[:3] = -1
    o, m = cops.chunk_attention(*_t(q, k, v, qpos, kpos, kch), num_chunks=4)
    assert float(o[:3].abs().sum()) == 0.0 and float(m[:3].sum()) == 0.0


# ---------------- decode attention ------------------------------------------
@pytest.mark.parametrize("B,S,H,Hkv,D,window", DECODE_CASES)
def test_decode_plain_vs_jax_ref(B, S, H, Hkv, D, window):
    ins = _decode_inputs(S, B, S, H, Hkv, D)
    o = dops.decode_attention(*_t(*ins), window=window)
    q, k, v, qp, kp = _j(*ins)
    r = jnp.stack([j_dref(q[b], k[b], v[b], qp[b], kp[b], window=window)
                   for b in range(B)])
    np.testing.assert_allclose(_np(o), _np(r), **F32)


@pytest.mark.kernel_interpret
@pytest.mark.parametrize("B,S,H,Hkv,D,window", DECODE_CASES)
def test_decode_plain_vs_pallas(B, S, H, Hkv, D, window):
    ins = _decode_inputs(S, B, S, H, Hkv, D)
    o = dops.decode_attention(*_t(*ins), window=window)
    ok = j_dec(*_j(*ins), window=window, block_k=16)
    np.testing.assert_allclose(_np(o), _np(ok), **F32)


def test_decode_plain_masked_row_zero():
    q, k, v, qpos, kpos = _decode_inputs(1, 3, 40, 4, 2, 16)
    qpos[1] = -1
    o = dops.decode_attention(*_t(q, k, v, qpos, kpos))
    assert float(o[1].abs().sum()) == 0.0


# ---------------- paged decode attention ------------------------------------
@pytest.mark.kernel_interpret
@pytest.mark.parametrize("B,NB,bs,H,Hkv,D,window", PAGED_CASES)
def test_paged_plain_vs_jax(B, NB, bs, H, Hkv, D, window):
    ins = _paged_inputs(NB * bs, B, NB, bs, H, Hkv, D)
    o = dops.paged_decode_attention(*_t(*ins), window=window)
    r = j_pref(*ins, window=window)
    ok = j_paged(*_j(*ins), window=window, interpret=True)
    np.testing.assert_allclose(_np(o), _np(r), **F32)
    np.testing.assert_allclose(_np(o), _np(ok), **F32)


def test_paged_plain_equals_dense_on_gathered_rows():
    """The paged plain version over blocks == the dense plain version
    over the same blocks gathered by hand (the arena layout)."""
    q, kb, vb, kpos, rows, qpos = _paged_inputs(9, 3, 12, 8, 8, 2, 32)
    o = dops.paged_decode_attention(*_t(q, kb, vb, kpos, rows, qpos))
    bs = kb.shape[1]
    safe = np.maximum(rows, 0)
    k = kb[safe].reshape(3, -1, 2, 32)
    v = vb[safe].reshape(3, -1, 2, 32)
    kp = np.where(np.repeat(rows >= 0, bs, axis=1),
                  kpos[safe].reshape(3, -1), -1)
    od = dops.decode_attention(*_t(q, k, v, qpos, kp))
    np.testing.assert_array_equal(_np(o), _np(od))
