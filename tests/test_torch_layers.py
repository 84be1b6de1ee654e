"""Port layers vs the JAX reference layers: the same numpy inputs through
``repro.models.layers`` and ``repro_torch.models.layers``, fp32
``allclose`` at 1e-5."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.models import layers as TL

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _close(a, b, **kw):
    np.testing.assert_allclose(_np(a), _np(b), **(kw or TOL))


@pytest.fixture
def r():
    return np.random.default_rng(7)


def _f(r, *shape):
    return r.normal(size=shape).astype(np.float32)


def test_rms_norm(r):
    x, w = _f(r, 3, 5, 64), _f(r, 64) * 0.1
    _close(TL.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6),
           JL.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6))


@pytest.mark.parametrize("theta", [1e4, 5e5])
def test_rope_cos_sin(r, theta):
    pos = r.integers(0, 4000, (2, 9)).astype(np.int32)
    tc, ts = TL.rope_cos_sin(torch.from_numpy(pos), 32, theta)
    jc, js = JL.rope_cos_sin(jnp.asarray(pos), 32, theta)
    _close(tc, jc)
    _close(ts, js)


@pytest.mark.parametrize("inverse", [False, True])
def test_apply_rope(r, inverse):
    x = _f(r, 2, 11, 4, 32)
    pos = r.integers(0, 3000, (2, 11)).astype(np.int32)
    t = TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 5e5,
                      inverse=inverse)
    j = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 5e5,
                      inverse=inverse)
    _close(t, j)


def test_rope_round_trip(r):
    x = _f(r, 7, 2, 16)
    pos = torch.from_numpy(r.integers(0, 10_000, 7).astype(np.int32))
    y = TL.apply_rope(TL.apply_rope(torch.from_numpy(x), pos, 1e4), pos,
                      1e4, inverse=True)
    _close(y, x, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("window,segs", [(0, False), (5, False), (0, True)])
def test_position_mask(r, window, segs):
    qp = r.integers(-1, 20, (2, 6)).astype(np.int32)
    kp = r.integers(-1, 20, (2, 13)).astype(np.int32)
    qs = r.integers(0, 2, (2, 6)).astype(np.int32) if segs else None
    ks = r.integers(0, 2, (2, 13)).astype(np.int32) if segs else None
    t = TL.position_mask(torch.from_numpy(qp), torch.from_numpy(kp), window,
                         q_seg=None if qs is None else torch.from_numpy(qs),
                         k_seg=None if ks is None else torch.from_numpy(ks))
    j = JL.position_mask(jnp.asarray(qp), jnp.asarray(kp), window,
                         q_seg=None if qs is None else jnp.asarray(qs),
                         k_seg=None if ks is None else jnp.asarray(ks))
    np.testing.assert_array_equal(_np(t), _np(j))


def test_safe_softmax_masked_rows_zero(r):
    s = _f(r, 3, 8)
    s[1] = TL.NEG_INF
    t = TL._safe_softmax(torch.from_numpy(s))
    _close(t, JL._safe_softmax(jnp.asarray(s)))
    assert float(t[1].abs().sum()) == 0.0


@pytest.mark.parametrize("H,Hkv,stats", [(4, 2, True), (4, 4, False),
                                         (8, 2, True)])
def test_gqa_attend_dense(r, H, Hkv, stats):
    B, Tq, Tk, D, C = 2, 5, 12, 16, 6
    q, k, v = _f(r, B, Tq, H, D), _f(r, B, Tk, Hkv, D), _f(r, B, Tk, Hkv, D)
    qp = r.integers(-1, Tk, (B, Tq)).astype(np.int32)
    kp = np.tile(np.arange(Tk, dtype=np.int32), (B, 1))
    kp[:, -2:] = -1
    kc = r.integers(0, C, (B, Tk)).astype(np.int32) if stats else None
    tm = TL.position_mask(torch.from_numpy(qp), torch.from_numpy(kp))
    jm = JL.position_mask(jnp.asarray(qp), jnp.asarray(kp))
    t = TL.gqa_attend_dense(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), tm,
                            None if kc is None else torch.from_numpy(kc), C)
    j = JL.gqa_attend_dense(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            jm, None if kc is None else jnp.asarray(kc), C)
    for a, b in zip(t, j):
        assert (a is None) == (b is None)
        if a is not None:
            _close(a, b)


def test_gqa_attend_dense_bf16_probs_cast(r):
    """``probs.astype(v.dtype)`` before the PV product, like the
    reference: bf16 values give bf16 outputs from rounded probabilities."""
    B, Tq, Tk, H, D = 1, 4, 9, 4, 16
    q, k, v = _f(r, B, Tq, H, D), _f(r, B, Tk, 2, D), _f(r, B, Tk, 2, D)
    qp = np.array([[3, 5, 8, -1]], np.int32)
    kp = np.arange(Tk, dtype=np.int32)[None]
    tv = torch.from_numpy(v).to(torch.bfloat16)
    t = TL.gqa_attend_dense(torch.from_numpy(q), torch.from_numpy(k), tv,
                            TL.position_mask(torch.from_numpy(qp),
                                             torch.from_numpy(kp)))[0]
    j = JL.gqa_attend_dense(jnp.asarray(q), jnp.asarray(k),
                            jnp.asarray(v).astype(jnp.bfloat16),
                            JL.position_mask(jnp.asarray(qp),
                                             jnp.asarray(kp)))[0]
    assert t.dtype == torch.bfloat16
    np.testing.assert_allclose(t.float().numpy(),
                               np.asarray(j, np.float32), rtol=3e-2,
                               atol=3e-2)


@pytest.mark.parametrize("window", [0, 7])
def test_decode_attend(r, window):
    B, S, H, Hkv, D = 3, 20, 4, 2, 16
    q, k, v = _f(r, B, H, D), _f(r, B, S, Hkv, D), _f(r, B, S, Hkv, D)
    qp = np.array([5, 19, -1], np.int32)
    kp = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    t = TL.decode_attend(torch.from_numpy(q), torch.from_numpy(k),
                         torch.from_numpy(v), torch.from_numpy(qp),
                         torch.from_numpy(kp), window)
    j = JL.decode_attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         jnp.asarray(qp), jnp.asarray(kp), window)
    _close(t, j)
    assert float(t[2].abs().sum()) == 0.0


def test_swiglu(r):
    x, wi, wo = _f(r, 2, 3, 32), _f(r, 32, 2, 48) * 0.2, _f(r, 48, 32) * 0.2
    _close(TL.swiglu(torch.from_numpy(x), torch.from_numpy(wi),
                     torch.from_numpy(wo)),
           JL.swiglu(jnp.asarray(x), jnp.asarray(wi), jnp.asarray(wo)))
