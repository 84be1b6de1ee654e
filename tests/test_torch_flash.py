"""The port's blocked-flash attention and MoE FFN against the JAX
reference, on the same numpy inputs: ``layers.gqa_attend_flash`` (windows,
ragged edges padded at position -1, the balanced ``causal_skip``
schedule) at 3e-5, ``layers.moe_ffn`` (capacity drops included) and
``moe_aux_loss`` at 1e-5, the ``flash`` / ``flash_skip`` / ``auto``
backends through ``forward``, and the long prompt on the default route
that the port once refused (tiny llama3-8b, 1536 tokens: ``auto`` takes
its flash branch above 2^21 score elements) at 2e-4."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_tiny as j_tiny
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch.configs import get_tiny
from repro_torch.models import layers as TL
from repro_torch.models import model as TM

torch.set_num_threads(2)
FLASH_TOL = dict(rtol=3e-5, atol=3e-5)
MOE_TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=2e-4, atol=2e-4)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def _f(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _flash_pair(q, k, v, qp, kp, **kw):
    t = TL.gqa_attend_flash(*(torch.from_numpy(x) for x in (q, k, v, qp,
                                                             kp)), **kw)
    j = JL.gqa_attend_flash(*(jnp.asarray(x) for x in (q, k, v, qp, kp)),
                            **kw)
    return t, j


@pytest.mark.parametrize("window", [0, 24])
@pytest.mark.parametrize("Tq,Tk,bq,bk", [
    (64, 64, 16, 16),       # whole blocks
    (50, 70, 16, 32),       # both edges padded
    (37, 37, 64, 64),       # one block, clamped to T
])
def test_flash_matches_reference(window, Tq, Tk, bq, bk):
    """Scattered query positions over a key range with dead slots (-1),
    G 2."""
    rng = np.random.default_rng(Tq * Tk + window)
    B, H, Hkv, D = 2, 4, 2, 16
    q, k, v = _f(rng, B, Tq, H, D), _f(rng, B, Tk, Hkv, D), \
        _f(rng, B, Tk, Hkv, D)
    kp = np.tile(np.arange(Tk, dtype=np.int32), (B, 1))
    kp[1, -5:] = -1
    qp = np.sort(rng.integers(0, Tk, (B, Tq)), axis=1).astype(np.int32)
    qp[0, :3] = -1
    t, j = _flash_pair(q, k, v, qp, kp, window=window, block_q=bq,
                       block_k=bk)
    assert tuple(t.shape) == (B, Tq, H, D)
    np.testing.assert_allclose(_np(t), _np(j), **FLASH_TOL)
    # the fully masked rows give zeros, not NaN
    assert float(t[0, :3].abs().sum()) == 0.0


@pytest.mark.parametrize("window", [0, 24])
@pytest.mark.parametrize("T,bq,bk", [(96, 32, 16), (90, 16, 32)])
def test_flash_causal_skip_matches_reference(window, T, bq, bk):
    """Row-major positions (a full causal prefill): the skip schedule
    equals the reference's, and the full schedule."""
    rng = np.random.default_rng(T + window)
    B, H, Hkv, D = 1, 6, 2, 32
    q, k, v = _f(rng, B, T, H, D), _f(rng, B, T, Hkv, D), \
        _f(rng, B, T, Hkv, D)
    pos = np.arange(T, dtype=np.int32)[None]
    t, j = _flash_pair(q, k, v, pos, pos, window=window, block_q=bq,
                       block_k=bk, causal_skip=True)
    np.testing.assert_allclose(_np(t), _np(j), **FLASH_TOL)
    full, _ = _flash_pair(q, k, v, pos, pos, window=window, block_q=bq,
                          block_k=bk)
    np.testing.assert_allclose(_np(t), _np(full), **FLASH_TOL)


def test_flash_equals_dense_oracle():
    rng = np.random.default_rng(5)
    B, T, H, Hkv, D = 2, 40, 4, 1, 16
    q, k, v = _f(rng, B, T, H, D), _f(rng, B, T, Hkv, D), \
        _f(rng, B, T, Hkv, D)
    pos = torch.arange(T, dtype=torch.int32).expand(B, T)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    out = TL.gqa_attend_flash(tq, tk, tv, pos, pos, 16, block_q=8,
                              block_k=16)
    dense = TL.gqa_attend_dense(tq, tk, tv,
                                TL.position_mask(pos, pos, 16))[0]
    torch.testing.assert_close(out, dense, **FLASH_TOL)


# ---------------- MoE ---------------------------------------------------------
def _moe_inputs(rng, T, d, E, F):
    x = _f(rng, 2, T // 2, d)
    router = _f(rng, d, E)
    wi = _f(rng, E, d, 2, F) / np.sqrt(d)
    wo = _f(rng, E, F, d) / np.sqrt(F)
    return x, router, wi, wo


@pytest.mark.parametrize("T,k,cf,group", [
    (24, 2, 1.25, 512),     # one group, no drop
    (600, 2, 1.25, 512),    # 600 tokens: two groups of 300
    (96, 2, 0.5, 32),       # capacity 8 per expert and group: drops
    (64, 3, 1.0, 64),       # k 3, E 6
])
def test_moe_ffn_matches_reference(T, k, cf, group):
    rng = np.random.default_rng(T + k)
    d, E, F = 16, 6 if k == 3 else 4, 24
    x, router, wi, wo = _moe_inputs(rng, T, d, E, F)
    kw = dict(experts_per_token=k, capacity_factor=cf, group_size=group)
    t_out, t_probs = TL.moe_ffn(*(torch.from_numpy(a) for a in
                                  (x, router, wi, wo)), **kw)
    j_out, j_probs = JL.moe_ffn(*(jnp.asarray(a) for a in
                                  (x, router, wi, wo)), **kw)
    assert tuple(t_out.shape) == x.shape
    np.testing.assert_allclose(_np(t_out), _np(j_out), **MOE_TOL)
    np.testing.assert_allclose(_np(t_probs), _np(j_probs), **MOE_TOL)
    np.testing.assert_allclose(
        float(TL.moe_aux_loss(t_probs, E)),
        float(JL.moe_aux_loss(j_probs, E)), **MOE_TOL)
    if cf < 1:
        # the case's premise: some token lost an expert to the capacity,
        # which the output shows as a different mix than without a limit
        free, _ = TL.moe_ffn(*(torch.from_numpy(a) for a in
                               (x, router, wi, wo)), experts_per_token=k,
                             capacity_factor=8.0, group_size=group)
        assert not torch.allclose(free, t_out, **MOE_TOL)


def test_moe_ties_take_the_lower_expert():
    """A zero token has uniform router probabilities: its top-k are the
    lowest expert ids, as ``jax.lax.top_k`` picks them."""
    rng = np.random.default_rng(1)
    d, E, F = 8, 4, 8
    x, router, wi, wo = _moe_inputs(rng, 8, d, E, F)
    x[0, :3] = 0.0
    kw = dict(experts_per_token=2, capacity_factor=0.5, group_size=8)
    t_out, _ = TL.moe_ffn(*(torch.from_numpy(a) for a in
                            (x, router, wi, wo)), **kw)
    j_out, _ = JL.moe_ffn(*(jnp.asarray(a) for a in (x, router, wi, wo)),
                          **kw)
    np.testing.assert_allclose(_np(t_out), _np(j_out), **MOE_TOL)


# ---------------- backends through the model --------------------------------
@pytest.fixture(scope="module")
def llama():
    cfg, jcfg = get_tiny("llama3-8b"), j_tiny("llama3-8b")
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = TM.params_from_jax(cfg, jax.tree.map(np.asarray, jparams),
                                 "cpu")
    return cfg, jcfg, tparams, jparams


@pytest.mark.parametrize("impl", ["flash", "flash_skip"])
def test_flash_backends_match_reference(llama, impl):
    """Small prompts: ``flash`` (one block) and ``flash_skip`` run their
    loops; ``collect_stats`` takes the dense oracle, as the reference."""
    cfg, jcfg, tp, jp = llama
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size,
                                             (2, 40)).astype(np.int32)
    t = TM.prefill(cfg, tp, torch.from_numpy(toks), attn_impl=impl)
    j = JM.prefill(jcfg, jp, jnp.asarray(toks), attn_impl=impl)
    np.testing.assert_allclose(_np(t.logits), _np(j.logits), **MODEL_TOL)
    cid = np.zeros_like(toks)
    ts = TM.prefill(cfg, tp, torch.from_numpy(toks), attn_impl=impl,
                    chunk_ids=torch.from_numpy(cid), collect_stats=True)
    assert ts.stats is not None and float(ts.stats.sum()) > 0


def test_long_prompt_on_the_default_route(llama):
    """1536 tokens: 1536^2 > 2^21 score elements, so ``auto`` (the
    default) takes the blocked-flash branch, which the reference takes."""
    cfg, jcfg, tp, jp = llama
    T = 1536
    assert T * T > (1 << 21)
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size,
                                             (1, T)).astype(np.int32)
    t = TM.prefill(cfg, tp, torch.from_numpy(toks))
    j = JM.prefill(jcfg, jp, jnp.asarray(toks))
    np.testing.assert_allclose(_np(t.logits), _np(j.logits), **MODEL_TOL)
    for tg, jg in zip(t.cache["groups"], j.cache["groups"]):
        np.testing.assert_allclose(_np(tg["k"]), _np(jg["k"]), **MODEL_TOL)
