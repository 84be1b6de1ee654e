"""The port's Mamba2 model vs the JAX model on tiny mamba2-370m, through
``params_from_jax`` (non-zero norms, ``dt_bias`` and ``D`` so every
parameter matters): ``forward(mode="train")`` logits, ``prefill`` logits
and its ``s`` / ``conv`` cache, ``decode_step`` after a prefill, and the
three serving step roots of ``training/steps.py``, at 2e-4. Inside the
port, decode equals an extended prefill at 3e-4 (the reference's own
property, ``tests/test_equivalence.py``). On the CPU the ``ssd_intra``
wrapper runs its plain version and never counts a launch."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_tiny as j_tiny
from repro.models import model as JM
from repro.training import steps as JS
from repro_torch.configs import get_config, get_tiny
from repro_torch.kernels.ssd import ops as sops
from repro_torch.models import model as TM
from repro_torch.training import steps as TS

torch.set_num_threads(2)
TOL = dict(rtol=2e-4, atol=2e-4)
ARCH = "mamba2-370m"


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(_np(a), _np(b), **tol)


def _close_cache(tc, jc):
    for tg, jg in zip(tc["groups"], jc["groups"]):
        assert set(tg) == set(jg) == {"s", "conv"}
        for n in jg:
            assert tuple(tg[n].shape) == jg[n].shape
            _close(tg[n], jg[n])


@pytest.fixture(autouse=True)
def _zero_counts():
    sops.ssd_intra.launches = 0
    yield
    assert sops.ssd_intra.launches == 0


@pytest.fixture(scope="module")
def world():
    cfg, jcfg = get_tiny(ARCH), j_tiny(ARCH)
    assert (cfg.num_layers, cfg.d_model, cfg.d_inner, cfg.ssm_heads,
            cfg.ssm_state) == (jcfg.num_layers, jcfg.d_model, jcfg.d_inner,
                               jcfg.ssm_heads, jcfg.ssm_state)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    np_params = jax.tree.map(np.asarray, jparams)
    g = np_params["groups"][0]
    for n in ("ln1", "out_norm", "dt_bias"):
        g[n] = (rng.normal(size=g[n].shape) * 0.1).astype(np.float32)
    g["D"] = rng.uniform(0.5, 1.5, size=g["D"].shape).astype(np.float32)
    np_params["final_norm"] = (rng.normal(size=np_params["final_norm"]
                                          .shape) * 0.1).astype(np.float32)
    jparams = jax.tree.map(jnp.asarray, np_params)
    tparams = TM.params_from_jax(cfg, np_params, "cpu")
    return cfg, jcfg, tparams, jparams


def _tokens(cfg, B=2, T=21, seed=2):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)


def test_params_layout_and_init(world):
    cfg, _jcfg, tp, jp = world
    for n, x in jp["groups"][0].items():
        assert tuple(tp["groups"][0][n].shape) == x.shape
    a = TM.init_params(cfg, torch.Generator().manual_seed(3))
    for n, x in tp["groups"][0].items():
        assert a["groups"][0][n].shape == x.shape
    A_log = a["groups"][0]["A_log"]           # log U(1, 8)
    assert float(A_log.min()) >= 0.0 and float(A_log.max()) <= np.log(8.0)
    assert float(A_log.std()) > 0.1
    assert torch.equal(a["groups"][0]["D"], torch.ones_like(A_log))
    assert float(a["groups"][0]["dt_bias"].abs().sum()) == 0.0


def test_full_config_param_count():
    """Full mamba2-370m within 30% of its label, as tests/test_archs.py
    checks the reference."""
    cfg = get_config(ARCH)
    assert (cfg.num_layers, cfg.d_model, cfg.d_inner, cfg.ssm_heads,
            cfg.ssm_head_dim, cfg.ssm_state, cfg.padded_vocab) == \
        (48, 1024, 2048, 32, 64, 128, 50432)
    assert cfg.is_attention_free and not cfg.supports_chunk_cache
    assert abs(cfg.param_count() - 0.37e9) / 0.37e9 < 0.30


def test_train_forward(world):
    cfg, jcfg, tp, jp = world
    toks = _tokens(cfg)
    t = TM.forward(cfg, tp, tokens=torch.from_numpy(toks), mode="train")
    j = JM.forward(jcfg, jp, tokens=jnp.asarray(toks), mode="train")
    assert t.cache is None
    _close(t.logits, j.logits)


# (21, 128): one chunk of 21; (48, 16): three chunks of 16 through the
# inter-chunk recurrence. Long chunks are left out on purpose: the chunked
# algorithm forms exp(cum_i - cum_j) from prefix sums that reach ~-200 over
# 75 steps of the tiny model's decay, so the two packages' fp32 cumsums
# (each ~1e-6 relative from a float64 recurrence) differ by ~1e-3 in the
# logits after 4 layers: the reference's conditioning, not a port fault.
@pytest.mark.parametrize("T,chunk", [(21, 128), (48, 16)])
def test_prefill_logits_and_cache(world, T, chunk):
    cfg, jcfg, tp, jp = world
    cfg, jcfg = cfg.replace(ssd_chunk=chunk), jcfg.replace(ssd_chunk=chunk)
    toks = _tokens(cfg, T=T)
    t = TM.prefill(cfg, tp, torch.from_numpy(toks))
    j = JM.prefill(jcfg, jp, tokens=jnp.asarray(toks))
    _close(t.logits, j.logits)
    _close_cache(t.cache, j.cache)


def test_decode_after_prefill(world):
    cfg, jcfg, tp, jp = world
    toks = _tokens(cfg, T=19, seed=5)
    nxt = np.array([5, 9], np.int32)
    pos = np.array([19, 19], np.int32)
    pre_t = TM.prefill(cfg, tp, torch.from_numpy(toks))
    pre_j = JM.prefill(jcfg, jp, tokens=jnp.asarray(toks))
    t = TM.decode_step(cfg, tp, torch.from_numpy(nxt), torch.from_numpy(pos),
                       pre_t.cache)
    j = JM.decode_step(jcfg, jp, jnp.asarray(nxt), jnp.asarray(pos),
                       pre_j.cache)
    _close(t.logits, j.logits)
    _close_cache(t.cache, j.cache)


def test_decode_matches_extended_prefill(world):
    """Inside the port: prefill S tokens, then decode steps, equal one
    prefill of the extended sequence at the same positions."""
    cfg, _jcfg, tp, _jp = world
    B, S, n = 2, 23, 4
    toks = torch.from_numpy(_tokens(cfg, B=B, T=S + n, seed=7))
    full = TM.prefill(cfg, tp, toks)
    pre = TM.prefill(cfg, tp, toks[:, :S])
    cache = pre.cache
    for i in range(n):
        pos = torch.full((B,), S + i, dtype=torch.int32)
        dec = TM.decode_step(cfg, tp, toks[:, S + i], pos, cache)
        cache = dec.cache
        _close(dec.logits[:, 0], full.logits[:, S + i],
               dict(rtol=3e-4, atol=3e-4))


def test_step_roots_vs_reference(world):
    """make_prefill_step, make_cachecraft_prefill_step (partial: carries
    the prefill's state) and make_decode_step against the reference's."""
    cfg, jcfg, tp, jp = world
    toks = _tokens(cfg, T=24, seed=9)
    B = toks.shape[0]
    tc = TM.init_cache(cfg, B, 24, device="cpu")
    jc = JM.init_cache(jcfg, B, 24)
    tl, tc = TS.make_prefill_step(cfg)(
        tp, {"tokens": torch.from_numpy(toks[:, :16]), "cache": tc})
    jl, jc = JS.make_prefill_step(jcfg)(
        jp, {"tokens": jnp.asarray(toks[:, :16]), "cache": jc})
    assert tuple(tl.shape) == (B, 1, cfg.padded_vocab)
    _close(tl, jl)
    _close_cache(tc, jc)

    pos = np.broadcast_to(np.arange(16, 22, dtype=np.int32), (B, 6)).copy()
    tl, tc = TS.make_cachecraft_prefill_step(cfg)(
        tp, {"tokens": torch.from_numpy(toks[:, 16:22]),
             "positions": torch.from_numpy(pos), "cache": tc})
    jl, jc = JS.make_cachecraft_prefill_step(jcfg)(
        jp, {"tokens": jnp.asarray(toks[:, 16:22]),
             "positions": jnp.asarray(pos), "cache": jc})
    _close(tl, jl)
    _close_cache(tc, jc)

    dpos = np.full((B,), 22, np.int32)
    tl, tc = TS.make_decode_step(cfg)(
        tp, {"tokens": torch.from_numpy(toks[:, 22]),
             "positions": torch.from_numpy(dpos), "cache": tc})
    jl, jc = JS.make_decode_step(jcfg)(
        jp, {"tokens": jnp.asarray(toks[:, 22]),
             "positions": jnp.asarray(dpos), "cache": jc})
    _close(tl, jl)
    _close_cache(tc, jc)
