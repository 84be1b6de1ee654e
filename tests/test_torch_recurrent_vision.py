"""The last two layer families of the reference's registry in the port,
against the JAX package on the same numpy-seeded inputs through
``params_from_jax``: recurrentgemma-9b's RG-LRU recurrence (``rglru``
layers beside sliding-window ``local`` ones) and llama-3.2-vision-90b's
gated cross-attention (``xattn`` layers over precomputed media
embeddings). The reference's engine serves neither family, so both are
held through the model roots (``forward``, ``prefill``,
``partial_prefill``, ``decode_step``) and the train step.

- ``rglru_scan`` at 1e-5 for S in {1, 7, 64, 257}, with and without a
  carried state, fp32 and bf16 inputs; ``rglru_step`` chained S times
  equals the scan.
- Four tiny configs: recurrentgemma (2 groups, no tail), recurrentgemma
  at 8 layers (a tail of two ``rglru`` layers), vision, and vision with
  2048 media tokens at 1040 tokens, past 2^21 score elements, where the
  cross-attention takes its blocked-flash branch. The gates of every
  ``xattn`` layer are set nonzero in the numpy params before either
  package loads them: at init they are zero, and the layer is then the
  identity (held by ``test_zero_gates_make_xattn_the_identity``). On
  each config: train-mode logits; prefill logits and every cache leaf on
  the port's ``dense`` / ``kernel`` / ``auto`` / ``flash`` against the
  reference's ``dense``; 8 decode steps; ``partial_prefill`` continuing
  from a cache (RG-LRU state carried, conv window restarted, media
  projected again); all at 2e-4. Decode after a prefill equals the
  prefill extended by that token (3e-4, the reference's own bound in
  ``tests/test_equivalence.py``), and the gradients of the training loss
  equal ``jax.grad``'s at ``tests/test_torch_training.py``'s tolerance.
- The registry: ``ARCHS`` equal to the reference's, the full configs'
  layer kinds, and ``core/select.py`` against the reference's."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import get_config as j_config
from repro.configs import get_tiny as j_tiny
from repro.core.select import select_recompute_tokens as j_select
from repro.models import layers as JL
from repro.models import model as JM
from repro.training import steps as JS
from repro_torch.configs import ARCHS, get_config, get_tiny
from repro_torch.core.select import select_recompute_tokens
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.training import steps as TS
from repro_torch.training.optimizer import tree_leaves

torch.set_num_threads(2)
TOL = dict(rtol=2e-4, atol=2e-4)
SCAN_TOL = dict(rtol=1e-5, atol=1e-5)
EXT_TOL = dict(rtol=3e-4, atol=3e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
IMPLS = ("dense", "kernel", "auto", "flash")
DECODE_STEPS = 8
NEXT = np.array([3, 7], np.int32)
# name -> (arch, overrides of the tiny config, batch, prompt tokens)
VARIANTS = {
    "recurrentgemma": ("recurrentgemma-9b", {}, 2, 80),
    "recurrentgemma-tail": ("recurrentgemma-9b", dict(num_layers=8), 2, 80),
    "vision": ("llama-3.2-vision-90b", {}, 2, 80),
    "vision-flash": ("llama-3.2-vision-90b", dict(num_media_tokens=2048), 1,
                     1040),
}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def _close(a, b, what="", tol=TOL):
    np.testing.assert_allclose(_np(a), _np(b), **tol, err_msg=what)


def _leaves(cache):
    return [(i, n, c[n]) for i, c in enumerate(cache["groups"] +
                                               cache["tail"])
            for n in sorted(c)]


def _close_cache(tc, jc):
    for (i, n, t), (_i, _n, j) in zip(_leaves(tc), _leaves(jc),
                                      strict=True):
        assert (i, n) == (_i, _n) and tuple(t.shape) == j.shape, (i, n)
        if n == "pos":
            np.testing.assert_array_equal(_np(t), _np(j), err_msg=str(i))
        else:
            _close(t, j, f"cache {i} {n}")


# ---------------- rglru_scan / rglru_step ------------------------------------
R = 24


def _scan_inputs(S, dtype, with_h0, seed=0):
    """b [2, S, R] in ``dtype``; lam from the init's distribution, alpha
    and beta around 1, h0 fp32 (or None), all as numpy."""
    rng = np.random.default_rng(seed + S)
    b = rng.normal(size=(2, S, R)).astype(np.float32)
    if dtype == "bfloat16":
        b = _np(torch.from_numpy(b).to(torch.bfloat16))   # bf16-exact
    u = rng.uniform(0.35, 0.65, R)
    lam = np.log(np.expm1(-np.log(u) / 8.0)).astype(np.float32)
    alpha, beta = (1 + 0.3 * rng.normal(size=(2, R))).astype(np.float32)
    h0 = rng.normal(size=(2, R)).astype(np.float32) if with_h0 else None
    return b, lam, alpha, beta, h0


def _port_scan(b, lam, alpha, beta, h0, dtype):
    t = torch.from_numpy
    return TL.rglru_scan(t(b).to(getattr(torch, dtype)), t(lam), t(alpha),
                         t(beta), None if h0 is None else t(h0))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("S", [1, 7, 64, 257])
def test_rglru_scan_matches_reference(S, with_h0, dtype):
    """y in the input's dtype and the last state in fp32, both computed in
    fp32: the state within 1e-5; y too in fp32, and in bf16 within one
    bf16 step (both round the same fp32 values, which may straddle a
    rounding boundary)."""
    b, lam, alpha, beta, h0 = _scan_inputs(S, dtype, with_h0)
    ty, th = _port_scan(b, lam, alpha, beta, h0, dtype)
    jy, jh = JL.rglru_scan(jnp.asarray(b, dtype), jnp.asarray(lam),
                           jnp.asarray(alpha), jnp.asarray(beta),
                           None if h0 is None else jnp.asarray(h0))
    assert ty.dtype == getattr(torch, dtype) and th.dtype == torch.float32
    assert tuple(ty.shape) == (2, S, R) and tuple(th.shape) == (2, R)
    _close(th, jh, "h_last", SCAN_TOL)
    _close(ty, jy, "y", SCAN_TOL if dtype == "float32"
           else dict(rtol=2.0 ** -7, atol=1e-6))


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("S", [7, 64])
def test_rglru_step_chain_equals_scan(S, with_h0):
    b, lam, alpha, beta, h0 = _scan_inputs(S, "float32", with_h0, seed=1)
    ty, th = _port_scan(b, lam, alpha, beta, h0, "float32")
    t = torch.from_numpy
    h = torch.zeros((2, R)) if h0 is None else t(h0)
    ys = []
    for s in range(S):
        y, h = TL.rglru_step(t(b[:, s]), t(lam), t(alpha), t(beta), h)
        ys.append(y)
    _close(torch.stack(ys, 1), ty, "y", SCAN_TOL)
    _close(h, th, "h", SCAN_TOL)


# ---------------- the two families through the model roots -------------------
def _gates(np_params, rng):
    """Nonzero tanh gates on every xattn layer (the init's are zero)."""
    for layer in np_params["groups"] + np_params["tail"]:
        for n in ("gate_attn", "gate_ffn"):
            if n in layer:
                layer[n] = ((0.5 + rng.uniform(size=layer[n].shape))
                            * rng.choice([-1, 1], layer[n].shape)).astype(
                                np.float32)


@pytest.fixture(scope="module", params=list(VARIANTS))
def world(request):
    """cfg pair, params (norm weights and xattn gates made nonzero) in
    both packages, prompt tokens and media."""
    arch, over, B, T = VARIANTS[request.param]
    cfg, jcfg = get_tiny(arch).replace(**over), j_tiny(arch).replace(**over)
    np_params = jax.tree.map(np.asarray, JM.init_params(
        jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    for layer in np_params["groups"] + np_params["tail"]:
        for n in ("ln1", "ln2"):
            layer[n] = (rng.normal(size=layer[n].shape) * 0.1).astype(
                np.float32)
    _gates(np_params, rng)
    tparams = TM.params_from_jax(cfg, np_params, "cpu")
    jparams = jax.tree.map(jnp.asarray, np_params)
    toks = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    media = (rng.normal(size=(B, cfg.num_media_tokens, cfg.d_model))
             .astype(np.float32) if cfg.num_media_tokens else None)
    return dict(name=request.param, cfg=cfg, jcfg=jcfg, tp=tparams,
                jp=jparams, toks=toks, media=media, B=B, T=T)


def _kw(w, conv, media=True):
    return {} if w["media"] is None or not media else \
        {"media": conv(w["media"])}


def test_variant_premises(world):
    """What each variant is there to reach."""
    cfg, jcfg, name = world["cfg"], world["jcfg"], world["name"]
    assert cfg.layer_kinds == jcfg.layer_kinds
    tail = cfg.layer_kinds[cfg.n_groups * len(cfg.pattern):]
    if name.startswith("recurrentgemma"):
        assert world["T"] > cfg.window          # the window masks pairs
        assert tail == (("rglru", "rglru") if name.endswith("tail")
                        else ())
    else:
        big = world["T"] * cfg.num_media_tokens > (1 << 21)
        assert big == name.endswith("flash")
    for leaf in world["tp"]["groups"] + world["tp"]["tail"]:
        for n in ("gate_attn", "gate_ffn"):
            if n in leaf:
                assert bool((leaf[n].abs() > 0.4).all())


def test_train_forward(world):
    w = world
    t = TM.forward(w["cfg"], w["tp"], tokens=torch.from_numpy(w["toks"]),
                   mode="train", **_kw(w, torch.from_numpy))
    j = JM.forward(w["jcfg"], w["jp"], tokens=jnp.asarray(w["toks"]),
                   mode="train", **_kw(w, jnp.asarray))
    _close(t.logits, j.logits)


@pytest.fixture(scope="module")
def ref_prefill(world):
    """The reference's dense prefill (ring caches, T + 8 slots), and from
    it the logits of DECODE_STEPS decode steps fed NEXT and then the
    greedy tokens (one jitted step), and the final cache."""
    w = world
    jcfg, jp, B = w["jcfg"], w["jp"], w["B"]

    def one(p, t, pos, c):
        d = JM.decode_step(jcfg, p, t, pos, c, attn_impl="dense")
        return d.logits, d.cache

    step = jax.jit(one)
    pre = JM.prefill(jcfg, jp, tokens=jnp.asarray(w["toks"]),
                     attn_impl="dense", cache_len=w["T"] + DECODE_STEPS,
                     **_kw(w, jnp.asarray))
    cache, nxt, logits = pre.cache, NEXT[:B], []
    for s in range(DECODE_STEPS):
        lg, cache = step(jp, jnp.asarray(nxt),
                         jnp.full(B, w["T"] + s, jnp.int32), cache)
        logits.append(np.asarray(lg))
        nxt = np.array(lg[:, 0].argmax(-1), np.int32)
    return pre, logits, cache


def _port_prefill(w, impl, **kw):
    return TM.prefill(w["cfg"], w["tp"], tokens=torch.from_numpy(w["toks"]),
                      attn_impl=impl, cache_len=w["T"] + DECODE_STEPS,
                      **_kw(w, torch.from_numpy), **kw)


@pytest.mark.parametrize("impl", IMPLS)
def test_prefill(world, ref_prefill, impl):
    """Logits and every cache leaf: ``h`` and ``conv`` of rglru layers,
    the ring's ``k`` / ``v`` / ``pos`` of local ones, ``mk`` / ``mv`` of
    xattn ones."""
    t, j = _port_prefill(world, impl), ref_prefill[0]
    _close(t.logits, j.logits)
    _close_cache(t.cache, j.cache)
    names = {n for _i, n, _x in _leaves(t.cache)}
    want = {"h", "conv", "k", "v", "pos"} if \
        world["name"].startswith("recurrentgemma") else \
        {"k", "v", "pos", "mk", "mv"}
    assert names == want


@pytest.mark.parametrize("impl", IMPLS)
def test_decode_steps(world, ref_prefill, impl):
    """DECODE_STEPS steps after the prefill, fed NEXT and then the
    reference's greedy tokens (recurrentgemma's local rings wrap, vision's
    xattn layers read the media's K and V from the cache)."""
    w = world
    tc = _port_prefill(w, impl).cache
    _pre, ref_logits, ref_cache = ref_prefill
    nxt = NEXT[:w["B"]]
    for s, lg in enumerate(ref_logits):
        pos = torch.full((w["B"],), w["T"] + s, dtype=torch.int32)
        t = TM.decode_step(w["cfg"], w["tp"], torch.from_numpy(nxt), pos, tc,
                           attn_impl=impl)
        _close(t.logits, lg, f"step {s}")
        tc = t.cache
        nxt = lg[:, 0].argmax(-1).astype(np.int32)
    _close_cache(tc, ref_cache)


@pytest.mark.parametrize("impl", IMPLS)
def test_partial_continues_cache(world, impl):
    """A prefill of all but the last 12 tokens into full-length caches,
    then ``partial_prefill`` of those 12 at their positions (the media
    given again): the RG-LRU state carries over and the conv window
    restarts from zeros, in both packages."""
    w = world
    cfg, jcfg, T = w["cfg"], w["jcfg"], w["T"]
    T0 = T - 12
    pos = np.broadcast_to(np.arange(T0, T, dtype=np.int32), (w["B"], 12))
    kw = dict(cache_len=T + DECODE_STEPS, ring=False)
    tc = TM.prefill(cfg, w["tp"], tokens=torch.from_numpy(w["toks"][:, :T0]),
                    attn_impl=impl, **kw, **_kw(w, torch.from_numpy)).cache
    jc = JM.prefill(jcfg, w["jp"], tokens=jnp.asarray(w["toks"][:, :T0]),
                    attn_impl="dense", **kw, **_kw(w, jnp.asarray)).cache
    t = TM.partial_prefill(cfg, w["tp"], torch.from_numpy(w["toks"][:, T0:]),
                           torch.from_numpy(pos.copy()), tc,
                           attn_impl=impl, **_kw(w, torch.from_numpy))
    j = JM.partial_prefill(jcfg, w["jp"], jnp.asarray(w["toks"][:, T0:]),
                           jnp.asarray(pos), jc, attn_impl="dense",
                           **_kw(w, jnp.asarray))
    _close(t.logits, j.logits)
    _close_cache(t.cache, j.cache)


@pytest.mark.parametrize("impl", IMPLS)
def test_decode_matches_extended_prefill(world, impl):
    """Decode of one token after a prefill of T equals the last position
    of a prefill of T + 1, on the port alone."""
    w = world
    cfg, B, T = w["cfg"], w["B"], w["T"]
    toks = torch.from_numpy(w["toks"])
    nxt = torch.from_numpy(NEXT[:B])
    full = TM.prefill(cfg, w["tp"], tokens=torch.cat([toks, nxt[:, None]], 1),
                      attn_impl=impl, **_kw(w, torch.from_numpy))
    pre = _port_prefill(w, impl)
    dec = TM.decode_step(cfg, w["tp"], nxt,
                         torch.full((B,), T, dtype=torch.int32), pre.cache,
                         attn_impl=impl)
    _close(dec.logits[:, 0], full.logits[:, -1], tol=EXT_TOL)


def test_train_grads_match_jax(world):
    """Gradients of the training loss (tokens, labels, media) against
    ``jax.grad`` of the reference's, leaf by leaf in ``jax.tree.leaves``
    order, the scan's backward included."""
    w = world
    rng = np.random.default_rng(4)
    batch = {"tokens": w["toks"],
             "labels": rng.integers(0, w["cfg"].vocab_size,
                                    w["toks"].shape).astype(np.int32)}
    if w["media"] is not None:
        batch["media"] = w["media"]
    tparams = TM.params_from_jax(w["cfg"], jax.tree.map(np.asarray, w["jp"]),
                                 "cpu")
    leaves = list(tree_leaves(tparams))
    for x in leaves:
        x.requires_grad_(True)
    loss, _ = TS.loss_fn(w["cfg"], tparams,
                         {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves)
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: JS.loss_fn(w["jcfg"], p, {k: jnp.asarray(v)
                                           for k, v in batch.items()}),
        has_aux=True)(w["jp"])
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    jl = jax.tree.leaves(jgrads)
    assert len(jl) == len(grads)
    for i, (g, r) in enumerate(zip(grads, jl, strict=True)):
        assert tuple(g.shape) == r.shape, i
        np.testing.assert_allclose(_np(g), _np(r), **GRAD_TOL,
                                   err_msg=f"grad {i} {r.shape}")


@pytest.mark.parametrize("arch", ["recurrentgemma-9b",
                                  "llama-3.2-vision-90b"])
def test_train_step_takes_both_families(arch):
    """One AdamW step with 2 microbatches (media split with the tokens),
    as the reference's ``test_arch_train_step_smoke``: the step counts,
    the loss is finite and the gradient nonzero. Every rglru leaf moves;
    the xattn gates move too, from zero, though at zero they keep the
    gradient from the layer's own weights."""
    from repro_torch.training.optimizer import AdamWConfig
    cfg = get_tiny(arch)
    state = TS.init_train_state(cfg, torch.Generator().manual_seed(1))
    layers = state.params["groups"] + state.params["tail"]
    before = [{n: x.detach().clone() for n, x in g.items()} for g in layers]
    rng = np.random.default_rng(2)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 32)),
             "labels": rng.integers(0, cfg.vocab_size, (2, 32))}
    if cfg.num_media_tokens:
        batch["media"] = rng.normal(
            size=(2, cfg.num_media_tokens, cfg.d_model)).astype(np.float32)
    step = TS.make_train_step(cfg, AdamWConfig(warmup_steps=2,
                                               total_steps=10), accum=2)
    state, m = step(state, {k: torch.from_numpy(v) for k, v in
                            batch.items()})
    assert int(state.step) == 1
    assert np.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0
    for kind, g, g0 in zip(cfg.pattern, layers, before):
        names = {"rglru": list(g), "xattn": ["gate_attn", "gate_ffn"]}.get(
            kind, [])
        for n in names:
            assert bool((g[n].detach() != g0[n]).all()), (kind, n)


def test_zero_gates_make_xattn_the_identity():
    """At init (gates 0) the cross-attention layer adds nothing: media
    and zeroed media give the same logits, exactly, in both packages;
    with the gates nonzero they do not."""
    arch = "llama-3.2-vision-90b"
    cfg, jcfg = get_tiny(arch), j_tiny(arch)
    np_params = jax.tree.map(np.asarray, JM.init_params(
        jcfg, jax.random.PRNGKey(3)))
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (1, 24)).astype(np.int32)
    media = rng.normal(size=(1, cfg.num_media_tokens, cfg.d_model)).astype(
        np.float32)
    zero = np.zeros_like(media)
    gated = jax.tree.map(np.copy, np_params)
    _gates(gated, rng)
    for params, same in ((np_params, True), (gated, False)):
        tp = TM.params_from_jax(cfg, params, "cpu")
        jp = jax.tree.map(jnp.asarray, params)
        t = [_np(TM.forward(cfg, tp, tokens=torch.from_numpy(toks),
                            media=torch.from_numpy(m)).logits)
             for m in (media, zero)]
        j = [_np(JM.forward(jcfg, jp, tokens=jnp.asarray(toks),
                            media=jnp.asarray(m)).logits)
             for m in (media, zero)]
        for a, b in (t, j):
            if same:
                np.testing.assert_array_equal(a, b)
            else:
                assert np.abs(a - b).max() > TOL["atol"]
        _close(t[0], j[0])


# ---------------- the registry and core/select -------------------------------
def test_archs_equal_reference():
    assert ARCHS == J_ARCHS


@pytest.mark.parametrize("arch", ["recurrentgemma-9b",
                                  "llama-3.2-vision-90b"])
def test_full_config_layer_kinds(arch):
    """The full configs as the reference's (``tests/test_archs.py``:
    recurrentgemma's 26 rglru and 12 local layers, its tail of two
    rglru; vision's xattn every 5th of 100 layers)."""
    cfg, jcfg = get_config(arch), j_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    kinds = cfg.layer_kinds
    if arch == "recurrentgemma-9b":
        assert kinds.count("rglru") == 26 and kinds.count("local") == 12
        assert kinds[cfg.n_groups * len(cfg.pattern):] == ("rglru", "rglru")
    else:
        assert kinds.count("xattn") == 20 and kinds.count("attn") == 80
        assert cfg.n_tail == 0 and cfg.num_media_tokens == 1600


@pytest.mark.parametrize("strategy", ["cachecraft", "random", "h2o", "none",
                                      "all", "prefix"])
def test_select_recompute_tokens_matches_reference(strategy):
    """The deprecated shim over the strategy registry, copied: the same
    indices from the same scores, fractions and generator seeds."""
    rng = np.random.default_rng(6)
    for n in (1, 16, 57):
        inter = rng.uniform(size=n).astype(np.float32)
        total = inter + rng.uniform(size=n).astype(np.float32)
        for cfo in (0.0, 0.1, 0.37, 1.0):
            got = select_recompute_tokens(
                inter, cfo, strategy, rng=np.random.default_rng(n),
                token_total=total)
            want = j_select(inter, cfo, strategy,
                            rng=np.random.default_rng(n), token_total=total)
            np.testing.assert_array_equal(got, want)
    if strategy == "random":
        np.testing.assert_array_equal(
            select_recompute_tokens(inter, 0.5, "random",
                                    seeded_default=True),
            j_select(inter, 0.5, "random", seeded_default=True))


# ---------------- chip_smoke.py's phase 11, rehearsed on the CPU -------------
def test_chip_smoke_recurrent_vision_rehearsal(monkeypatch):
    """``chip_smoke.run_recurrent_vision`` end to end on the CPU at tiny
    size: the configs patched to their tiny ones (vision with 2048 media
    tokens, so its 1040-token prompt takes the blocked-flash branch),
    recurrentgemma's prompt cut to 160 tokens (past its 64-key window),
    the timers stubbed, and the chunk and decode wrappers routed through
    their launch hooks onto the plain versions, so that the phase's
    launch counts, recorders and checks run as on the card."""
    import os

    import repro_torch.configs as C
    from repro_torch.kernels.chunk_attention import ops as cops
    from repro_torch.kernels.chunk_attention.ref import chunk_attention_ref
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref

    monkeypatch.syspath_prepend(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke as cs

    def tiny(name):
        cfg = C.get_tiny(name)
        return cfg.replace(num_media_tokens=2048) if cfg.num_media_tokens \
            else cfg

    def chunk_launch(q, k, v, q_pos, k_pos, k_chunk, q_seg, k_seg, C_,
                     window):
        outs = [chunk_attention_ref(q[b], k[b], v[b], q_pos[b], k_pos[b],
                                    k_chunk[b], num_chunks=C_, window=window,
                                    q_seg=q_seg[b], k_seg=k_seg[b])
                for b in range(q.shape[0])]
        cops.chunk_attention.launches += 1
        return (torch.stack([o for o, _ in outs]),
                torch.stack([m for _, m in outs]))

    def chunk_attention(q, k, v, q_pos, k_pos, k_chunk, *, q_seg=None,
                        k_seg=None, num_chunks=16, window=0):
        return cops._launch(q, k, v, q_pos, k_pos, k_chunk,
                            torch.zeros_like(q_pos) if q_seg is None
                            else q_seg,
                            torch.zeros_like(k_pos) if k_seg is None
                            else k_seg, num_chunks, window)

    def decode_attention(q, k, v, q_pos, k_pos, *, window=0):
        B, H, D = q.shape
        out = dops._call("decode_attention", "decode_attention_fwd",
                         (q, k, v, q_pos, k_pos),
                         (B, k.shape[1], H, k.shape[2], D, int(window)), q, 1)
        decode_attention.launches += 1
        return out

    chunk_attention.launches = decode_attention.launches = 0
    monkeypatch.setattr(C, "get_config", tiny)
    monkeypatch.setattr(cs, "RG_TOKENS", 160)
    monkeypatch.setattr(cs, "VISION_TOKENS", (64, 1040))
    monkeypatch.setattr(cs, "cuda_ms", lambda fn, iters=20, warmup=3:
                        (fn(), 1.0)[1])
    monkeypatch.setattr(cs, "device_ms", lambda fn, iters=20, warmup=3,
                        windows=3: (fn(), 1.0)[1])
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(cops, "_launch", chunk_launch)
    monkeypatch.setattr(cops, "chunk_attention", chunk_attention)
    monkeypatch.setattr(dops, "_call", lambda what, entry, ptrs, ints, q, n:
                        decode_attention_ref(*ptrs, window=ints[-1]))
    monkeypatch.setattr(dops, "decode_attention", decode_attention)
    with torch.no_grad():
        out = cs.run_recurrent_vision(torch.device("cpu"))
    rg, vis = out["recurrentgemma-9b"], out["llama-3.2-vision-90b/5"]
    assert rg["launches"] == {"chunk_attention": 2, "decode_attention": 16}
    assert vis["launches"] == {"chunk_attention": 8, "decode_attention": 64}
    assert rg["extended"] <= cs.LOGIT_TOL and rg["ring"] <= cs.RING_TOL
    for T in (64, 1040):
        assert vis[T]["zeroed_prefill"] > cs.LOGIT_TOL
        assert vis[T]["decode"]["kernel"] <= cs.LOGIT_TOL
    for r in (rg, vis):
        assert set(r["path"]) == {"chunk_attention", "decode_attention"}
        for k in r["path"].values():
            assert k["float32"]["err"] <= cs.TOL["float32"]
