"""The families this slice ports, port against the JAX package on the
same numpy-seeded inputs through ``params_from_jax``: gemma3's
sliding-window ``local`` layers (ring and full caches), the MoE FFN
(granite-moe, phi3.5-moe), musicgen's ``embeds`` input and the dense
configs copied with them (llama3.2-3b, deepseek-7b/67b).

For every new tiny config: the train-mode forward (logits and the MoE
aux loss), prefill into a ring and a full-length cache, a partial
prefill over a cache holding an injected chunk, and decode steps, at
2e-4, with the port's ``dense`` and ``kernel`` backends (the kernels'
plain versions on the CPU) held against the reference's ``dense``. The
prompts (80 tokens) are longer than tiny gemma3's 64-token window, so
the window masks keys and the ring wraps. Then one granite train step
against the reference's (``test_torch_training.py``'s tolerances), and
tiny gemma3 and
granite through ``build_engine`` on the default and ``kernel`` routes
against the JAX engine: the same tokens and plans, decode logits at
2e-4."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_tiny as j_tiny
from repro.core.chunkstore import ChunkStore as JStore
from repro.core.tiers import TieredStore as JTiers
from repro.models import model as JM
from repro.serving.api import EngineSpec as JSpec
from repro.serving.api import build_engine as j_build
from repro.serving.rag import KnowledgeBase as JKB
from repro.serving.scheduler import SchedulerConfig as JSched
from repro.serving.workload import WorkloadConfig as JWL
from repro.serving.workload import generate as j_generate
from repro.training import steps as JS
from repro.training.optimizer import AdamWConfig as JAdamW
from repro_torch.configs import get_tiny
from repro_torch.core.chunkstore import ChunkStore
from repro_torch.core.tiers import TieredStore
from repro_torch.models import model as TM
from repro_torch.serving.api import EngineSpec, build_engine
from repro_torch.serving.rag import KnowledgeBase
from repro_torch.serving.request import State
from repro_torch.serving.scheduler import SchedulerConfig
from repro_torch.serving.workload import WorkloadConfig, generate
from repro_torch.training import steps as TS
from repro_torch.training.data import DataConfig, SyntheticLM
from repro_torch.training.optimizer import AdamWConfig, tree_leaves

torch.set_num_threads(2)
TOL = dict(rtol=2e-4, atol=2e-4)
NEW_ARCHS = ("gemma3-4b", "granite-moe-1b-a400m", "phi3.5-moe-42b-a6.6b",
             "llama3.2-3b", "deepseek-7b", "deepseek-67b", "musicgen-medium")
T, CACHE = 80, 96            # prompt and cache length (tiny window 64)
IMPLS = ("dense", "kernel")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def _close(a, b, what=""):
    np.testing.assert_allclose(_np(a), _np(b), **TOL, err_msg=what)


def _leaves(cache):
    return [(i, n, c[n]) for i, c in enumerate(cache["groups"] +
                                               cache["tail"])
            for n in sorted(c)]


def _close_cache(tc, jc):
    for (i, n, t), (_i, _n, j) in zip(_leaves(tc), _leaves(jc),
                                      strict=True):
        assert tuple(t.shape) == j.shape, (i, n)
        if n == "pos":
            np.testing.assert_array_equal(_np(t), _np(j), err_msg=str(i))
        else:
            _close(t, j, f"cache {i} {n}")


@pytest.fixture(scope="module", params=NEW_ARCHS)
def world(request):
    """cfg pair and params (norm weights made non-zero so the 1 + w scale
    is exercised), and the inputs of every mode."""
    cfg, jcfg = get_tiny(request.param), j_tiny(request.param)
    np_params = jax.tree.map(np.asarray, JM.init_params(
        jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    for layer in np_params["groups"] + np_params["tail"]:
        for n in ("ln1", "ln2"):
            layer[n] = (rng.normal(size=layer[n].shape) * 0.1).astype(
                np.float32)
    tparams = TM.params_from_jax(cfg, np_params, "cpu")
    jparams = jax.tree.map(jnp.asarray, np_params)
    toks = rng.integers(0, cfg.vocab_size, (2, T)).astype(np.int32)
    # chunk ids of the cache's keys (16-slot chunks)
    cid = (np.arange(CACHE) // 16).astype(np.int32)[None].repeat(2, 0)
    return cfg, jcfg, tparams, jparams, toks, cid


def _embeds(cfg, toks):
    """musicgen's input: frame embeddings from a stub frontend (here a
    fixed random projection of the tokens)."""
    rng = np.random.default_rng(9)
    return (rng.normal(size=(cfg.vocab_size, cfg.d_model)) * 0.02).astype(
        np.float32)[toks]


def _inputs(cfg, toks, conv):
    if cfg.input_mode == "embeds":
        return {"embeds": conv(_embeds(cfg, toks))}
    return {"tokens": conv(toks)}


def test_tiny_config_matches_reference(world):
    cfg, jcfg, *_ = world
    assert cfg.name == jcfg.name
    for f in ("num_layers", "d_model", "num_heads", "num_kv_heads",
              "head_dim_", "d_ff", "vocab_size", "pattern", "window",
              "num_experts", "experts_per_token", "capacity_factor",
              "rope_theta", "input_mode", "layer_kinds"):
        assert getattr(cfg, f) == getattr(jcfg, f), f


def test_train_forward(world):
    cfg, jcfg, tp, jp, toks, _cid = world
    t = TM.forward(cfg, tp, mode="train",
                   **_inputs(cfg, toks, torch.from_numpy))
    j = JM.forward(jcfg, jp, mode="train", **_inputs(cfg, toks, jnp.asarray))
    _close(t.logits, j.logits)
    np.testing.assert_allclose(float(t.aux_loss), float(j.aux_loss),
                               **TOL)
    assert (float(t.aux_loss) > 0) == bool(cfg.num_experts)


def _stats_kw(world, ring, conv):
    """The chunk-mass statistic over a full-length cache's keys. A ring
    prefill attends over the prompt's keys in ``local`` layers and over
    the cache's in global ones, so it collects none."""
    return {} if ring else dict(chunk_ids=conv(world[5]),
                                collect_stats=True)


DECODE_STEPS = 3
NEXT = np.array([3, 7], np.int32)


@pytest.fixture(scope="module")
def ref_prefill(world):
    """The reference's dense prefill into ring and full caches, and from
    each the logits of DECODE_STEPS decode steps fed NEXT, then the
    greedy tokens (one jitted step)."""
    cfg, jcfg, _tp, jp, toks, _cid = world
    def one(p, t, pos, c):
        d = JM.decode_step(jcfg, p, t, pos, c, attn_impl="dense")
        return d.logits, d.cache

    step = jax.jit(one)
    out = {}
    for ring in (True, False):
        pre = JM.prefill(jcfg, jp, attn_impl="dense", cache_len=CACHE,
                         ring=ring, **_inputs(cfg, toks, jnp.asarray),
                         **_stats_kw(world, ring, jnp.asarray))
        cache, nxt, logits = pre.cache, NEXT, []
        for s in range(DECODE_STEPS):
            lg, cache = step(jp, jnp.asarray(nxt),
                             jnp.full(2, T + s, jnp.int32), cache)
            logits.append(np.asarray(lg))
            nxt = np.array(lg[:, 0].argmax(-1), np.int32)
        out[ring] = (pre, logits, cache)
    return out


def _port_prefill(world, impl, ring):
    cfg, _jcfg, tp, _jp, toks, _cid = world
    return TM.prefill(cfg, tp, attn_impl=impl, cache_len=CACHE, ring=ring,
                      **_inputs(cfg, toks, torch.from_numpy),
                      **_stats_kw(world, ring, torch.from_numpy))


@pytest.mark.parametrize("ring", [True, False])
@pytest.mark.parametrize("impl", IMPLS)
def test_prefill(world, ref_prefill, impl, ring):
    cfg = world[0]
    t, j = _port_prefill(world, impl, ring), ref_prefill[ring][0]
    _close(t.logits, j.logits)
    _close_cache(t.cache, j.cache)
    if not ring:
        _close(t.stats, j.stats)
    if ring and "local" in cfg.layer_kinds:
        assert t.cache["groups"][0]["k"].shape[2] == cfg.window < CACHE


@pytest.mark.parametrize("ring", [True, False])
@pytest.mark.parametrize("impl", IMPLS)
def test_decode_steps(world, ref_prefill, impl, ring):
    """Decode steps after the prefill, fed NEXT and then the reference's
    greedy tokens (the ring of a ``local`` layer wraps: slot pos % 64)."""
    cfg, _jcfg, tp, _jp, _toks, _cid = world
    tc = _port_prefill(world, impl, ring).cache
    _pre, ref_logits, ref_cache = ref_prefill[ring]
    nxt = NEXT
    for s, lg in enumerate(ref_logits):
        pos = torch.full((2,), T + s, dtype=torch.int32)
        t = TM.decode_step(cfg, tp, torch.from_numpy(nxt), pos, tc,
                           attn_impl=impl)
        _close(t.logits, lg, f"step {s}")
        tc = t.cache
        nxt = lg[:, 0].argmax(-1).astype(np.int32)
    _close_cache(tc, ref_cache)


def _inject(cache, k_np, v_np, start, to):
    """Write a chunk's KV (per cache leaf [..., B, n, Hkv, D]) into slots
    [start, start + n) of every layer, as the executor's inject does."""
    leaves = cache["groups"] + cache["tail"]
    G = len(cache["groups"])
    out = []
    for li, c in enumerate(leaves):
        c = dict(c)
        for name, src in (("k", k_np), ("v", v_np)):
            x = np.array(_np(c[name]))
            x[..., start:start + src[li].shape[-3], :, :] = src[li]
            c[name] = to(x)
        out.append(c)
    return {"groups": out[:G], "tail": out[G:]}


@pytest.mark.parametrize("impl", IMPLS)
def test_partial_with_injected_chunk(world, ref_prefill, impl):
    """A full-length cache from the prefill, slots 40..55 overwritten by
    a chunk's KV computed elsewhere, then a partial pass over recompute
    rows (inside and outside the chunk), 6 new tokens and 3 padding rows,
    with explicit write slots and segment ids."""
    cfg, jcfg, tp, jp, _toks, _cid = world
    rng = np.random.default_rng(11)
    pre = ref_prefill[False][0]
    leaves = pre.cache["groups"] + pre.cache["tail"]
    kv = [[rng.normal(size=c["k"].shape[:-3] + (16,) + c["k"].shape[-2:])
           .astype(np.float32) for c in leaves] for _ in range(2)]
    tc = _inject(_port_prefill(world, "dense", False).cache, *kv, 40,
                 torch.from_numpy)
    jc = _inject(pre.cache, *kv, 40, jnp.asarray)
    act = np.concatenate([[3, 44, 50, 70], np.arange(T, T + 6),
                          [-1, -1, -1]]).astype(np.int32)
    pos = np.stack([act, act])
    tok = rng.integers(0, cfg.vocab_size, pos.shape).astype(np.int32)
    seg = np.where(pos >= 0, 0, -1).astype(np.int32)
    kv_seg = np.zeros((2, CACHE), np.int32)
    kv_seg[:, T + 6:] = -1
    cid = world[5]
    kw = dict(mode="partial", collect_stats=True)
    t = TM.forward(cfg, tp, **_inputs(cfg, tok, torch.from_numpy),
                   positions=torch.from_numpy(pos), cache=tc,
                   chunk_ids=torch.from_numpy(cid), attn_impl=impl,
                   slots=torch.from_numpy(pos),
                   seg_ids=torch.from_numpy(seg),
                   kv_seg=torch.from_numpy(kv_seg), **kw)
    j = JM.forward(jcfg, jp, **_inputs(cfg, tok, jnp.asarray),
                   positions=jnp.asarray(pos), cache=jc,
                   chunk_ids=jnp.asarray(cid), attn_impl="dense",
                   slots=jnp.asarray(pos), seg_ids=jnp.asarray(seg),
                   kv_seg=jnp.asarray(kv_seg), **kw)
    live = act >= 0
    _close(t.logits[:, live], j.logits[:, live])
    _close_cache(t.cache, j.cache)
    _close(t.stats[:, :, live], j.stats[:, :, live])


# ---------------- one granite train step ------------------------------------
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
LOSS_RTOL = 1e-5
OPT = dict(peak_lr=1e-3, warmup_steps=2, total_steps=20)


def test_granite_train_step_matches_reference():
    """The MoE aux term in the loss, its gradients (through the router's
    softmax and the renormalised gates) and one AdamW step with 2
    microbatches, against the reference's jitted train step."""
    arch = "granite-moe-1b-a400m"
    cfg, jcfg = get_tiny(arch), j_tiny(arch)
    data = SyntheticLM(DataConfig(seq_len=64, global_batch=4,
                                  vocab_size=cfg.vocab_size))
    tree = jax.tree.map(np.asarray, JS.state_to_tree(
        JS.init_train_state(jcfg, jax.random.PRNGKey(0))))
    batch = data.batch(0)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    state = TS.state_from_jax(cfg, tree, "cpu")
    loss, aux = TS.loss_fn(cfg, state.params, tb)
    grads = torch.autograd.grad(loss, list(tree_leaves(state.params)))
    jparams = jax.tree.map(jnp.asarray, tree["params"])
    (jloss, jaux), jgrads = jax.value_and_grad(
        lambda p: JS.loss_fn(jcfg, p, jb), has_aux=True)(jparams)
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(aux["aux"].detach()),
                               float(jaux["aux"]), rtol=LOSS_RTOL)
    assert float(aux["aux"].detach()) > 0
    for i, (g, r) in enumerate(zip(grads, jax.tree.leaves(jgrads),
                                   strict=True)):
        np.testing.assert_allclose(_np(g), _np(r), **GRAD_TOL,
                                   err_msg=f"grad {i}")
    # one step, 2 microbatches
    step = TS.make_train_step(cfg, AdamWConfig(**OPT), accum=2)
    state, m = step(TS.state_from_jax(cfg, tree, "cpu"), tb)
    jstate, jm = jax.jit(JS.make_train_step(jcfg, JAdamW(**OPT), accum=2))(
        JS.tree_to_state(jax.tree.map(jnp.asarray, tree)), jb)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=LOSS_RTOL)
    # the step's averaged gradients, through the first moment m = 0.1 g at
    # the gradients' tolerance scaled by 0.1 (the parameters themselves
    # move by lr * sign(g) on AdamW's first step, so an element whose
    # gradient is rounding noise may step the other way)
    ref = jax.tree.map(np.asarray, JS.state_to_tree(jstate))
    for i, (a, b) in enumerate(zip(tree_leaves(state.opt["m"]),
                                   jax.tree.leaves(ref["opt"]["m"]),
                                   strict=True)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=GRAD_TOL["rtol"],
                                   atol=0.1 * GRAD_TOL["atol"],
                                   err_msg=f"m {i}")


# ---------------- the engine -------------------------------------------------
N_REQ, MAX_NEW = 8, 4


def _wl(mod_wl):
    # prompts of 8 + 3 chunks of 24-48 + 12 tokens: 92-164, past the
    # 64-token window
    return mod_wl(num_requests=N_REQ, qpm=1e9, seed=3, k_chunks=3,
                  max_new_tokens=MAX_NEW)


@pytest.fixture(scope="module", params=["gemma3-4b", "granite-moe-1b-a400m"])
def engine_world(request, tmp_path_factory):
    """Port params and the JAX engine's (``dense``) run of the trace."""
    cfg, jcfg = get_tiny(request.param), j_tiny(request.param)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = TM.params_from_jax(cfg, jax.tree.map(np.asarray, jparams),
                                 "cpu")
    d = tmp_path_factory.mktemp("jstore")
    store = JStore(JTiers(1 << 28, 1 << 28, str(d), start_worker=False),
                   50, 4)
    eng = j_build(JSpec(use_focus=False, pool_blocks=512, attn_impl="dense",
                        sched=JSched(max_decode_batch=4),
                        trace_decode=True),
                  cfg=jcfg, params=jparams, store=store)
    reqs = j_generate(JKB(num_chunks=10, vocab_size=jcfg.vocab_size,
                          seed=0), _wl(JWL))
    stats = eng.run(reqs)
    return cfg, tparams, (eng, stats, reqs)


@pytest.mark.parametrize("impl", [None, "kernel"])
def test_engine_matches_jax(engine_world, tmp_path, impl):
    """The default route (``attn_impl`` unset) and ``kernel``: the same
    plans (hits, computed tokens), output tokens and per-step decode
    logits as the JAX engine."""
    cfg, tparams, (eng_j, stats_j, reqs_j) = engine_world
    store = ChunkStore(TieredStore(1 << 28, 1 << 28, str(tmp_path),
                                   start_worker=False), 50, 4)
    eng = build_engine(EngineSpec(use_focus=False, pool_blocks=512,
                                  device="cpu", attn_impl=impl,
                                  sched=SchedulerConfig(max_decode_batch=4),
                                  trace_decode=True),
                       cfg=cfg, params=tparams, store=store)
    reqs = generate(KnowledgeBase(num_chunks=10, vocab_size=cfg.vocab_size,
                                  seed=0), _wl(WorkloadConfig))
    stats = eng.run(reqs)
    assert stats.completed == stats_j.completed == N_REQ
    assert stats.failed == stats_j.failed == 0
    assert stats.prefill_tokens_total == stats_j.prefill_tokens_total
    assert stats.prefill_tokens_computed == stats_j.prefill_tokens_computed
    assert stats.prefill_tokens_computed < stats.prefill_tokens_total
    for rt, rj in zip(reqs, reqs_j, strict=True):
        assert rt.state == State.DONE and rj.state.name == "DONE"
        assert rt.prefill_tokens_total > get_tiny("gemma3-4b").window
        assert rt.cache_hits == rj.cache_hits
        assert rt.prefill_tokens_computed == rj.prefill_tokens_computed
        assert rt.output_tokens == rj.output_tokens
    assert len(eng.decode_trace) == len(eng_j.decode_trace) > 0
    for step, (tt, tj) in enumerate(zip(eng.decode_trace,
                                        eng_j.decode_trace)):
        assert set(tt) == set(tj), f"step {step}"
        for rid in tt:
            np.testing.assert_allclose(tt[rid], np.asarray(tj[rid]), **TOL,
                                       err_msg=f"step {step}, rid {rid}")
