"""The port's consumers of the sharding rules against the reference's:
``param_axes``, whole tensors laid out on a mesh (``sharding.shard`` /
``unshard`` / ``shard_bytes``), ``collectives.reduce_scatter`` and its
byte counters, the data-parallel ZeRO-1 train step
(``make_train_step(..., grad_specs=...)``), the elastic
``checkpoint.restore(shardings=...)``, ``launch/roofline.py`` and the
meta-device dry-run ``launch/dryrun.py``.

Inputs come from numpy seeds. The reference's sharded jit, its HLO
analysis and its memory analysis run once, in a subprocess with 8 forced
host devices (as ``tests/test_distributed.py`` runs them); the port's
meshes list the CPU once per shard (the dry-run's, the meta device).

Tolerances: the sharded step computes the unsharded step's function with
the cross-shard sums in another order, so it is held at the training
tests' ``LOSS_RTOL`` (1e-5) and ``PARAM_TOL`` (rtol 2e-4, atol 1e-4,
the reference's own accumulation tolerance, ``tests/test_training.py``)
over 3 free-running steps; layouts and byte counts are exact; the
port's FLOP count is held within 5% of the reference's HLO count (the
ratios print under ``pytest -s``).
"""
import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import ARCHS as J_ARCHS
from repro.configs import get_config as j_config
from repro.configs import get_tiny as j_tiny
from repro.distributed import sharding as JSH
from repro.launch import roofline as JRL
from repro.models import model as JM
from repro.models.config import SHAPES as J_SHAPES
from repro.training import steps as JS
from repro_torch.configs import ARCHS, get_config, get_tiny
from repro_torch.distributed import collectives as CO
from repro_torch.distributed import sharding as SH
from repro_torch.kernels.chunk_attention import ops as cops
from repro_torch.kernels.decode_attention import ops as dops
from repro_torch.kernels.rope import ops as rops
from repro_torch.kernels.ssd import ops as sops
from repro_torch.launch import dryrun as DR
from repro_torch.launch import roofline as RL
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import model as TM
from repro_torch.models.config import SHAPES
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import steps as TS
from repro_torch.training.optimizer import (AdamWConfig, adamw_update,
                                            tree_leaves, tree_unflatten)
# AdamW's sign-flip allowance, and the MoE dispatch recorder (a fixture)
from test_torch_tp_training import assert_params_or_flips
from test_torch_tp_training import moe_dispatch  # noqa: F401

torch.set_num_threads(2)
CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL = 1e-5
PARAM_TOL = dict(rtol=2e-4, atol=1e-4)
OPT = dict(peak_lr=1e-3, warmup_steps=2, total_steps=20)
B, S = 8, 32            # 3 steps of 8 sequences: dp 4 x accum 2 divide B
FLOP_RTOL = 0.05
# the reference test's config (tests/test_distributed.py:55)
MESH_CFG = dict(num_heads=4, num_kv_heads=4)


class _FakeMesh:
    def __init__(self, **shape):
        self.axis_names = tuple(shape)
        self.shape = dict(shape)


def _spec(p):
    un = (SH.P.UNCONSTRAINED, JP.UNCONSTRAINED)
    return tuple("UNC" if any(e is u for u in un) else e for e in p)


def _batches(cfg, n=3, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (n, B, S + 1)).astype(np.int32)
    return [{"tokens": t[:, :-1].copy(), "labels": t[:, 1:].copy()}
            for t in toks]


def _tb(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _np_leaves(tree):
    return [x.detach().float().cpu().numpy() for x in tree_leaves(tree)]


def _assert_params(got, want):
    for i, (g, w) in enumerate(zip(got, want, strict=True)):
        np.testing.assert_allclose(g, w, **PARAM_TOL, err_msg=f"leaf {i}")


# ---------------- param_axes and its specs -----------------------------------
@pytest.mark.parametrize("arch", J_ARCHS + ("llama3-8b",))
def test_param_axes_and_specs_match_reference(arch):
    """The same logical-axes tuple for every leaf, tiny and full, and the
    same PartitionSpec for every leaf under ``make_rules`` on the
    production (16, 16) layout."""
    for tf, jf in ((get_tiny, j_tiny), (get_config, j_config)):
        assert TM.param_axes(tf(arch)) == JM.param_axes(jf(arch))
    mesh = _FakeMesh(data=16, model=16)
    cfg, jcfg = get_config(arch), j_config(arch)
    with SH.axis_rules(SH.make_rules(mesh, cfg)), \
            JSH.axis_rules(JSH.make_rules(mesh, jcfg)):
        tt = SH.spec_tree(TM.param_axes(cfg))
        jt = JSH.spec_tree(JM.param_axes(jcfg))
    flat_t = jax.tree.leaves(tt, is_leaf=lambda v: isinstance(v, SH.P))
    flat_j = jax.tree.leaves(jt, is_leaf=lambda v: isinstance(v, JP))
    assert len(flat_t) == len(flat_j) > 0
    assert [_spec(a) for a in flat_t] == [_spec(b) for b in flat_j]


def test_param_shapes_on_meta_match_init():
    """``init_params(..., device="meta")`` gives every leaf's shape and
    dtype and no data, as the generator's own device does."""
    cfg = get_tiny("llama3-8b")
    gen = torch.Generator().manual_seed(0)
    meta = TM.init_params(cfg, gen, device="meta")
    real = TM.init_params(cfg, torch.Generator().manual_seed(0))
    for m, r in zip(tree_leaves(meta), tree_leaves(real), strict=True):
        assert m.device.type == "meta"
        assert m.shape == r.shape and m.dtype == r.dtype


# ---------------- layouts and collectives ------------------------------------
def test_shard_unshard_round_trip_and_bytes():
    """A dimension split over (data, model) is cut in that order, uneven
    dims into ceil blocks (the last short), a replicated tensor is the
    tensor itself at every position on its device, and ``shard_bytes`` is
    the padded block GSPMD allocates."""
    mesh = make_debug_mesh((2, 4), device="cpu")
    x = torch.arange(8 * 10 * 3, dtype=torch.float32).reshape(8, 10, 3)
    for spec in (SH.P("data", "model"), SH.P(("data", "model")),
                 SH.P(None, "model"), SH.P(), SH.P(None, None, "data")):
        st = SH.shard(x, SH.NamedSharding(mesh, spec))
        assert st.shards.shape == (2, 4)
        assert torch.equal(SH.unshard(st), x)
    st = SH.shard(x, SH.NamedSharding(mesh, SH.P(("data", "model"))))
    assert torch.equal(st.shards[1, 2], x[6:7])          # block 1 * 4 + 2
    st = SH.shard(x, SH.NamedSharding(mesh, SH.P(None, "model")))
    assert st.shards[0, 3].shape == (8, 1, 3)            # 10 = 3+3+3+1
    assert SH.shard_bytes(x.shape, x.dtype, st.sharding) == 8 * 3 * 3 * 4
    rep = SH.shard(x, SH.NamedSharding(mesh, SH.P()))
    assert all(s is x for s in rep.shards.flat)
    assert SH.unshard(rep) is x
    split = SH.shard(x, SH.NamedSharding(mesh, SH.P("data")))
    assert split.shards[0, 0] is split.shards[0, 3]      # one copy a device
    assert split.shards[0, 0].data_ptr() != x.data_ptr()
    assert SH.data_dim(SH.P(None, ("data", "model")), ("data",)) == 1
    assert SH.data_dim(SH.P("model"), ("pod", "data")) is None


def test_reduce_scatter_psum_order_and_byte_counts():
    """``reduce_scatter`` is ``psum`` in shard order, then shard s keeps
    block s; a list part with a None dim keeps the whole sum (an
    all-reduce); the counters hold each call's per-device output bytes."""
    rng = np.random.default_rng(3)
    parts = [torch.from_numpy(rng.normal(size=(8, 8)).astype(np.float32))
             for _ in range(4)]
    want = parts[0] + parts[1] + parts[2] + parts[3]
    CO.reset_bytes()
    blocks = CO.reduce_scatter([p.clone() for p in parts], 0)
    assert torch.equal(torch.cat(blocks), want)
    assert CO.BYTES == {"all-gather": 0, "all-reduce": 0,
                        "reduce-scatter": 2 * 8 * 4}
    out = CO.reduce_scatter(([p.clone(), p[:, :1].clone()] for p in parts),
                            [1, None])
    assert torch.equal(torch.cat([o[0] for o in out], 1), want)
    assert all(torch.equal(o[1], want[:, :1]) for o in out)
    assert torch.equal(CO.all_gather([o[0] for o in out], 1), want)
    assert CO.BYTES == {"all-gather": 8 * 8 * 4, "all-reduce": 8 * 4,
                        "reduce-scatter": 2 * (2 * 8 * 4)}
    assert torch.equal(CO.psum(p for p in parts), want)
    CO.reset_bytes()
    assert set(CO.BYTES.values()) == {0}


# ---------------- the sharded train step --------------------------------------
def _state(cfg, seed=0):
    return TS.init_train_state(cfg, torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("dp", [2, 4])
@pytest.mark.parametrize("arch", ["llama3-8b", "mamba2-370m"])
def test_sharded_step_matches_unsharded(arch, dp, accum):
    """3 steps data-parallel over a (dp, 1) mesh == 3 unsharded steps
    from the same init: losses at LOSS_RTOL, params at PARAM_TOL; each
    shard holds exactly 1/dp of the fp32 grad accumulators and of ``m``
    and ``v`` for the leaves ZeRO-1 splits; the counted collective bytes
    equal the dry-run's closed form. Two layer groups: at dp 4 mamba2's
    per-head leaves ([2, 8]) split no dimension over the data axis, so
    the all-reduced (replicated) route runs too."""
    cfg = get_tiny(arch).replace(num_layers=2)
    opt = AdamWConfig(**OPT)
    mesh = make_debug_mesh((dp, 1), device="cpu")
    shs = TS.train_shardings(cfg, mesh)
    ref, step = _state(cfg), TS.make_train_step(cfg, opt, accum=accum)
    sst = TS.shard_state(_state(cfg), shs)
    sstep = TS.make_train_step(cfg, opt, accum=accum,
                               grad_specs=shs["opt"]["m"])
    want = DR.zero1_collective_bytes(cfg, mesh, accum)
    CO.reset_bytes()
    for i, b in enumerate(_batches(cfg)):
        ref, m_ref = step(ref, _tb(b))
        if i == 0:      # count_step reads the same counters, for one step
            out = []
            counts = RL.count_step(lambda *a: out.append(sstep(*a)), sst,
                                   _tb(b))
            assert counts.coll_bytes == want and counts.flops > 0
            sst, m_sh = out[0]
        else:
            sst, m_sh = sstep(sst, _tb(b))
        np.testing.assert_allclose(float(m_sh["loss"]), float(m_ref["loss"]),
                                   rtol=LOSS_RTOL)
        # the norm of ~1e6 fp32 grads, each shard's rows summed apart
        np.testing.assert_allclose(float(m_sh["grad_norm"]),
                                   float(m_ref["grad_norm"]), rtol=1e-4)
    assert CO.BYTES == {k: 3 * v for k, v in want.items()}
    un = TS.unshard_state(sst)
    _assert_params(_np_leaves(un.params), _np_leaves(ref.params))
    _assert_params(_np_leaves(un.opt["m"]), _np_leaves(ref.opt["m"]))
    assert int(un.step) == int(ref.step) == 3
    assert int(un.opt["count"]) == 3
    split, total, replicated = 0, 0, 0
    for x, g, mst in zip(tree_leaves(ref.params),
                         tree_leaves(shs["opt"]["m"]),
                         tree_leaves(sst.opt["m"])):
        full = x.numel() * 4
        per = SH.shard_bytes(x.shape, torch.float32, g)
        if SH.data_dim(g.spec, ("data",)) is None:
            replicated += 1
            assert per == full
            continue
        assert per * dp == full
        assert all(s.numel() * 4 == per for s in mst.shards.flat)
        split, total = split + per, total + full
    assert split * dp == total > 0
    assert (replicated > 0) == (arch == "mamba2-370m" and dp == 4)
    # the params' replicas on the one device are one tensor
    for st in tree_leaves(sst.params):
        assert len({id(s) for s in st.shards.flat}) == 1


def test_step_without_grad_specs_is_the_plain_step():
    """Without ``grad_specs`` the step is the plain accumulation loop,
    byte for byte: grads of each microbatch summed in fp32 in order,
    divided by ``accum``, then ``adamw_update``."""
    cfg = get_tiny("llama3-8b")
    opt = AdamWConfig(**OPT)
    st, step = _state(cfg), TS.make_train_step(cfg, opt, accum=2)
    mine = _state(cfg)
    for b in _batches(cfg, n=2):
        st, m = step(st, _tb(b))
        leaves = list(tree_leaves(mine.params))
        flat, lsum = None, 0.0
        for i in range(2):
            mb = {k: v.reshape(2, B // 2, S)[i] for k, v in _tb(b).items()}
            loss, _ = TS.loss_fn(cfg, mine.params, mb)
            g = torch.autograd.grad(loss, leaves)
            flat = [x.float() for x in g] if flat is None else \
                [a.add_(x.float()) for a, x in zip(flat, g)]
            lsum = lsum + loss.detach()
        _, mine.opt, _ = adamw_update(
            opt, tree_unflatten(mine.params, [g.div_(2) for g in flat]),
            mine.opt, mine.params)
        assert torch.equal(m["loss"], lsum / 2)
    for a, b in zip(tree_leaves(st.params), tree_leaves(mine.params)):
        assert torch.equal(a, b)


def test_embeds_config_trains_and_embedding_grad_is_zero():
    """musicgen feeds frame embeddings, so the token embedding gets no
    gradient: the step takes it as zero, as ``jax.grad`` gives, and the
    loss and every other grad match the reference's."""
    cfg, jcfg = get_tiny("musicgen-medium"), j_tiny("musicgen-medium")
    key = jax.random.PRNGKey(0)
    jparams = JM.init_params(jcfg, key)
    rng = np.random.default_rng(1)
    b = {"embeds": rng.normal(size=(2, 16, cfg.d_model)).astype(np.float32),
         "labels": rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)}
    (jl, _), jg = jax.value_and_grad(
        lambda p: JS.loss_fn(jcfg, p, {k: jax.numpy.asarray(v)
                                       for k, v in b.items()}),
        has_aux=True)(jparams)
    params = TM.params_from_jax(cfg, jax.tree.map(np.asarray, jparams), CPU)
    leaves = list(tree_leaves(params))
    for x in leaves:
        x.requires_grad_(True)
    loss, _ = TS.loss_fn(cfg, params, _tb(b))
    grads = TS._grads(loss, leaves)
    np.testing.assert_allclose(float(loss), float(jl), rtol=LOSS_RTOL)
    for g, r in zip(grads, jax.tree.leaves(jg), strict=True):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4,
                                   atol=1e-5)
    assert float(grads[0].abs().sum()) == 0          # "embed", sorted first
    state = TS.TrainState(step=torch.zeros((), dtype=torch.int32),
                          params=params,
                          opt=TS.adamw_init(params))
    TS.make_train_step(cfg, AdamWConfig(**OPT))(state, _tb(b))


# ---------------- elastic restore --------------------------------------------
def test_elastic_checkpoint_reshard(tmp_path):
    """Save on a (1, 8) layout, restore onto (2, 4): every shard equals
    its slice of the saved array byte for byte (tests/test_distributed.py
    :103's counterpart)."""
    m1 = make_debug_mesh((1, 8), device="cpu")
    x = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    ckpt.save({"x": SH.shard(x, SH.NamedSharding(m1, SH.P(None, "model")))},
              str(tmp_path), 1)
    m2 = make_debug_mesh((2, 4), device="cpu")
    sh = SH.NamedSharding(m2, SH.P("data", "model"))
    got = ckpt.restore(str(tmp_path), shardings={"x": sh})["x"]
    assert got.sharding == sh and got.shards.shape == (2, 4)
    for idx in np.ndindex(2, 4):
        assert torch.equal(got.shards[idx],
                           x[SH.shard_slices(x.shape, sh, idx)])
    with pytest.raises(ValueError):
        ckpt.restore(str(tmp_path), device=CPU, shardings={"x": sh})


def test_state_saved_at_dp4_continues_at_dp2(tmp_path):
    """2 steps at dp 4, save, restore onto dp 2 (each restored shard its
    slice byte for byte), a 3rd step there == a 3rd step at dp 4 within
    PARAM_TOL."""
    cfg = get_tiny("llama3-8b")
    opt = AdamWConfig(**OPT)
    m4 = make_debug_mesh((4, 1), device="cpu")
    m2 = make_debug_mesh((2, 1), device="cpu")
    sh4, sh2 = TS.train_shardings(cfg, m4), TS.train_shardings(cfg, m2)
    st = TS.shard_state(_state(cfg), sh4)
    step4 = TS.make_train_step(cfg, opt, accum=2, grad_specs=sh4["opt"]["m"])
    bs = _batches(cfg)
    for b in bs[:2]:
        st, _ = step4(st, _tb(b))
    ckpt.save(TS.state_to_tree(st), str(tmp_path), 2)
    saved = ckpt.restore(str(tmp_path))
    tree = ckpt.restore(str(tmp_path), shardings=sh2)
    for st_, arr in zip(tree_leaves(tree["opt"]["m"]),
                        tree_leaves(saved["opt"]["m"])):
        for idx in np.ndindex(st_.shards.shape):
            want = arr[SH.shard_slices(arr.shape, st_.sharding, idx)]
            assert np.array_equal(st_.shards[idx].numpy(), want)
    st2 = TS.sharded_state_from_tree(tree)
    step2 = TS.make_train_step(cfg, opt, accum=2, grad_specs=sh2["opt"]["m"])
    st2, m2_ = step2(st2, _tb(bs[2]))
    st, m4_ = step4(st, _tb(bs[2]))
    np.testing.assert_allclose(float(m2_["loss"]), float(m4_["loss"]),
                               rtol=LOSS_RTOL)
    _assert_params(_np_leaves(TS.unshard_state(st2).params),
                   _np_leaves(TS.unshard_state(st).params))


# ---------------- the reference, once, in a subprocess -----------------------
REF_CODE = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_tiny
from repro.distributed import sharding as SH
from repro.launch.mesh import make_debug_mesh, data_axes, dp_size
from repro.launch.roofline import analyze_hlo
from repro.models import model as M
from repro.training import checkpoint as ckpt
from repro.training import steps as JS
from repro.training.optimizer import AdamWConfig
assert len(jax.devices()) == 8
OUT = sys.argv[1]
res = {}


def sds(*shape, dt=jnp.int32):
    return jax.ShapeDtypeStruct(shape, dt)


def is_p(x):
    return isinstance(x, P)


def train_shardings(cfg, mesh, state):
    pspecs = SH.spec_tree(M.param_axes(cfg))
    pshard = jax.tree.map(lambda s: NamedSharding(mesh, s), pspecs,
                          is_leaf=is_p)
    def osh(spec, leaf):
        return NamedSharding(mesh, SH.zero1_spec(
            spec, leaf.shape, data_axes(mesh), dp_size(mesh)))
    zero1 = jax.tree.map(osh, pspecs, state.opt["m"], is_leaf=is_p)
    return pshard, zero1, JS.TrainState(
        step=NamedSharding(mesh, P()), params=pshard,
        opt={"m": zero1, "v": zero1, "count": NamedSharding(mesh, P())})

# 1. the sharded train step, 3 steps on a (DP, 1) mesh
cfg = get_tiny("llama3-8b")
mesh = make_debug_mesh((DP, 1))
batches = np.load(os.path.join(OUT, "batches.npz"))
opt = AdamWConfig(peak_lr=1e-3, warmup_steps=2, total_steps=20)
with mesh, SH.axis_rules(SH.make_rules(mesh, cfg)):
    state = JS.init_train_state(cfg, jax.random.PRNGKey(0))
    ckpt.save(jax.tree.map(np.asarray, JS.state_to_tree(state)), OUT, 0)
    _, grad_specs, sshard = train_shardings(cfg, mesh, state)
    state = jax.device_put(state, sshard)
    bsh = {k: NamedSharding(mesh, P("data")) for k in ("tokens", "labels")}
    step = jax.jit(JS.make_train_step(cfg, opt, accum=2,
                                      grad_specs=grad_specs),
                   in_shardings=(sshard, bsh))
    losses = []
    for i in range(3):
        b = jax.device_put({k: batches[f"{k}{i}"]
                            for k in ("tokens", "labels")}, bsh)
        # the outputs come back in layouts GSPMD chose: lay them out again
        state, m = step(jax.device_put(state, sshard), b)
        losses.append(float(m["loss"]))
    ckpt.save(jax.tree.map(np.asarray, JS.state_to_tree(state)), OUT, 3)
res["losses"] = losses

# 2. dot FLOPs of three single-device cells of tiny llama3-8b
cfg = get_tiny("llama3-8b")
key = jax.random.PRNGKey(0)
st = jax.eval_shape(lambda k: JS.init_train_state(cfg, k), key)
params = jax.eval_shape(lambda k: M.init_params(cfg, k), key)
fl = {}
txt = jax.jit(JS.make_train_step(cfg, AdamWConfig(), accum=2)).lower(
    st, {"tokens": sds(4, 64), "labels": sds(4, 64)}).compile().as_text()
fl["train"] = analyze_hlo(txt).flops
cache = jax.eval_shape(lambda: M.init_cache(cfg, 2, 64, dtype=jnp.float32,
                                            ring=True))
txt = jax.jit(JS.make_prefill_step(cfg, attn_impl="auto")).lower(
    params, {"tokens": sds(2, 64), "cache": cache}).compile().as_text()
fl["prefill"] = analyze_hlo(txt).flops
txt = jax.jit(JS.make_decode_step(cfg)).lower(
    params, {"tokens": sds(2), "positions": sds(2),
             "cache": cache}).compile().as_text()
fl["decode"] = analyze_hlo(txt).flops
res["flops"] = fl

# 3. per-device argument bytes of the 2x4 debug mesh's train (accum 2)
# and decode cells (the test_distributed.py config)
from repro.launch.dryrun import cache_shardings
mesh = make_debug_mesh((2, 4))
cfg = get_tiny("llama3-8b").replace(num_heads=4, num_kv_heads=4)
args = {}
with mesh, SH.axis_rules(SH.make_rules(mesh, cfg)):
    state = jax.eval_shape(lambda k: JS.init_train_state(cfg, k), key)
    pshard, _, sshard = train_shardings(cfg, mesh, state)
    batch = {"tokens": sds(4, 64), "labels": sds(4, 64)}
    bsh = {k: NamedSharding(mesh, P("data")) for k in batch}
    c = jax.jit(JS.make_train_step(cfg, AdamWConfig(), accum=2),
                in_shardings=(sshard, bsh)).lower(state, batch).compile()
    args["train"] = c.memory_analysis().argument_size_in_bytes
    params = jax.eval_shape(lambda k: M.init_params(cfg, k), key)
    cache = jax.eval_shape(lambda: M.init_cache(cfg, 8, 64,
                                                dtype=jnp.float32, ring=True))
    csh = cache_shardings(cfg, mesh, cache, 8, kind="decode")
    dsh = NamedSharding(mesh, P("data"))
    c = jax.jit(JS.make_decode_step(cfg), in_shardings=(pshard, {
        "tokens": dsh, "positions": dsh, "cache": csh})).lower(
        params, {"tokens": sds(8), "positions": sds(8),
                 "cache": cache}).compile()
    args["decode"] = c.memory_analysis().argument_size_in_bytes
res["argument_bytes"] = args

# 4. the sharded train step executed tensor-parallel: 3 steps of tiny
# llama3-8b on (data 2, model 4), of tiny granite-moe-1b on (data 2,
# model 2), capacity factor 0.5 (the 128-token GShard group spans both
# data shards, and tokens drop), and of tiny recurrentgemma-9b and
# mamba2-370m on (data 2, model 4), with the compiled step's collective
# bytes (analyze_hlo)
for tag, arch, shape, kw in TP_RUNS:
    cfg = get_tiny(arch).replace(**kw)
    mesh = make_debug_mesh(shape)
    out = os.path.join(OUT, tag)
    with mesh, SH.axis_rules(SH.make_rules(mesh, cfg)):
        state = JS.init_train_state(cfg, jax.random.PRNGKey(1))
        ckpt.save(jax.tree.map(np.asarray, JS.state_to_tree(state)), out, 0)
        _, grad_specs, sshard = train_shardings(cfg, mesh, state)
        state = jax.device_put(state, sshard)
        bsh = {k: NamedSharding(mesh, P("data")) for k in ("tokens", "labels")}
        step = jax.jit(JS.make_train_step(cfg, opt, accum=2,
                                          grad_specs=grad_specs),
                       in_shardings=(sshard, bsh))
        losses = []
        for i in range(3):
            b = jax.device_put({k: batches[f"{k}{i}"]
                                for k in ("tokens", "labels")}, bsh)
            if i == 0:
                # the compiled step's collective bytes per device
                res[tag + "_coll_bytes"] = analyze_hlo(step.lower(
                    state, b).compile().as_text()).coll_bytes
            state, m = step(jax.device_put(state, sshard), b)
            losses.append(float(m["loss"]))
        ckpt.save(jax.tree.map(np.asarray, JS.state_to_tree(state)), out, 3)
    res[tag] = losses
json.dump(res, open(os.path.join(OUT, "ref.json"), "w"))
print("REF_OK")
"""
REF_DP = 2
# (tag, arch, (data, model), config changes) of the tensor-parallel runs
TP_RUNS = (("tp_llama", "llama3-8b", (2, 4), dict(num_layers=2)),
           ("tp_granite", "granite-moe-1b-a400m", (2, 2),
            dict(num_layers=2, capacity_factor=0.5)),
           ("tp_rg", "recurrentgemma-9b", (2, 4), dict(num_layers=3)),
           ("tp_mamba2", "mamba2-370m", (2, 4), dict(num_layers=2)))


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("ref")
    cfg = get_tiny("llama3-8b")
    bs = _batches(cfg, seed=7)
    np.savez(out / "batches.npz", **{f"{k}{i}": b[k] for i, b in
                                      enumerate(bs) for k in b})
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(
        REF_CODE.replace("DP", str(REF_DP)).replace(
            "TP_RUNS", repr(TP_RUNS))), str(out)], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "REF_OK" in r.stdout
    res = json.loads((out / "ref.json").read_text())
    res.update(dir=str(out), batches=bs)
    return res


def test_sharded_step_matches_reference_jit(ref):
    """3 steps of the port's ZeRO-1 step on a (2, 1) mesh from the
    reference's init (``state_from_jax``) == the reference's step jitted
    with ZeRO-1 ``in_shardings`` and ``grad_specs`` on 2 forced host
    devices: each loss at LOSS_RTOL, the final params, ``m`` and ``v`` at
    PARAM_TOL."""
    cfg = get_tiny("llama3-8b")
    mesh = make_debug_mesh((REF_DP, 1), device="cpu")
    shs = TS.train_shardings(cfg, mesh)
    st = TS.shard_state(TS.state_from_jax(
        cfg, ckpt.restore(ref["dir"], step=0), CPU), shs)
    step = TS.make_train_step(cfg, AdamWConfig(**OPT), accum=2,
                              grad_specs=shs["opt"]["m"])
    losses = []
    for b in ref["batches"]:
        st, m = step(st, _tb(b))
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, ref["losses"], rtol=LOSS_RTOL)
    want = ckpt.restore(ref["dir"], step=3)
    un = TS.unshard_state(st)
    for key in ("params",):
        _assert_params(_np_leaves(un.params), [
            np.asarray(x, np.float32) for x in jax.tree.leaves(want[key])])
    for k in ("m", "v"):
        _assert_params(_np_leaves(un.opt[k]), [
            np.asarray(x, np.float32)
            for x in jax.tree.leaves(want["opt"][k])])
    assert int(un.step) == int(want["step"]) == 3


@pytest.mark.parametrize("tag", [r[0] for r in TP_RUNS])
def test_tp_step_matches_reference_jit(ref, tag, moe_dispatch):
    """3 steps of the port's step tensor-parallel, from the reference's
    init (``state_from_jax``), == the reference's ZeRO-1 step jitted on 8
    forced host devices: tiny llama3-8b on (data 2, model 4) (q heads
    split, kv heads all-gathered) and tiny granite-moe-1b on (data 2,
    model 2) (experts split, vocab split, the microbatch's 128-token
    GShard group cut by the data shards and tokens dropped), tiny
    recurrentgemma-9b/3 and mamba2-370m/2 on (data 2, model 4) (the
    ``rglru`` and ``ssd`` blocks split by channels and heads). Each loss
    at LOSS_RTOL, ``m`` and ``v`` at PARAM_TOL, the params at PARAM_TOL
    but for AdamW's sign flips (``test_torch_tp_training.py``). The
    collective bytes a step, the port's counted and the reference's
    compiled HLO's, print under ``pytest -s``: a record, not a gate
    (GSPMD's choices vary with the jax version)."""
    _, arch, shape, kw = next(r for r in TP_RUNS if r[0] == tag)
    cfg = get_tiny(arch).replace(**kw)
    mesh = make_debug_mesh(shape, device="cpu")
    shs = TS.train_shardings(cfg, mesh)
    d = os.path.join(ref["dir"], tag)
    st = TS.shard_state(TS.state_from_jax(cfg, ckpt.restore(d, step=0),
                                          CPU), shs)
    step = TS.make_train_step(cfg, AdamWConfig(**OPT), accum=2,
                              grad_specs=shs["opt"]["m"])
    losses, lrs = [], []
    CO.reset_bytes()
    for b in ref["batches"]:
        st, m = step(st, _tb(b))
        losses.append(float(m["loss"]))
        lrs.append(float(m["lr"]))
    print(json.dumps({tag: {
        "port_counted": {k: v // len(lrs) for k, v in CO.BYTES.items()},
        "reference_hlo": ref[tag + "_coll_bytes"]}}))
    np.testing.assert_allclose(losses, ref[tag], rtol=LOSS_RTOL)
    want = ckpt.restore(d, step=3)
    un = TS.unshard_state(st)
    wv = [torch.from_numpy(np.asarray(x, np.float32))
          for x in jax.tree.leaves(want["opt"]["v"])]
    assert_params_or_flips(
        list(tree_leaves(un.params)),
        [torch.from_numpy(np.asarray(x, np.float32))
         for x in jax.tree.leaves(want["params"])],
        list(tree_leaves(un.opt["v"])), wv, sum(lrs), 3)
    for k in ("m", "v"):
        _assert_params(_np_leaves(un.opt[k]), [
            np.asarray(x, np.float32)
            for x in jax.tree.leaves(want["opt"][k])])
    assert int(un.step) == int(want["step"]) == 3
    if cfg.num_experts:
        assert moe_dispatch["cut"] and moe_dispatch["dropped"]


def _tiny_cell(kind):
    """count_step of tiny llama3-8b's train (accum 2, B 4 x 64), prefill
    (``auto``, B 2 x 64) and decode (B 2, cache 64) steps on meta."""
    cfg = get_tiny("llama3-8b")
    mesh = DR.meta_mesh(make_debug_mesh((1, 1), device="cpu"))
    Bc, Sc = (4, 64) if kind == "train" else (2, 64)
    fn, args, _, _ = DR.build_cell_for(cfg, kind, Bc, Sc, mesh, accum=2)
    return RL.count_step(fn, *args).flops


def test_count_step_vs_reference_hlo(ref):
    """The port's matrix-product FLOPs (``count_step`` on meta) within 5%
    of the reference's ``analyze_hlo`` (dot FLOPs, trip-corrected) on the
    tiny llama3-8b train (accum 2), prefill and decode cells."""
    ratios = {k: _tiny_cell(k) / ref["flops"][k] for k in ref["flops"]}
    print(json.dumps({"count_step_over_analyze_hlo": ratios}))
    for k, r in ratios.items():
        assert abs(r - 1) <= FLOP_RTOL, (k, r)


def test_dryrun_argument_bytes_equal_reference_compile(ref):
    """The dry-run's per-device argument bytes, summed from
    ``shard_bytes``, equal the reference's ``memory_analysis()
    .argument_size_in_bytes`` on the 2x4 debug mesh, train (accum 2) and
    decode, exactly."""
    cfg = get_tiny("llama3-8b").replace(**MESH_CFG)
    mesh = DR.meta_mesh(make_debug_mesh((2, 4), device="cpu"))
    got = {}
    for kind, Bc in (("train", 4), ("decode", 8)):
        _, args, shardings, _ = DR.build_cell_for(cfg, kind, Bc, 64, mesh,
                                                  accum=2)
        got[kind] = DR.device_bytes(args, shardings)
    assert got == ref["argument_bytes"]


# ---------------- roofline ----------------------------------------------------
def test_roofline_terms_math_h100():
    """``test_roofline_terms_math`` on the H100's constants."""
    t = RL.roofline_terms(flops_device=RL.PEAK_FLOPS,
                          hbm_bytes_device=RL.HBM_BW,
                          coll_bytes_device=RL.NVLINK_BW / 2,
                          model_flops_total=RL.PEAK_FLOPS * 256, chips=256)
    assert t.compute_s == pytest.approx(1.0)
    assert t.memory_s == pytest.approx(1.0)
    assert t.collective_s == pytest.approx(0.5)
    assert t.dominant in ("compute", "memory")
    assert t.useful_ratio == pytest.approx(1.0)
    assert RL.PEAK_FLOPS_BY_TYPE == {"bfloat16": 989e12, "float32": 67e12,
                                     "tf32": 495e12}
    assert (RL.HBM_BW, RL.HBM_BYTES) == (3.35e12, 80e9)


@pytest.mark.parametrize("arch", J_ARCHS)
def test_analytic_functions_equal_reference(arch):
    """The copied closed forms give the reference's numbers, exactly, for
    every shape and both production meshes' chip counts."""
    assert ARCHS == J_ARCHS and SHAPES == J_SHAPES
    cfg, jcfg = get_config(arch), j_config(arch)
    for name, sp in SHAPES.items():
        Bc, Sc, kind = sp["global_batch"], sp["seq_len"], sp["kind"]
        assert RL.model_flops_6nd(cfg, kind, Bc, Sc) == \
            JRL.model_flops_6nd(jcfg, kind, Bc, Sc)
        for frac in (1.0, DR.CC_ACTIVE_FRAC):
            assert RL.analytic_flops(cfg, kind, Bc, Sc, frac) == \
                JRL.analytic_flops(jcfg, kind, Bc, Sc, frac)
        for chips in (256, 512):
            assert RL.analytic_hbm_bytes(cfg, kind, Bc, Sc, chips) == \
                JRL.analytic_hbm_bytes(jcfg, kind, Bc, Sc, chips)


# ---------------- the dry-run at full width on meta ---------------------------
@pytest.fixture
def no_kernels(monkeypatch):
    """Every kernel wrapper the model can reach raises when called."""
    def boom(*a, **k):
        raise AssertionError("a kernel wrapper was reached")
    for mod, name in ((cops, "chunk_attention"), (dops, "decode_attention"),
                      (dops, "paged_decode_attention"), (sops, "ssd_intra"),
                      (rops, "rope")):
        monkeypatch.setattr(mod, name, boom)


@pytest.mark.parametrize("arch,shape,cc", [
    ("llama3-8b", "train_4k", False),
    ("llama3-8b", "prefill_32k", True),
    ("mamba2-370m", "long_500k", False),
])
def test_full_width_dryrun_on_meta(no_kernels, arch, shape, cc):
    """Full-width cells on the single production mesh: status ok, no
    kernel wrapper reached, CUDA never initialised, every record field
    filled (temp bytes null; the tensor-parallel collectives' bytes, the
    train cell's those of ``tp_collective_bytes``, a serving cell's those
    of ``serving_collective_bytes`` through ``cell_tp_bytes``, each in
    the roofline's collective term), and the counted FLOPs
    within a factor 2 of the reference's closed form (``analytic_flops``,
    which leaves out remat's second forward and the norms' and SSD's
    small products)."""
    rec = DR.run_cell(arch, shape, "single", cc=cc)
    assert rec["status"] == "ok", rec.get("traceback")
    assert not torch.cuda.is_initialized()
    assert rec["chips"] == 256 and rec["memory"]["temp_gib"] is None
    tp = rec["counted"]["coll_bytes_tensor_parallel"]
    coll = sum(rec["counted"]["coll_bytes_data_axes"].values())
    cfg = get_config(arch).replace(dtype="bfloat16", param_dtype="bfloat16")
    mesh = DR.meta_mesh(DR.make_production_mesh(device="cpu"))
    sp = SHAPES[shape]
    if shape == "train_4k":
        assert set(tp) == {"reduce-scatter", "all-gather", "all-reduce"}
        assert tp == DR.tp_collective_bytes(cfg, mesh, DR.TRAIN_ACCUM,
                                            sp["global_batch"],
                                            sp["seq_len"])
    else:
        assert set(tp) == {"reduce-scatter", "all-gather", "all-reduce",
                           "kv over model", "kv over data",
                           "logits over model"}
        assert tp == DR.cell_tp_bytes(cfg, sp["kind"], sp["global_batch"],
                                      sp["seq_len"], mesh, cc=cc)
    coll += sum(tp.values())
    assert rec["roofline"]["collective_s"] == pytest.approx(
        coll / RL.NVLINK_BW)
    assert rec["memory"]["argument_bytes"] > 0
    assert rec["memory"]["fits_80gb"] is True
    assert rec["roofline"]["dominant"] in ("compute", "memory",
                                           "collective")
    ratio = rec["counted"]["flops_total"] / rec["analytic"]["flops_total"]
    assert 0.5 < ratio < 2, ratio
    if shape == "train_4k":
        assert set(rec["counted"]["coll_bytes_data_axes"]) == \
            {"reduce-scatter", "all-gather", "all-reduce"}


# ---------------- chip_smoke.py's phase 14, rehearsed on the CPU ---------------
def test_chip_smoke_sharded_phase_rehearsal(monkeypatch):
    """``chip_smoke.run_sharded`` and ``run_tp`` (phases 14 and 15) end
    to end on the CPU at tiny size: the configs tiny, 32-token sequences,
    one dry-run cell (full-width llama3-8b decode_32k on meta, in a
    spawned worker as on the card), so that the phases' checks run as
    they do there. The microbatches' aux terms agree to 1e-3: an
    argmax that flips between the two sums' orders moves ``fe`` by one
    token's share (the loss holds the aux term to LOSS_RTOL through its
    0.01 weight)."""
    import repro_torch.configs as C
    monkeypatch.syspath_prepend(ROOT)
    import chip_smoke as cs
    monkeypatch.setattr(C, "get_config", C.get_tiny)
    monkeypatch.setattr(cs, "SHARD_SEQ", 32)
    monkeypatch.setattr(cs, "TRAIN_SEQ", 32)
    monkeypatch.setattr(cs, "DRYRUN_CELLS", (("decode_32k", False),))
    training = {"llama3-8b/2": dict(step_ms=1.0, mfu_fp32=0.0)}
    out, plain = cs.run_sharded(CPU, "cpu", training)
    z = out["zero1"]
    assert z["coll_bytes_counted"] == z["coll_bytes_closed_form"]
    assert z["zero1_split"]["leaves"] > 0
    assert out["elastic"]["shards_differ"] == 0
    assert out["elastic"]["shards"] > 0
    assert out["roofline"]["count_step_flops"] > 0
    # the serving plan's gathers of the sequence-split cache (8 kv heads
    # do not divide the model axis of 16) put llama3-8b's decode cell on
    # the collective term
    assert out["dryrun"]["decode_32k"]["dominant"] == "collective"
    # phase 15 on the same tiny configs: llama3-8b/2 on (2, 4) against
    # phase 14's unsharded run, recurrentgemma-9b/3 on (1, 4) against an
    # unsharded run (its rglru blocks split), mamba2 cut to 2 layers and
    # whole (4 tiny layers) on (2, 4) (its ssd blocks split) beside its
    # perturbed controls, and in float64 at 2 layers on (2, 4) and (2, 1)
    # and whole on (2, 4), and granite-moe-1b cut to 2 layers and whole:
    # on (4, 1) and (2, 2) one sharded step from each unsharded state
    # replaying its expert ids, and at 2 layers alone the whole runs (on
    # (4, 1) free, MOE_STRICT, on (2, 2) replaying); no granite control;
    # on the host CPU at tiny size every run but mamba2's fp32 ones
    # (AdamW's flips on its clipped grads) meets the strict standard too,
    # and no step flips a route
    tp = cs.run_tp(CPU, "cpu", plain)
    g, m2 = "granite-moe-1b-tiny", "mamba2-tiny"
    f64 = {f"{m2}/2 [2, 4] float64", f"{m2}/2 [2, 1] float64",
           f"{m2}/4 [2, 4] float64"}
    assert set(tp) == {"llama3-8b/2", "recurrentgemma-9b-tiny/3 [1, 4]",
                       f"{m2}/2 [2, 4]", f"{m2}/4 [2, 4]",
                       f"{g}/2 unsharded", f"{g}/2 [4, 1]",
                       f"{g}/2 [2, 2]", f"{g}/4 unsharded", f"{g}/4 [4, 1]",
                       f"{g}/4 [2, 2]", "seconds"} | f64
    for k in f64:
        # the float64 gate: no exemption, the fixed standard at tiny size
        r = tp[k]
        assert r["ok"] and r["state_dtypes"] == ["torch.float64"]
        assert r["gated"] == ["after 1", f"after {cs.SHARD_STEPS}"]
        assert not r["made"] and r["backward_ops_seen"] > 0
        for c in r["gated"]:
            assert r[c]["ok"] and r[c]["tau"] == cs.F64_TOL
            assert r[c]["loss_rel_gap"] <= cs.F64_TOL
            assert all(not r[c][w]["beyond"] for w in ("params", "m", "v"))
    assert not hasattr(cs, "MOE_LOOSE")
    for k, r in tp.items():
        if k in f64 or k == "seconds" or k.endswith("unsharded"):
            continue
        assert "controls" not in r and "control_flips" not in r or \
            k.startswith(m2)
        # granite whole: the one-step check alone, no free run
        assert ("mesh" in r) == (not k.startswith(f"{g}/4 "))
        if "mesh" in r:
            assert r["coll_bytes_counted"] == r["coll_bytes_closed_form"]
            assert r["position0_bytes"] == r["layout_bytes"]
            assert (r["strict"] and r["loss_rel_gap"] <= cs.LOSS_RTOL) or \
                k.startswith(m2)
            assert ("control_loss_rel_gap" in r) == k.startswith(m2)
        if k.startswith(m2):
            assert r["flips"] == []
            assert len(r["control_flips"]) == len(cs.MOE_SEEDS)
        if k.startswith(f"{g}/2 "):
            # every whole run but MOE_STRICT's replays, and is strict
            shape = tuple(r["mesh"])
            assert r["flips"] == [0] * cs.SHARD_STEPS
            assert r["replayed"] == ((2, shape) not in cs.MOE_STRICT)
            if r["replayed"]:
                assert r["strict"]
                assert [p["outside"] for p in r["probs_vs_plain"]] == \
                    [0] * cs.SHARD_STEPS
        assert ("one_step" in r) == k.startswith((g, f"{m2}/2 "))
        assert ("one_step_data_parallel" in r) == k.startswith(f"{m2}/2 ")
        steps = [(st, sts[0]) for sts in (r.get("one_step", []),
                                          r.get("one_step_data_parallel",
                                                []))
                 for st in sts]
        for st, first in steps:
            assert st["strict"] and st["loss_rel_gap"] <= cs.LOSS_RTOL
            assert st["m_outside"] == st["v_outside"] == 0
            assert all(e["flip"] for e in st["params_outside_elements"])
            assert st["coll_bytes_counted"] == first["coll_bytes_counted"]
            if k.startswith(g):
                # replayed: its own top-k and its probs logged
                assert st["flips"] == 0
                assert st["probs_vs_plain"]["outside"] == 0
                assert all(a > 0 for s in st["aux"] for a in s)
    for k in (f"{g}/2 [4, 1]", f"{g}/2 [2, 2]", f"{g}/4 [4, 1]",
              f"{g}/4 [2, 2]"):
        assert [st["step"] for st in tp[k]["one_step"]] == \
            list(range(1, cs.SHARD_STEPS + 1))
    # one step of the whole run's counted collective bytes
    for k in (f"{g}/2 [4, 1]", f"{g}/2 [2, 2]"):
        assert {b: cs.SHARD_STEPS * v for b, v in
                tp[k]["one_step"][0]["coll_bytes_counted"].items()} == \
            tp[k]["coll_bytes_counted"]
    assert "controls" not in tp[f"{g}/2 unsharded"]
    assert tp[f"{g}/2 [2, 2]"]["aux_rel_gap"] <= 1e-3
