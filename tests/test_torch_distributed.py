"""The port's distribution layer against the reference's: sharding rules
(``distributed/sharding.py``), the ``sharded`` backend and head-sharded
serving on a one-process serving mesh (``launch/mesh.py``,
``distributed/collectives.py``), context-parallel ``flash_cp`` and the
int8 error-feedback gradient all-reduce (``distributed/compression.py``).

Inputs come from numpy seeds. The reference's mesh functions run in a
subprocess with forced host devices (``XLA_FLAGS``), as its own tests run
them; the port's meshes list the CPU device once per shard. The
reference's own sharded-engine gate is not borrowed: the port proves
sharded == single-device inside itself, bit for bit, and holds the
sharded engine against the JAX unsharded engine at 2e-4.
"""
import json
import os
import subprocess
import sys
import textwrap
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import get_config as j_config
from repro.configs import get_tiny as j_tiny
from repro.distributed import compression as JC
from repro.distributed import sharding as JSH
from repro.models import model as JM
from repro.serving.api import EngineSpec as JSpec
from repro.serving.api import build_engine as j_build
from repro.serving.rag import KnowledgeBase as JKB
from repro.serving.scheduler import SchedulerConfig as JSched
from repro.serving.workload import WorkloadConfig as JWL
from repro.serving.workload import generate as j_generate
from repro_torch.configs import get_config, get_tiny
from repro_torch.distributed import compression as TC
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.collectives import all_gather, psum, shard_map
from repro_torch.kernels.decode_attention import ops as dops
from repro_torch.launch import mesh as MESH
from repro_torch.models import backend as AB
from repro_torch.models import layers as L
from repro_torch.models import model as TM
from repro_torch.serving.api import EngineSpec, build_engine
from repro_torch.serving.rag import KnowledgeBase
from repro_torch.serving.scheduler import SchedulerConfig
from repro_torch.serving.workload import WorkloadConfig, generate

torch.set_num_threads(2)
CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=2e-4, atol=2e-4)
# the head-summed masses: the sharded backend sums each shard's heads,
# then the shards in order, which reorders an fp32 sum of up to H * Tq
# probabilities (key_mass reaches ~20 here, where one ulp is 1.9e-6)
MASS_TOL = dict(rtol=1e-6, atol=1e-6)


def _serving_mesh(n):
    return MESH.make_serving_mesh(n, device="cpu")


@pytest.fixture(autouse=True)
def _no_mesh():
    """Every test starts and ends with no mesh installed (module state)."""
    AB.set_serving_mesh(None)
    AB.set_cp_mesh(None)
    yield
    AB.set_serving_mesh(None)
    AB.set_cp_mesh(None)


def _spec(p):
    """A port or JAX PartitionSpec as a plain tuple, UNCONSTRAINED named."""
    un = (SH.P.UNCONSTRAINED, JP.UNCONSTRAINED)
    return tuple("UNC" if any(e is u for u in un) else e for e in p)


def _run(code: str, timeout=600):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=timeout)


# ---- meshes -----------------------------------------------------------------
def test_meshes_list_devices_and_axes():
    m = _serving_mesh(4)
    assert m.axis_names == ("heads",) and m.shape == {"heads": 4}
    assert m.axis_devices("heads") == (CPU,) * 4
    d = MESH.make_debug_mesh((2, 4), device="cpu")
    assert d.shape == {"data": 2, "model": 4} and d.size == 8
    assert MESH.data_axes(d) == ("data",) and MESH.dp_size(d) == 2
    p = MESH.make_production_mesh(multi_pod=True, device="cpu")
    assert p.shape == {"pod": 2, "data": 16, "model": 16}
    assert MESH.data_axes(p) == ("pod", "data") and MESH.dp_size(p) == 32
    assert MESH.make_serving_mesh(device=["cpu", "cpu"]).shape == \
        {"heads": 2}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            MESH.make_serving_mesh(4)


def test_shard_map_splits_views_and_collectives():
    """Operands split along the spec's axis into views (no copy on their
    own device), the body runs once per shard in order, all_gather
    concatenates and psum sums in shard order."""
    m = _serving_mesh(4)
    x = torch.arange(2 * 8 * 3, dtype=torch.float32).reshape(2, 8, 3)
    seen = []

    def body(xs, r):
        seen.append(xs)
        return xs * 2, (xs * r).sum()
    parts = shard_map(body, mesh=m, in_specs=(SH.P(None, "heads"), SH.P()),
                      axis="heads")(x, torch.tensor(3.0))
    assert [s.data_ptr() for s in seen] == \
        [x.data_ptr() + 2 * 3 * 4 * i for i in range(4)]
    assert torch.equal(all_gather([p[0] for p in parts], 1), x * 2)
    want = ((x[:, 0:2] * 3).sum() + (x[:, 2:4] * 3).sum()) + \
        (x[:, 4:6] * 3).sum()
    want = want + (x[:, 6:8] * 3).sum()
    assert torch.equal(psum([p[1] for p in parts]), want)
    with pytest.raises(ValueError, match="split"):
        shard_map(lambda a: a, mesh=m, in_specs=(SH.P("heads"),),
                  axis="heads")(torch.zeros(6))


# ---- sharding rules against the reference ----------------------------------
def test_logical_spec_resolution():
    rules = {"batch": "data", "heads": "model", "mlp": "model",
             "kv": ("data", "model")}
    cases = [(("batch", None, "heads"), False), (("heads", "mlp"), False),
             (("heads", "mlp"), True), (("batch", "nope", "mlp"), True),
             (("kv", "heads"), False), ((None, None), True)]
    with SH.axis_rules(rules), JSH.axis_rules(rules):
        for axes, unc in cases:
            assert _spec(SH.logical_spec(axes, unc)) == \
                _spec(JSH.logical_spec(axes, unc)), axes
        assert SH.logical_spec(("batch", None, "heads")) == \
            SH.P("data", None, "model")
        assert SH.logical_spec(("heads", "mlp")) == SH.P("model")
        x = torch.zeros(2, 3)
        assert SH.shd(x, "batch", None) is x
        with pytest.raises(ValueError, match="rank"):
            SH.shd(x, "batch")
    assert SH.logical_spec(("batch",)) == SH.P()    # no rules -> no-op
    assert SH.shd(torch.zeros(2), "a", "b", "c").shape == (2,)


def test_zero1_spec():
    cases = [((None, "model"), (64, 32), ("data",), 16),
             (("data",), (64,), ("data",), 16),
             ((), (7, 5), ("data",), 16),
             ((None, "model"), (64, 32), ("pod", "data"), 32),
             (("model",), (16, 96), ("data",), 16)]
    for spec, shape, daxes, size in cases:
        got = SH.zero1_spec(SH.P(*spec), shape, daxes, size)
        assert _spec(got) == _spec(JSH.zero1_spec(JP(*spec), shape, daxes,
                                                  size)), spec
    assert SH.zero1_spec(SH.P(None, "model"), (64, 32), ("data",), 16) == \
        SH.P("data", "model")


class _FakeMesh:
    def __init__(self, **shape):
        self.axis_names = tuple(shape)
        self.shape = dict(shape)


@pytest.mark.parametrize("arch", ["llama3.2-3b", "deepseek-67b",
                                  "deepseek-7b", "gemma3-4b", "llama3-8b"])
def test_make_rules_and_cache_spec_match_reference(arch):
    mesh = _FakeMesh(data=16, model=16)
    rules = SH.make_rules(mesh, get_config(arch))
    assert rules == JSH.make_rules(mesh, j_config(arch))
    assert SH.make_rules(mesh, get_config(arch), seq_shard=True,
                         batch_shard=False) == JSH.make_rules(
        mesh, j_config(arch), seq_shard=True, batch_shard=False)
    pod = _FakeMesh(pod=2, data=16, model=16)
    assert SH.make_rules(pod) == JSH.make_rules(pod)
    for m in (mesh, pod):
        assert SH.kv_cache_spec(m, get_config(arch), seq_axis="model") == \
            JSH.kv_cache_spec(m, j_config(arch), seq_axis="model")
    if arch == "llama3.2-3b":
        assert rules["heads"] is None and rules["q_head_dim"] == "model"
    if arch == "deepseek-67b":
        assert rules["heads"] == "model" and rules["kv_heads"] is None
    if arch == "deepseek-7b":
        assert rules["kv_heads"] == "model"


def test_spec_tree_of_param_axes():
    """The port's logical axes tree resolved like the reference's."""
    cfg, jcfg = get_tiny("llama3-8b"), j_tiny("llama3-8b")
    mesh = _FakeMesh(data=2, model=2)
    with SH.axis_rules(SH.make_rules(mesh, cfg)), \
            JSH.axis_rules(JSH.make_rules(mesh, jcfg)):
        jt = JSH.spec_tree(JM.param_axes(jcfg))
        axes = jax.tree.map(lambda a: a, JM.param_axes(jcfg),
                            is_leaf=lambda v: isinstance(v, tuple))
        tt = SH.spec_tree(axes)
    flat_j = jax.tree.leaves(jt, is_leaf=lambda v: isinstance(v, JP))
    flat_t = jax.tree.leaves(tt, is_leaf=lambda v: isinstance(v, SH.P))
    assert len(flat_j) == len(flat_t) > 0
    for a, b in zip(flat_t, flat_j):
        assert _spec(a) == _spec(b)


def test_serving_rules_reject_indivisible_heads():
    cfg = get_tiny("llama3-8b").replace(num_heads=4, num_kv_heads=4)
    with pytest.raises(ValueError):
        SH.serving_rules(_FakeMesh(heads=3), cfg)
    with pytest.raises(ValueError):
        SH.serving_kv_shards(_FakeMesh(heads=3), cfg)
    assert SH.serving_kv_shards(_FakeMesh(heads=4), cfg) == 4
    assert SH.serving_rules(_FakeMesh(heads=2), cfg) == \
        JSH.serving_rules(_FakeMesh(heads=2), cfg)
    params = TM.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="divide"):
        build_engine(EngineSpec(device="cpu", store=None, strategy="all",
                                mesh=_serving_mesh(3)),
                     cfg=cfg, params=params, store=None)


# ---- the sharded backend against dense --------------------------------------
def _attn_inputs(seed, B=2, Tq=12, S=20, H=8, Hkv=4, D=16, C=4):
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(  # noqa: E731
        rng.normal(size=s).astype(np.float32))
    q, k, v = f(B, Tq, H, D), f(B, S, Hkv, D), f(B, S, Hkv, D)
    kv_pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    kv_pos[:, -3:] = -1
    pos = np.sort(rng.choice(S - 3, size=(B, Tq)), axis=1).astype(np.int32)
    pos[0, 0] = -1
    chunk = np.minimum(np.arange(S) * C // S, C - 1).astype(np.int32)
    return (q, k, v, torch.from_numpy(kv_pos), torch.from_numpy(pos),
            torch.from_numpy(np.tile(chunk, (B, 1))))


def _ctx(cfg, impl, pos, **kw):
    base = dict(cfg=cfg, mode="prefill", positions=pos, chunk_ids=None,
                collect_stats=False, attn_impl=impl, seg_ids=None,
                kv_seg=None, pack_qidx=None, pack_kidx=None,
                paged_rows=None, paged_block_rows=None, paged_block_size=0)
    base.update(kw)
    return SimpleNamespace(**base)


def _both(cfg, n, q, k, v, kv_pos, pos, kind="attn", **kw):
    AB.set_serving_mesh(None)
    want = AB.attend(_ctx(cfg, "dense", pos, **kw), kind, q, k, v, kv_pos)
    AB.set_serving_mesh(_serving_mesh(n))
    got = AB.attend(_ctx(cfg, "sharded", pos, **kw), kind, q, k, v, kv_pos)
    AB.set_serving_mesh(None)
    return got, want


def _check(got, want, stats):
    assert torch.equal(got[0], want[0])               # out: bit for bit
    if stats:
        for g, w in zip(got[1:], want[1:]):
            torch.testing.assert_close(g, w, **MASS_TOL)
    else:
        assert got[1] is None and got[2] is None


@pytest.mark.parametrize("n", [1, 2, 4])
def test_sharded_prefill_with_stats_equals_dense(n):
    cfg = get_tiny("llama3-8b").replace(window=6, stats_chunks=4)
    q, k, v, kv_pos, pos, chunk = _attn_inputs(n)
    for kind in ("attn", "local"):
        got, want = _both(cfg, n, q, k, v, kv_pos, pos, kind,
                          chunk_ids=chunk, collect_stats=True)
        assert want[1] is not None and want[2] is not None
        _check(got, want, True)
    got, want = _both(cfg, n, q, k, v, kv_pos, pos)
    _check(got, want, False)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_sharded_packed_block_diagonal_equals_dense(n):
    """Two packed requests through the block-diagonal gather maps and
    through segment masks, with stats."""
    cfg = get_tiny("llama3-8b").replace(stats_chunks=4)
    q, k, v, kv_pos, pos, chunk = _attn_inputs(10 + n, B=1, Tq=10, S=16)
    seg = torch.tensor([[0] * 4 + [1] * 6], dtype=torch.int32)
    kseg = torch.tensor([[0] * 7 + [1] * 9], dtype=torch.int32)
    qidx = torch.tensor([[0, 1, 2, 3, -1, -1], [4, 5, 6, 7, 8, 9]],
                        dtype=torch.int32).long()
    kidx = torch.tensor([[0, 1, 2, 3, 4, 5, 6, -1, -1],
                         list(range(7, 16))], dtype=torch.int32).long()
    for maps in (dict(pack_qidx=qidx, pack_kidx=kidx), {}):
        got, want = _both(cfg, n, q, k, v, kv_pos, pos, seg_ids=seg,
                          kv_seg=kseg, chunk_ids=chunk, collect_stats=True,
                          mode="partial", **maps)
        _check(got, want, True)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_sharded_decode_equals_dense(n):
    """One-token decode with a masked batch row (q_pos -1): zeros there,
    the live rows bit for bit."""
    cfg = get_tiny("llama3-8b")
    q, k, v, kv_pos, _, _ = _attn_inputs(20 + n, B=3, Tq=1, S=24)
    pos = torch.tensor([[20], [-1], [9]], dtype=torch.int32)
    got, want = _both(cfg, n, q, k, v, kv_pos, pos, mode="decode")
    _check(got, want, False)
    assert float(got[0][1].abs().sum()) == 0.0


def test_mesh_backends_reject_indivisible_heads():
    cfg = get_tiny("llama3-8b")
    q, k, v, kv_pos, pos, _ = _attn_inputs(0, H=6, Hkv=3)
    AB.set_serving_mesh(_serving_mesh(2))
    with pytest.raises(ValueError, match="divisible"):
        AB.attend(_ctx(cfg, "sharded", pos), "attn", q, k, v, kv_pos)


# ---- the engine on a serving mesh -------------------------------------------
MESH_CFG = dict(num_heads=4, num_kv_heads=4)


@pytest.fixture(scope="module")
def mesh_world():
    cfg = get_tiny("llama3-8b").replace(**MESH_CFG)
    jcfg = j_tiny("llama3-8b").replace(**MESH_CFG)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = TM.params_from_jax(cfg, jax.tree.map(np.asarray, jparams),
                                 "cpu")
    return cfg, jcfg, tparams, jparams


def _wl(mod):
    return mod(num_requests=4, qpm=1e9, seed=3, max_new_tokens=4)


def _sched(mod):
    return mod(max_batch_tokens=100_000, max_decode_batch=8,
               max_prefill_batch=4)


def _port_engine(world, mesh=None, **kw):
    """The reference's sharded-engine workload (strategy ``all``, no
    store, 4 requests of 4 new tokens) on the port."""
    cfg, _jcfg, tparams, _jp = world
    AB.set_serving_mesh(None)
    eng = build_engine(
        EngineSpec(strategy="all", use_focus=False, pool_blocks=1024,
                   sched=_sched(SchedulerConfig), trace_decode=True,
                   mesh=mesh, device="cpu", **kw),
        cfg=cfg, params=tparams, store=None)
    kb = KnowledgeBase(num_chunks=8, vocab_size=cfg.vocab_size, seed=0)
    reqs = generate(kb, _wl(WorkloadConfig))
    stats = eng.run(reqs)
    assert stats.completed == 4 and stats.failed == 0
    return eng, reqs


def _bit_equal_runs(e1, r1, e2, r2):
    for a, b in zip(r1, r2):
        assert a.output_tokens == b.output_tokens
    assert len(e1.decode_trace) == len(e2.decode_trace) > 0
    for da, db in zip(e1.decode_trace, e2.decode_trace):
        assert set(da) == set(db)
        for rid in da:
            assert np.array_equal(da[rid], db[rid]), rid
    assert set(e1.final_kv) == set(e2.final_kv) and e1.final_kv
    for rid in e1.final_kv:
        for x, y in zip(e1.final_kv[rid], e2.final_kv[rid]):
            assert np.array_equal(x, y), rid


@pytest.fixture(scope="module")
def unsharded(mesh_world):
    return _port_engine(mesh_world)


@pytest.fixture(scope="module")
def sharded(mesh_world):
    out = _port_engine(mesh_world, _serving_mesh(4))
    AB.set_serving_mesh(None)
    return out


def test_sharded_engine_bit_identical_and_cheaper(unsharded, sharded):
    """The reference's gate (tests/test_attention_backends.py), proved
    inside the port: tokens, decode trace and final KV bit for bit;
    per-device KV bytes and attention FLOPs lower, totals equal."""
    (e1, r1), (e2, r2) = unsharded, sharded
    assert e1.kv_shards == 1 and e2.kv_shards == 4
    assert e2.attn_impl == "sharded"
    _bit_equal_runs(e1, r1, e2, r2)
    b1 = e1.pool.peak_kv_bytes_per_device()
    b4 = e2.pool.peak_kv_bytes_per_device()
    f1, f4 = e1.counters.attn_flops_device, e2.counters.attn_flops_device
    assert 0 < b4 < b1 and b4 * 4 == b1
    assert 0 < f4 < f1 and f4 * 4 == f1
    assert e1.counters.attn_flops_total == e2.counters.attn_flops_total


def test_sharded_engine_matches_jax_engine(mesh_world, sharded):
    """The sharded port engine against the JAX engine without a mesh on
    the same workload and weights, at 2e-4."""
    _cfg, jcfg, _tp, jparams = mesh_world
    eng_j = j_build(JSpec(strategy="all", use_focus=False, pool_blocks=1024,
                          sched=_sched(JSched), trace_decode=True),
                    cfg=jcfg, params=jparams, store=None)
    kb = JKB(num_chunks=8, vocab_size=jcfg.vocab_size, seed=0)
    reqs_j = j_generate(kb, _wl(JWL))
    eng_j.run(reqs_j)
    eng_t, reqs_t = sharded
    for rt, rj in zip(reqs_t, reqs_j):
        assert rt.output_tokens == rj.output_tokens
    assert len(eng_t.decode_trace) == len(eng_j.decode_trace) > 0
    for tt, tj in zip(eng_t.decode_trace, eng_j.decode_trace):
        assert set(tt) == set(tj)
        for rid in tt:
            np.testing.assert_allclose(tt[rid], np.asarray(tj[rid]), **TOL)


def test_paged_sharded_mesh_bit_identical(mesh_world, sharded):
    """Head-sharded mesh + paged decode (tests/test_paged_decode.py):
    bit-identical to the arena run on the same mesh, 0 gather bytes."""
    e2, r2 = _port_engine(mesh_world, _serving_mesh(4), paged_decode=True)
    e1, r1 = sharded
    assert e2.kv_shards == 4
    _bit_equal_runs(e1, r1, e2, r2)
    assert e2.counters.decode_gather_bytes == 0
    assert e1.counters.decode_gather_bytes > 0


@pytest.mark.parametrize("n", [2, 4])
def test_paged_kernel_under_mesh_per_shard_launches(mesh_world, monkeypatch,
                                                    n):
    """``paged_kernel`` with the serving mesh installed (the reference's
    backend route): one wrapper call per shard, layer and decode step, each
    on its head slice of the pool twin (a view); on the CPU the wrapper's
    plain route, within 1e-6 of the unsharded engine."""
    calls = []
    orig = dops.paged_decode_attention

    def counted(q, kb, vb, *a, **k):
        calls.append((tuple(q.shape), kb.is_contiguous(), kb.data_ptr()))
        return orig(q, kb, vb, *a, **k)
    monkeypatch.setattr(dops, "paged_decode_attention", counted)
    e1, r1 = _port_engine(mesh_world, attn_impl="paged_kernel",
                          paged_decode=True)
    n1 = len(calls)
    cfg = mesh_world[0]
    assert n1 == cfg.num_layers * e1.stats.decode_steps
    calls.clear()
    AB.set_serving_mesh(_serving_mesh(n))
    cfg, _jcfg, tparams, _jp = mesh_world
    eng = build_engine(
        EngineSpec(strategy="all", use_focus=False, pool_blocks=1024,
                   sched=_sched(SchedulerConfig), trace_decode=True,
                   attn_impl="paged_kernel", paged_decode=True,
                   device="cpu"),
        cfg=cfg, params=tparams, store=None)
    kb = KnowledgeBase(num_chunks=8, vocab_size=cfg.vocab_size, seed=0)
    reqs = generate(kb, _wl(WorkloadConfig))
    eng.run(reqs)
    AB.set_serving_mesh(None)
    assert len(calls) == n * cfg.num_layers * eng.stats.decode_steps
    assert all(shape[1] == cfg.num_heads // n and not contig
               for shape, contig, _ in calls)
    for a, b in zip(r1, reqs):
        assert a.output_tokens == b.output_tokens
    for da, db in zip(e1.decode_trace, eng.decode_trace):
        for rid in da:
            np.testing.assert_allclose(db[rid], da[rid], rtol=0, atol=1e-6)


# ---- context-parallel flash -------------------------------------------------
def _cp_inputs(seed, B=2, T=150, S=170, H=4, Hkv=2, D=16):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, T, H, D)).astype(np.float32)
    k = rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
    k_pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    k_pos[1, -7:] = -1
    q_pos = np.tile(np.arange(S - T, S, dtype=np.int32), (B, 1))
    return dict(q=q, k=k, v=v, q_pos=q_pos, k_pos=k_pos)


def test_flash_cp_matches_jax_and_flash(tmp_path):
    """``gqa_attend_flash_cp`` over a CP mesh of 4 (rows padded from 150
    to 152, window 0 and 40) against the JAX function on 4 forced host
    devices at 1e-5, and against the port's own ``gqa_attend_flash``."""
    ins = _cp_inputs(0)
    np.savez(tmp_path / "in.npz", **ins)
    r = _run(f"""
        import os
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
        os.environ["JAX_PLATFORMS"] = "cpu"
        import jax, numpy as np
        from jax.sharding import Mesh
        from repro.models.layers import gqa_attend_flash_cp
        d = dict(np.load({str(tmp_path / "in.npz")!r}))
        mesh = Mesh(np.array(jax.devices()[:4]), ("model",))
        out = {{f"w{{w}}": np.asarray(gqa_attend_flash_cp(
            d["q"], d["k"], d["v"], d["q_pos"], d["k_pos"], mesh, w))
            for w in (0, 40)}}
        np.savez({str(tmp_path / "out.npz")!r}, **out)
        print("CP_OK")
    """)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "CP_OK" in r.stdout
    want = np.load(tmp_path / "out.npz")
    t = {k: torch.from_numpy(v) for k, v in ins.items()}
    cp = MESH.make_debug_mesh((4,), ("model",), device="cpu")
    for w in (0, 40):
        got = L.gqa_attend_flash_cp(t["q"], t["k"], t["v"], t["q_pos"],
                                    t["k_pos"], cp, w)
        assert got.shape == t["q"].shape
        np.testing.assert_allclose(got.numpy(), want[f"w{w}"], rtol=1e-5,
                                   atol=1e-5)
        flash = L.gqa_attend_flash(t["q"], t["k"], t["v"], t["q_pos"],
                                   t["k_pos"], w)
        torch.testing.assert_close(got, flash, rtol=1e-5, atol=1e-5)


def test_flash_cp_backend_through_prefill():
    """``attn_impl="flash_cp"`` with a CP mesh installed (``model.
    set_cp_mesh``) against ``flash`` through the model's prefill, and
    dense when stats are collected."""
    cfg = get_tiny("llama3-8b")
    params = TM.init_params(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 130))
                            .astype(np.int32))
    ref = TM.prefill(cfg, params, toks, attn_impl="flash")
    TM.set_cp_mesh(MESH.make_debug_mesh((4,), ("model",), device="cpu"))
    got = TM.prefill(cfg, params, toks, attn_impl="flash_cp")
    torch.testing.assert_close(got.logits, ref.logits, rtol=1e-5, atol=1e-5)
    dense = TM.prefill(cfg, params, toks, attn_impl="dense",
                       collect_stats=True)
    stats = TM.prefill(cfg, params, toks, attn_impl="flash_cp",
                       collect_stats=True)
    assert torch.equal(stats.logits, dense.logits)


# ---- int8 error-feedback compression ---------------------------------------
def test_quantize_int8_bit_equal_to_jax():
    rng = np.random.default_rng(0)
    for x in (rng.normal(size=(64,)) * 10, rng.normal(size=(8, 33)),
              np.array([0.5, -1.5, 2.5, 127.0, -127.0, 0.0]),
              np.zeros(5)):
        x = x.astype(np.float32)
        q, s = TC.quantize_int8(torch.from_numpy(x))
        jq, js = JC.quantize_int8(jax.numpy.asarray(x))
        assert q.dtype == torch.int8
        assert np.array_equal(q.numpy(), np.asarray(jq))
        assert np.float32(s.item()).tobytes() == \
            np.asarray(js, np.float32).tobytes()
        assert np.array_equal(
            TC.dequantize_int8(q, s).numpy(),
            np.asarray(JC.dequantize_int8(jq, js)))


def test_quantize_roundtrip_bounded():
    """tests/test_training.py's bound, on the port."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(64,)).astype(np.float32)) * 10
    q, s = TC.quantize_int8(x)
    err = (TC.dequantize_int8(q, s) - x).abs()
    assert float(err.max()) <= float(s) / 2 + 1e-6
    assert TC.compression_ratio({"w": x}) == 0.25
    ef = TC.init_error_feedback({"a": x, "b": [x[:3].double()]})
    assert ef["a"].dtype == torch.float32 and float(ef["b"][0].abs().sum()) \
        == 0.0 and ef["b"][0].shape == (3,)


def test_ef_allreduce_matches_jax_shard_map(tmp_path):
    """The 8-shard error-feedback all-reduce over 8 steps against the
    reference's ``shard_map`` version on 8 forced host devices
    (tests/test_training.py): means and errors within 1e-6 at every step,
    each step's mean within 0.2 of the exact mean (relative), and the
    accumulated mean within 0.02 of it (error feedback)."""
    rng = np.random.default_rng(0)
    g_all = rng.normal(size=(8, 32)).astype(np.float32)
    np.save(tmp_path / "g.npy", g_all)
    r = _run(f"""
        import os
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
        os.environ["JAX_PLATFORMS"] = "cpu"
        import jax, jax.numpy as jnp, numpy as np
        from jax.sharding import Mesh, PartitionSpec as P
        from repro.compat import shard_map
        from repro.distributed.compression import ef_allreduce_grads
        mesh = Mesh(np.array(jax.devices()).reshape(8), ("dp",))
        g_all = jnp.asarray(np.load({str(tmp_path / "g.npy")!r}))
        def body(g, e):
            m, e2 = ef_allreduce_grads({{"w": g}}, {{"w": e}}, "dp")
            return m["w"], e2["w"]
        f = jax.jit(shard_map(body, mesh=mesh, in_specs=(P("dp"), P("dp")),
                              out_specs=(P("dp"), P("dp"))))
        e = jnp.zeros((8, 32), jnp.float32)
        means, errs = [], []
        for step in range(8):
            mean, e = f(g_all, e)
            means.append(np.asarray(mean))
            errs.append(np.asarray(e))
        np.savez({str(tmp_path / "ef.npz")!r}, means=np.stack(means),
                 errs=np.stack(errs))
        print("EF_OK")
    """)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "EF_OK" in r.stdout
    want = np.load(tmp_path / "ef.npz")
    exact = g_all.mean(0)
    grads = [{"w": torch.from_numpy(g_all[s])} for s in range(8)]
    ef = [TC.init_error_feedback(g) for g in grads]
    total = np.zeros(32)
    for step in range(8):
        means, ef = TC.ef_allreduce_grads(grads, ef)
        got = means[0]["w"].numpy()
        assert all(torch.equal(m["w"], means[0]["w"]) for m in means)
        np.testing.assert_allclose(got, want["means"][step, 0], rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(np.stack([e["w"].numpy() for e in ef]),
                                   want["errs"][step], rtol=0, atol=1e-6)
        total += got
        rel = np.abs(got - exact).max() / (np.abs(exact).max() + 1e-9)
        assert rel < 0.2, rel
    drift = np.abs(total / 8 - exact).max() / (np.abs(exact).max() + 1e-9)
    assert drift < 0.02, drift
    print(json.dumps({"drift": float(drift)}))


# ---- chip_smoke.py's mesh phases, rehearsed on the CPU ----------------------
def test_chip_smoke_mesh_phases_rehearsal(monkeypatch, tmp_path):
    """``chip_smoke.run_mesh`` and ``run_cp_ef`` end to end on the CPU at
    tiny size: llama3-8b with 4 / 4 heads (so that 4 shards divide them),
    gemma3-4b's prompt cut to 256 tokens, the engines' spec on the CPU,
    the timers stubbed and the paged wrapper counting its calls onto the
    plain version, so that the phases' checks run as on the card."""
    import repro_torch.configs as C
    from repro_torch.kernels.decode_attention.ref import \
        paged_decode_attention_ref
    from repro_torch.serving import api

    monkeypatch.syspath_prepend(ROOT)
    import chip_smoke as cs

    def tiny(name):
        cfg = C.get_tiny(name)
        return cfg.replace(**MESH_CFG) if name == "llama3-8b" else cfg

    spec_cls = api.EngineSpec

    def paged(q, kb, vb, kp, rows, qp, *, window=0):
        paged.launches += 1
        return paged_decode_attention_ref(q, kb, vb, kp, rows, qp,
                                          window=window)
    paged.launches = 0
    monkeypatch.setattr(C, "get_config", tiny)
    monkeypatch.setattr(cs, "CP_TOKENS", 256)
    monkeypatch.setattr(api, "EngineSpec",
                        lambda **kw: spec_cls(**{**kw, "device": "cpu"}))
    monkeypatch.setattr(cs, "cuda_ms", lambda fn, iters=20, warmup=3:
                        (fn(), 1.0)[1])
    monkeypatch.setattr(cs, "device_ms", lambda fn, iters=20, warmup=3,
                        windows=3: (fn(), 1.0)[1])
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(dops, "paged_decode_attention", paged)
    cfg = tiny("llama3-8b")
    params = TM.init_params(cfg, torch.Generator().manual_seed(0))
    with torch.no_grad():
        out_c, tr_c, tok_c, plan_c, _ = cs.run_engine(
            "C", cfg, params, str(tmp_path), attn_impl="dense")
        _o, tr_b, tok_b, _p, _ = cs.run_engine(
            "B", cfg, params, str(tmp_path), attn_impl="paged_kernel",
            paged_decode=True)
        pi = cs.paged_inputs(np.random.default_rng(0), CPU, H=4, Hkv=4,
                             D=32)
        mesh = cs.run_mesh(cfg, params, CPU, str(tmp_path),
                           (out_c, tr_c, tok_c, plan_c), pi, tr_b, tok_b)
        assert AB.serving_mesh() is None
        cp_ef = cs.run_cp_ef(CPU)
    assert mesh["C"]["bit_equal"] and mesh["C_paged"]["bit_equal"]
    assert mesh["B"]["launches"] == mesh["B"]["expected"] > 0
    assert mesh["B"]["bit_equal_B"]
    for dt in ("float32", "bfloat16"):
        assert mesh["kernel"][dt]["gathered_bit_equal"]
    assert cp_ef["flash_cp"]["logits"] <= cs.CP_TOL
    assert cp_ef["ef_allreduce"]["drift"] < 0.02
