"""The port's tensor-parallel train step against its own unsharded step:
the differentiable collectives over the model axis
(``distributed/collectives.py``), the execution plan
(``sharding.tp_plan``), ``make_train_step(..., grad_specs=...)`` on
(data, model) meshes for every tiny config, the MoE aux loss from global
batch means over data shards, and the dry-run's closed form of the
step's collectives (``dryrun.tp_collective_bytes``) against the bytes
``collectives.BYTES`` counts. The reference's jitted tensor-parallel
step is held against the port in ``tests/test_torch_sharded_training.py``.

This file imports neither jax nor the reference package, so its
``cuda``-marked twins run on a GPU host:

    PYTHONPATH=src python -m pytest --noconftest -m cuda \\
        tests/test_torch_tp_training.py

Tolerances: tensor parallelism sums the fp32 partial products in another
order, so each loss is held at ``LOSS_RTOL`` (1e-5) and the params, ``m``
and ``v`` after 3 free-running steps at ``PARAM_TOL`` (rtol 2e-4, atol
1e-4), as the data-parallel step is. One allowance, for the params only
(``assert_params_or_flips``): AdamW's step m / (sqrt(v) + eps) changes
sign with a grad at its rounding noise, so an element may lie outside
PARAM_TOL where the second moments of both runs say its grads stayed at
that scale (sqrt(v / bc2) < ``FLIP_GRAD``), and then by at most twice
the summed lr, the most a changed sign can move it. Byte counts are
exact.
"""
import numpy as np
import pytest
import torch

from repro_torch import device as devmod
from repro_torch.configs import ARCHS, get_config, get_tiny
from repro_torch.distributed import collectives as CO
from repro_torch.distributed import sharding as SH
from repro_torch.launch import dryrun as DR
from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models.config import SHAPES
from repro_torch.training import steps as TS
from repro_torch.training.optimizer import (AdamWConfig, tree_leaves,
                                            tree_unflatten)

torch.set_num_threads(2)
CPU = torch.device("cpu")
LOSS_RTOL = 1e-5
PARAM_TOL = dict(rtol=2e-4, atol=1e-4)
FLIP_GRAD = 1e-6
OPT = dict(peak_lr=1e-3, warmup_steps=2, total_steps=20)
B, S, STEPS, ACCUM = 8, 32, 3, 2
# the reference test's config (tests/test_distributed.py:55): every head
# count divides the model axis of 4
MESH_CFG = dict(num_heads=4, num_kv_heads=4)
# heads of 2 do not divide 4: wq / wo cut on the head dim, all-gathered,
# attention replicated
REPLICATED_ATTN = dict(num_heads=2, num_kv_heads=2)
MOE_ARCHS = ("granite-moe-1b-a400m", "phi3.5-moe-42b-a6.6b")
# 0.5: C = 32 slots an expert in the 128-token groups, about half the
# tokens that pick it
MOE_CF = 0.5


def _tiny(arch, **kw):
    """2 layers (5 for the vision model, so that its group holds the
    cross-attention layer)."""
    cfg = get_tiny(arch)
    n = len(cfg.pattern) if "xattn" in cfg.pattern else 2
    return cfg.replace(num_layers=n, **kw)


def _batches(cfg, n=STEPS, seed=0, device=CPU):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        t = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
        b = {"labels": t[:, 1:].copy()}
        if cfg.input_mode == "embeds":
            b["embeds"] = rng.normal(size=(B, S, cfg.d_model)).astype(
                np.float32)
        else:
            b["tokens"] = t[:, :-1].copy()
        if cfg.num_media_tokens:
            b["media"] = rng.normal(size=(B, cfg.num_media_tokens,
                                          cfg.d_model)).astype(np.float32)
        out.append({k: torch.from_numpy(v).to(device) for k, v in b.items()})
    return out


def _state(cfg, device=CPU, seed=0):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return TS.init_train_state(cfg, gen)


def assert_params_or_flips(got, want, got_v, want_v, lr_sum, steps):
    """Leaf lists of params within PARAM_TOL but for AdamW's sign flips
    (module docstring); ``got_v`` / ``want_v`` the runs' second moments
    after ``steps`` steps."""
    bc2 = 1 - AdamWConfig().b2 ** steps
    for i, (g, w, gv, wv) in enumerate(zip(got, want, got_v, want_v,
                                           strict=True)):
        g, w = g.detach().cpu().float(), w.detach().cpu().float()
        bad = ~torch.isclose(g, w, **PARAM_TOL)
        if not bad.any():
            continue
        rms = torch.sqrt(torch.maximum(gv.detach().cpu(), wv.detach().cpu())
                         / bc2)[bad]
        gap = (g - w).abs()[bad]
        assert (rms < FLIP_GRAD).all() and (gap <= 2 * lr_sum).all(), (
            f"leaf {i}: {int(bad.sum())} of {g.numel()} outside {PARAM_TOL},"
            f" gaps {gap[:4].tolist()}, grad rms {rms[:4].tolist()}")


def _assert_close(got, want):
    for i, (g, w) in enumerate(zip(got, want, strict=True)):
        np.testing.assert_allclose(g.detach().cpu().numpy(),
                                   w.detach().cpu().numpy(), **PARAM_TOL,
                                   err_msg=f"leaf {i}")


def _run_pair(cfg, shape, device=CPU, accum=ACCUM):
    """STEPS steps unsharded and sharded over a ``shape`` (data, model)
    mesh from one init; asserts the losses, params, ``m`` and ``v``, the
    step counts and the counted bytes against the closed forms. Returns
    both runs' metrics."""
    opt = AdamWConfig(**OPT)
    mesh = make_debug_mesh(shape, device=device)
    shs = TS.train_shardings(cfg, mesh)
    ref, step = _state(cfg, device), TS.make_train_step(cfg, opt, accum)
    sst = TS.shard_state(_state(cfg, device), shs)
    sstep = TS.make_train_step(cfg, opt, accum, grad_specs=shs["opt"]["m"])
    CO.reset_bytes()
    m_ref, m_sh = [], []
    for b in _batches(cfg, device=device):
        ref, a = step(ref, b)
        sst, c = sstep(sst, b)
        m_ref.append(a)
        m_sh.append(c)
        np.testing.assert_allclose(float(c["loss"]), float(a["loss"]),
                                   rtol=LOSS_RTOL)
    z = DR.zero1_collective_bytes(cfg, mesh, accum)
    t = DR.tp_collective_bytes(cfg, mesh, accum, B, S)
    assert CO.BYTES == {k: STEPS * (z[k] + t[k]) for k in z}
    un = TS.unshard_state(sst)
    assert_params_or_flips(list(tree_leaves(un.params)),
                           list(tree_leaves(ref.params)),
                           list(tree_leaves(un.opt["v"])),
                           list(tree_leaves(ref.opt["v"])),
                           sum(float(a["lr"]) for a in m_ref), STEPS)
    for k in ("m", "v"):
        _assert_close(list(tree_leaves(un.opt[k])),
                      list(tree_leaves(ref.opt[k])))
    assert int(un.step) == int(ref.step) == STEPS
    assert int(un.opt["count"]) == STEPS
    return m_ref, m_sh


# ---------------- the collectives over the model axis ------------------------
def _parts(n=3, shape=(4, 5), seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=shape).astype(np.float32))
            .requires_grad_(True) for _ in range(n)]


def test_copy_to_model_forward_backward_and_bytes():
    """Every shard gets ``x`` itself; backward sums their grads in shard
    order, counted as one all-reduce of ``x``'s bytes."""
    x, = _parts(1)
    ws = _parts(3, seed=1)
    CO.reset_bytes()
    xs = CO.copy_to_model(x, 3)
    assert all(torch.equal(a, x) for a in xs)
    assert set(CO.BYTES.values()) == {0}
    loss = sum((a * w).sum() for a, w in zip(xs, ws))
    g, = torch.autograd.grad(loss, [x])
    assert torch.equal(g, ws[0].detach() + ws[1].detach() + ws[2].detach())
    assert CO.BYTES == {"all-gather": 0, "all-reduce": 4 * 5 * 4,
                        "reduce-scatter": 0}


def test_reduce_from_model_forward_backward_and_bytes():
    """The psum of the parts in shard order, one all-reduce of the sum's
    bytes; backward hands each part the incoming grad, moving nothing."""
    ps = _parts(3)
    CO.reset_bytes()
    y = CO.reduce_from_model(ps)
    assert torch.equal(y, ps[0] + ps[1] + ps[2])
    assert CO.BYTES["all-reduce"] == 4 * 5 * 4
    w = torch.arange(20, dtype=torch.float32).reshape(4, 5)
    gs = torch.autograd.grad((y * w).sum(), ps)
    assert all(torch.equal(g, w) for g in gs)
    assert CO.BYTES == {"all-gather": 0, "all-reduce": 4 * 5 * 4,
                        "reduce-scatter": 0}


def test_gather_over_model_forward_backward_and_bytes():
    """Blocks of uneven sizes concatenated (one all-gather of the whole
    tensor's bytes); backward gives each block its slice, moving
    nothing."""
    rng = np.random.default_rng(2)
    bs = [torch.from_numpy(rng.normal(size=(4, n)).astype(np.float32))
          .requires_grad_(True) for n in (3, 3, 2)]
    CO.reset_bytes()
    y = CO.gather_over_model(bs, 1)
    assert torch.equal(y, torch.cat(bs, 1))
    w = torch.from_numpy(rng.normal(size=(4, 8)).astype(np.float32))
    gs = torch.autograd.grad((y * w).sum(), bs)
    assert [torch.equal(g, s) for g, s in zip(gs, w.split([3, 3, 2], 1))] \
        == [True] * 3
    assert CO.BYTES == {"all-gather": 4 * 8 * 4, "all-reduce": 0,
                        "reduce-scatter": 0}


def test_one_shard_and_uncounted_collectives_count_nothing():
    """Over one shard each collective is the identity and moves nothing;
    under ``counting(False)`` nothing counts, forward or backward, and
    the counts go on afterwards."""
    x, = _parts(1)
    CO.reset_bytes()
    assert CO.copy_to_model(x, 1)[0] is x
    assert CO.reduce_from_model([x]) is x
    assert CO.gather_over_model([x], 0) is x
    with CO.counting(False):
        y = CO.reduce_from_model(CO.copy_to_model(x, 2))
        torch.autograd.grad(y.sum(), [x])
        CO.pmax([x.detach(), x.detach()])
    assert set(CO.BYTES.values()) == {0}
    CO.pmax([x.detach(), -x.detach()])
    assert CO.BYTES["all-reduce"] == 4 * 5 * 4


# ---------------- the execution plan ------------------------------------------
@pytest.mark.parametrize("arch", ARCHS + ("llama3-8b",))
def test_tp_plan_routes(arch):
    """On the production (16, 16) mesh and the debug meshes, every leaf
    the rules split over "model" has a route on the dimension they split,
    ``"split"`` only on its Megatron dimension, kv split only with q
    split; the tiny and full configs both plan."""
    for cfg in (get_config(arch), get_tiny(arch)):
        meshes = [make_production_mesh(device="cpu")] + [
            make_debug_mesh(s, device="cpu") for s in ((2, 2), (1, 4))]
        for mesh in meshes:
            plan = SH.tp_plan(mesh, cfg, TM.param_axes(cfg))
            shs = TS.train_shardings(cfg, mesh)["params"]

            def check(route, sh, name, lead):
                dims = [i - lead for i, e in enumerate(sh.spec)
                        if e == "model"]
                if not dims:
                    assert route is None, name
                    return
                assert route.dim == dims[0], name
                assert (route.route == "split") <= \
                    (SH.MEGATRON_DIMS.get(name) == route.dim), name
            for n in ("embed", "unembed", "final_norm"):
                check(plan[n], shs[n], n, 0)
            assert plan["unembed"].route == "split"
            for key, lead in (("groups", 1), ("tail", 0)):
                for lay, sh in zip(plan[key], shs[key]):
                    for n, r in lay.items():
                        check(r, sh[n], n, lead)
                    if lay.get("wk") and lay["wk"].route == "split":
                        assert lay["wq"].route == "split"


# ---------------- the tensor-parallel step ------------------------------------
TP_CASES = [(a, s, None) for a in ARCHS for s in ((2, 2), (1, 4))] + [
    ("llama3-8b", (2, 4), None), ("llama3-8b", (2, 4), "MESH_CFG"),
    ("llama3-8b", (2, 4), "REPLICATED_ATTN")]
_KW = {None: {}, "MESH_CFG": MESH_CFG, "REPLICATED_ATTN": REPLICATED_ATTN}


@pytest.mark.parametrize("arch,shape,kw", TP_CASES)
def test_tp_step_matches_unsharded(arch, shape, kw):
    """3 steps on a (data, model) mesh == 3 unsharded steps from one init
    (``_run_pair``), with the counted bytes equal to the closed forms. On
    (2, 4) tiny llama3-8b's 4 q heads split and its 2 kv heads are
    all-gathered (each shard attends its q head to its group's kv head),
    with MESH_CFG every head count splits, with REPLICATED_ATTN the
    heads do not divide and the attention runs replicated."""
    cfg = _tiny(arch, **_KW[kw])
    if cfg.num_experts:
        cfg = cfg.replace(capacity_factor=MOE_CF)
    _run_pair(cfg, shape)


@pytest.fixture
def moe_dispatch(monkeypatch):
    """Records the tokens every ``moe_slots`` call drops, and whether a
    data shard's tokens cut a GShard group (``moe_groups`` giving gs <
    g, which only a data shard of a larger microbatch sees)."""
    rec = {"dropped": 0, "cut": 0}
    slots, groups = TL.moe_slots, TL.moe_groups

    def moe_slots(gate_idx, C, E):
        slot, kept = slots(gate_idx, C, E)
        rec["dropped"] += int((~kept).sum())
        return slot, kept

    def moe_groups(T, group_size=512, total=None):
        g, gs = groups(T, group_size, total)
        rec["cut"] += gs < g
        return g, gs
    monkeypatch.setattr(TL, "moe_slots", moe_slots)
    monkeypatch.setattr(TL, "moe_groups", moe_groups)
    return rec


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("dp", [2, 4])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_data_parallel_matches_unsharded(moe_dispatch, arch, dp,
                                             accum):
    """The MoE configs data-parallel over (dp, 1): the shards' rows cut
    the microbatch's 128-token GShard group, whose capacity the shards
    fill in order, tokens drop, and the aux term takes the global ``fe``: the
    step matches the unsharded one (``_run_pair``), and reports ``aux``
    as it does (the value at accum 1, 0 above)."""
    cfg = _tiny(arch, capacity_factor=MOE_CF)
    m_ref, m_sh = _run_pair(cfg, (dp, 1), accum=accum)
    assert moe_dispatch["cut"] and moe_dispatch["dropped"]
    for a, c in zip(m_ref, m_sh):
        if accum == 1:
            np.testing.assert_allclose(float(c["aux"]),
                                       float(a["aux"].detach()),
                                       rtol=LOSS_RTOL)
            assert float(c["aux"]) > 0
        else:
            assert c["aux"] == a["aux"] == 0.0


@pytest.mark.parametrize("dp", [2, 4])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_whole_groups_run_each_shard_forward(monkeypatch, moe_dispatch,
                                                 arch, dp):
    """GShard groups of 32 tokens, on both sides: every group of the
    128-token microbatch lies within one data shard, so each shard runs
    its own forward (``run_stack_lockstep`` is not called), tokens drop,
    and the step matches the unsharded one (``_run_pair``)."""
    groups = TL.moe_groups
    monkeypatch.setattr(TL, "moe_groups",
                        lambda T, group_size=512, total=None:
                        groups(T, 32, total))

    def lockstep(*a, **kw):
        raise AssertionError("the shards cut no group")
    monkeypatch.setattr(TM, "run_stack_lockstep", lockstep)
    _run_pair(_tiny(arch, capacity_factor=MOE_CF), (dp, 1))
    assert not moe_dispatch["cut"] and moe_dispatch["dropped"]


@pytest.mark.parametrize("arch", ["llama3-8b", "granite-moe-1b-a400m"])
def test_tp_bytes_without_remat(arch):
    """Without remat each forward collective counts once: the counters
    still equal the closed forms, and fall below the remat run's."""
    cfg = _tiny(arch, capacity_factor=MOE_CF)
    mesh = make_debug_mesh((2, 2), device="cpu")
    counts = {}
    for remat in (True, False):
        c = cfg.replace(remat=remat)
        shs = TS.train_shardings(c, mesh)
        st = TS.shard_state(_state(c), shs)
        step = TS.make_train_step(c, AdamWConfig(**OPT), ACCUM,
                                  grad_specs=shs["opt"]["m"])
        CO.reset_bytes()
        step(st, _batches(c, n=1)[0])
        z = DR.zero1_collective_bytes(c, mesh, ACCUM)
        t = DR.tp_collective_bytes(c, mesh, ACCUM, B, S)
        assert CO.BYTES == {k: z[k] + t[k] for k in z}
        counts[remat] = sum(CO.BYTES.values())
    assert counts[False] < counts[True]


def _tp_params(cfg, mesh, d=0):
    """Data shard ``d``'s view of a fresh state on ``mesh``: tensors, and
    ``Blocks`` for the leaves ``tp_plan`` splits over "model"."""
    st = TS.shard_state(_state(cfg), TS.train_shardings(cfg, mesh))
    routes = list(tree_leaves(SH.tp_plan(mesh, cfg, TM.param_axes(cfg))))
    return tree_unflatten(st.params, [
        x.shards[d, 0] if r is None else SH.Blocks(
            [x.shards[d, m] for m in range(mesh.shape["model"])], r.dim,
            r.route)
        for x, r in zip(tree_leaves(st.params), routes)]), st


@pytest.mark.parametrize("arch", ["llama3-8b", "gemma3-4b",
                                  "recurrentgemma-9b", "granite-moe-1b-a400m",
                                  "llama-3.2-vision-90b", "mamba2-370m"])
def test_tp_forward_bytes_equal_closed_form(arch):
    """A forward alone under the plan (``train=False``, what the dry-run
    reports for serving cells) counts the closed form's bytes, and gives
    the unsharded forward's hidden states (within 1e-5 of their largest
    magnitude: the random tiny stacks grow them to O(100))."""
    cfg = _tiny(arch)
    mesh = make_debug_mesh((1, 4), device="cpu")
    params, st = _tp_params(cfg, mesh)
    b = _batches(cfg, n=1)[0]
    whole = TS.unshard_state(st).params
    with torch.no_grad():
        CO.reset_bytes()
        out = TM.forward(cfg, params, tokens=b.get("tokens"),
                         embeds=b.get("embeds"), media=b.get("media"))
        counted = dict(CO.BYTES)
        want = TM.forward(cfg, whole, tokens=b.get("tokens"),
                          embeds=b.get("embeds"), media=b.get("media"))
    assert out.logits is None
    assert counted == DR.tp_collective_bytes(cfg, mesh, 1, B, S,
                                             train=False)
    w = want.hidden.numpy()
    np.testing.assert_allclose(out.hidden.numpy(), w, rtol=1e-5,
                               atol=1e-5 * np.abs(w).max())


@pytest.mark.parametrize("arch", ARCHS)
def test_dryrun_cells_report_tp_bytes(arch):
    """Every dry-run cell of ``arch`` on both production meshes reports
    its tensor-parallel bytes: a number per collective kind, the train
    cells' above zero."""
    cfg = get_config(arch).replace(dtype="bfloat16", param_dtype="bfloat16")
    for multi in (False, True):
        mesh = DR.meta_mesh(make_production_mesh(multi_pod=multi,
                                                 device="cpu"))
        for name, sp in SHAPES.items():
            train = sp["kind"] == "train"
            t = DR.tp_collective_bytes(
                cfg, mesh, DR.TRAIN_ACCUM if train else 1,
                sp["global_batch"], sp["seq_len"] if train else 1,
                train=train, dp=None if train else 1)
            assert set(t) == {"all-gather", "all-reduce", "reduce-scatter"}
            assert all(isinstance(v, int) and v >= 0 for v in t.values())
            assert sum(t.values()) > 0 or not train


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_dryrun_moe_train_cell_counts(arch):
    """The dry-run's train cell of a config with experts counts its step
    on meta (at no layer group too, where the aux term is the number
    0.0) and records the tensor-parallel bytes of ``cell_tp_bytes``."""
    rec = DR.run_cell(arch, "train_4k", "single")
    assert rec["status"] == "ok", rec.get("traceback")
    cfg = get_config(arch).replace(dtype="bfloat16", param_dtype="bfloat16")
    mesh = DR.meta_mesh(make_production_mesh(device="cpu"))
    sp = SHAPES["train_4k"]
    assert rec["counted"]["coll_bytes_tensor_parallel"] == DR.cell_tp_bytes(
        cfg, "train", sp["global_batch"], sp["seq_len"], mesh)
    assert rec["counted"]["flops_total"] > 0


# ---------------- the same on the card ----------------------------------------
def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (runs the step on cuda:0)")
    return devmod.resolve("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("arch,shape,kw", [
    ("llama3-8b", (2, 4), None), ("llama3-8b", (2, 4), "REPLICATED_ATTN"),
    ("recurrentgemma-9b", (2, 2), None), ("mamba2-370m", (1, 4), None),
    ("granite-moe-1b-a400m", (2, 2), None),
    ("llama-3.2-vision-90b", (2, 2), None)])
def test_tp_step_matches_unsharded_cuda(arch, shape, kw):
    """``test_tp_step_matches_unsharded`` with every shard on cuda:0."""
    dev = _need_cuda()
    cfg = _tiny(arch, **_KW[kw])
    if cfg.num_experts:
        cfg = cfg.replace(capacity_factor=MOE_CF)
    _run_pair(cfg, shape, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("dp", [2, 4])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_data_parallel_matches_unsharded_cuda(moe_dispatch, arch, dp):
    """``test_moe_data_parallel_matches_unsharded`` on cuda:0."""
    dev = _need_cuda()
    _run_pair(_tiny(arch, capacity_factor=MOE_CF), (dp, 1), device=dev)
    assert moe_dispatch["cut"] and moe_dispatch["dropped"]
