"""The recurrent blocks split over the model axis in the port's
tensor-parallel step (``models/model.py`` ``_rglru_tp`` / ``_ssd_tp``), as
the reference's rules and activation constraints partition them
(``"rnn"`` and ``"ssm_heads"`` on "model"): each block on 2 and 4 shards
against the unsharded block, forward and backward, with its counted
collective bytes against their closed form; the SSD block's gated norm
with shards whose channels differ in scale by orders of magnitude; the
plan's routes on the production and debug meshes; and the all-gather
bytes of a whole step, which fall to the kv weights alone.

The whole train step on (2, 2) and (1, 4) is held against the unsharded
one in ``tests/test_torch_tp_training.py`` and on (2, 4) against the
reference's jitted step in ``tests/test_torch_sharded_training.py``. This
file imports neither jax nor the reference package.

Tolerances: those of ``tests/test_torch_tp_training.py``: the split
blocks sum their fp32 partial products in another order, so outputs and
gradients are held at ``PARAM_TOL`` (rtol 2e-4, atol 1e-4); byte counts
are exact.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, get_tiny
from repro_torch.distributed import collectives as CO
from repro_torch.distributed import sharding as SH
from repro_torch.launch import dryrun as DR
from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh
from repro_torch.models import model as TM
from repro_torch.training import steps as TS
from repro_torch.training.optimizer import AdamWConfig, tree_leaves

torch.set_num_threads(2)
PARAM_TOL = dict(rtol=2e-4, atol=1e-4)
B, S = 2, 32
ARCHS = {"rglru": "recurrentgemma-9b", "ssd": "mamba2-370m"}
BLOCK = {"rglru": TM._rglru_block, "ssd": TM._ssd_block}
# the leaves each block splits over the model axis
LEAVES = {"rglru": ("wx", "wy", "conv", "lam", "alpha", "beta", "wo_r"),
          "ssd": ("conv", "A_log", "D", "dt_bias", "out_norm", "out_proj")}


def _layer(kind, seed=0):
    """The tiny config and the first layer of ``kind``'s leaves, detached
    fp32 copies that take gradients."""
    cfg = get_tiny(ARCHS[kind])
    gen = torch.Generator().manual_seed(seed)
    params = TM.init_params(cfg, gen)
    pi = cfg.pattern.index(kind)
    p = {n: x[0].detach().clone().requires_grad_(True)
         for n, x in params["groups"][pi].items()}
    # the zero-initialised norm scale and biases nonzero, so that their
    # gradients and the shards' slices of them matter
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for n in ("out_norm", "dt_bias"):
            if n in p:
                p[n].copy_(torch.from_numpy(
                    rng.normal(0, 0.5, p[n].shape).astype(np.float32)))
    return cfg, p


def _split(p, kind, n):
    """``p`` with the block's leaves cut into ``n`` blocks on their
    Megatron dimension (``sharding.Blocks``, each block a leaf of its
    own)."""
    out = dict(p)
    for name in LEAVES[kind]:
        dim = SH.MEGATRON_DIMS[name]
        out[name] = SH.Blocks(
            [t.detach().clone().requires_grad_(True)
             for t in torch.tensor_split(p[name].detach(), n, dim)],
            dim, "split")
    return out


def _x(cfg, seed=1):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(size=(B, S, cfg.d_model)).astype(
        np.float32)).requires_grad_(True)


def _ctx(cfg, mode="train"):
    return TM.Ctx(cfg=cfg, mode=mode, positions=torch.arange(
        S, dtype=torch.int32).expand(B, S))


def _run(kind, cfg, p, x, w):
    """The block's output and, from the loss sum(out * w), the gradients
    of ``x`` and of every leaf of ``p`` (a split leaf's blocks put
    together); the collective bytes counted forward and backward."""
    CO.reset_bytes()
    out = BLOCK[kind](_ctx(cfg), p, x, None)[0]
    fwd = dict(CO.BYTES)
    names = sorted(n for n in p if n in LEAVES[kind] or n == "in_proj")
    leaves = [x] + [t for n in names for t in (
        p[n].parts if isinstance(p[n], SH.Blocks) else [p[n]])]
    grads = iter(torch.autograd.grad((out * w).sum(), leaves))
    gx = next(grads)
    gp = {}
    for n in names:
        if isinstance(p[n], SH.Blocks):
            gp[n] = torch.cat([next(grads) for _ in p[n].parts],
                              p[n].dim)
        else:
            gp[n] = next(grads)
    bwd = {k: CO.BYTES[k] - fwd[k] for k in fwd}
    return out.detach(), gx, gp, fwd, bwd


def _closed(kind, cfg):
    """(forward, backward) all-reduce bytes of one split block on B x S
    tokens, as ``dryrun.tp_collective_bytes`` counts them: the output's
    sum (T d 4) and, for the SSD block, its norm statistic (T 4); the
    grads of the input's copies (T d 4; the SSD block's in-projection,
    T in_w 4) and of the statistic."""
    T, d = B * S, cfg.d_model
    if kind == "rglru":
        return T * d * 4, T * d * 4
    in_w = 2 * cfg.d_inner + 2 * cfg.ssm_state + cfg.ssm_heads
    return T * d * 4 + T * 4, T * in_w * 4 + T * 4


def _assert_close(got, want, what):
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(),
                               **PARAM_TOL, err_msg=what)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("kind", ["rglru", "ssd"])
def test_split_block_matches_unsharded(kind, n):
    """The block on ``n`` model shards == the unsharded block: output,
    the input's gradient and every leaf's (the split leaves' blocks put
    together, the SSD block's whole ``in_proj``), and the counted
    all-reduce bytes, forward and backward, equal to the closed form
    with nothing all-gathered."""
    cfg, p = _layer(kind)
    x = _x(cfg)
    w = torch.from_numpy(np.random.default_rng(2).normal(
        size=(B, S, cfg.d_model)).astype(np.float32))
    want, gx_w, gp_w, f0, b0 = _run(kind, cfg, p, x, w)
    assert set(f0.values()) == set(b0.values()) == {0}
    got, gx, gp, fwd, bwd = _run(kind, cfg, _split(p, kind, n), x, w)
    _assert_close(got, want, "output")
    _assert_close(gx, gx_w, "grad of x")
    assert set(gp) == set(gp_w)
    for name in gp:
        _assert_close(gp[name], gp_w[name], f"grad of {name}")
    f, b = _closed(kind, cfg)
    assert fwd == {"all-gather": 0, "all-reduce": f, "reduce-scatter": 0}
    assert bwd == {"all-gather": 0, "all-reduce": b, "reduce-scatter": 0}


@pytest.mark.parametrize("kind", ["rglru", "ssd"])
def test_split_block_is_the_same_function_in_float64(monkeypatch, kind):
    """In float64 throughout (the blocks' fp32 casts patched to keep
    float64) the block on 4 shards and the whole block agree to 1e-12 of
    each output's and gradient's largest magnitude: the split computes
    the same function, and what it changes in fp32 is the order of its
    sums."""
    f32 = torch.Tensor.float
    monkeypatch.setattr(torch.Tensor, "float", lambda t: t if t.dtype ==
                        torch.float64 else f32(t))
    zeros = torch.zeros
    monkeypatch.setattr(torch, "zeros", lambda *a, **k: zeros(*a, **dict(
        k, dtype=torch.float64 if k.get("dtype") == torch.float32
        else k.get("dtype"))))
    cfg, p = _layer(kind)
    p = {n: t.detach().double().requires_grad_(True) for n, t in p.items()}
    x = _x(cfg).detach().double().requires_grad_(True)
    w = torch.from_numpy(np.random.default_rng(2).normal(
        size=(B, S, cfg.d_model)))
    want, gx_w, gp_w, _, _ = _run(kind, cfg, p, x, w)
    got, gx, gp, _, _ = _run(kind, cfg, _split(p, kind, 4), x, w)
    assert want.dtype == torch.float64
    for what, a, b in [("output", got, want), ("grad of x", gx, gx_w)] + [
            (f"grad of {n}", gp[n], gp_w[n]) for n in gp_w]:
        assert float((a - b).abs().max()) <= 1e-12 * float(
            b.abs().max()), what


@pytest.mark.parametrize("n", [2, 4])
def test_split_ssd_grad_free_forward(n):
    """The SSD block split over ``n`` shards outside training (no grad,
    ``train=False``: the intra-chunk term through the kernel's wrapper,
    its plain version on CPU tensors) == the unsharded block, counting
    the forward's bytes alone."""
    cfg, p = _layer("ssd")
    x = _x(cfg).detach()
    ctx = _ctx(cfg, mode="prefill")
    with torch.no_grad():
        want = TM._ssd_block(ctx, p, x, None)[0]
        CO.reset_bytes()
        got = TM._ssd_block(ctx, _split(p, "ssd", n), x, None)[0]
    _assert_close(got, want, "output")
    assert CO.BYTES == {"all-gather": 0, "all-reduce": _closed("ssd", cfg)[0],
                        "reduce-scatter": 0}


@pytest.mark.parametrize("n", [2, 4])
def test_split_ssd_norm_spans_all_channels(monkeypatch, n):
    """Shards whose channels differ in scale by orders of magnitude (each
    shard's conv weights scaled by 100^m): the split block still equals
    the unsharded one, forward and backward, while the same block with
    each shard's own sum of squares (a per-shard norm), or with the sum
    divided by the shard's width, does not."""
    cfg, p = _layer("ssd")
    with torch.no_grad():
        w = cfg.d_inner // n
        for m in range(n):
            p["conv"][:, m * w:(m + 1) * w] *= 100.0 ** m
    x = _x(cfg)
    g = torch.from_numpy(np.random.default_rng(3).normal(
        size=(B, S, cfg.d_model)).astype(np.float32))
    want, gx_w, gp_w, _, _ = _run("ssd", cfg, p, x, g)
    got, gx, gp, _, _ = _run("ssd", cfg, _split(p, "ssd", n), x, g)
    _assert_close(got, want, "output")
    _assert_close(gx, gx_w, "grad of x")
    for name in gp:
        _assert_close(gp[name], gp_w[name], f"grad of {name}")
    mutants = {"per-shard norm": lambda parts: list(parts),
               "the shard's width": lambda parts: [CO.psum(parts) * n] * n}
    for what, fn in mutants.items():
        monkeypatch.setattr(CO, "sum_over_model", fn)
        bad = _run("ssd", cfg, _split(p, "ssd", n), x, g)[0]
        assert not np.allclose(bad.numpy(), want.numpy(), **PARAM_TOL), what


@pytest.mark.parametrize("kind", ["rglru", "ssd"])
def test_split_block_with_a_cache_matches_whole(kind):
    """Given a cache, the block on 2 and 4 model shards, each reading and
    writing its channels (and the SSD block's heads) of the state, ==
    the whole block on the same cache: a prefill from an empty cache, a
    partial pass from its state and 2 decode steps after it, outputs and
    every cache leaf within ``PARAM_TOL``, no grad."""
    cfg, p = _layer(kind)
    pi = cfg.pattern.index(kind)
    x = _x(cfg).detach()
    rng = np.random.default_rng(4)

    def ctx(mode, T, p0):
        pos = torch.arange(p0, p0 + T, dtype=torch.int32).expand(B, T)
        return TM.Ctx(cfg=cfg, mode=mode, positions=pos,
                      decode_slot=pos[:, 0] if mode == "decode" else None)
    passes = [("prefill", x, 0), ("partial", x[:, :8], S)] + [
        ("decode", torch.from_numpy(rng.normal(size=(B, 1, cfg.d_model))
                                    .astype(np.float32)), S + 8 + i)
        for i in range(2)]
    with torch.no_grad():
        cache = TM.init_cache(cfg, B, S, device="cpu")
        want_st = {k: v[0].clone() for k, v in cache["groups"][pi].items()}
        states = {n: {k: v.clone() for k, v in want_st.items()}
                  for n in (2, 4)}
        for mode, h, p0 in passes:
            want = BLOCK[kind](ctx(mode, h.shape[1], p0), p, h, want_st)[0]
            for n, st in states.items():
                got = BLOCK[kind](ctx(mode, h.shape[1], p0),
                                  _split(p, kind, n), h, st)[0]
                _assert_close(got, want, f"{mode} on {n}: output")
                for k in want_st:
                    _assert_close(st[k], want_st[k], f"{mode} on {n}: {k}")


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "mamba2-370m"])
def test_tp_plan_splits_every_recurrent_leaf(arch):
    """On the production (16, 16) mesh and the (2, 2), (1, 4) and (2, 4)
    debug meshes, full and tiny: every leaf of an ``rglru`` or ``ssd``
    layer that the rules put on "model" routes ``"split"`` on its
    Megatron dimension, none ``"gather"``; ``in_proj`` stays whole."""
    for cfg in (get_config(arch), get_tiny(arch)):
        meshes = [make_production_mesh(device="cpu")] + [
            make_debug_mesh(s, device="cpu")
            for s in ((2, 2), (1, 4), (2, 4))]
        for mesh in meshes:
            plan = SH.tp_plan(mesh, cfg, TM.param_axes(cfg))
            layers = [(k, lay) for k, lay in zip(cfg.pattern,
                                                 plan["groups"])]
            kinds = cfg.layer_kinds[cfg.n_groups * len(cfg.pattern):]
            layers += list(zip(kinds, plan["tail"]))
            seen = 0
            for kind, lay in layers:
                if kind not in LEAVES:
                    continue
                for name in LEAVES[kind]:
                    r = lay[name]
                    assert r == SH.TPLeaf("split", SH.MEGATRON_DIMS[name]), \
                        (mesh.shape, kind, name, r)
                    seen += 1
                if kind == "ssd":
                    assert lay["in_proj"] is None
            assert seen > 0


def test_tp_step_gathers_only_kv_weights():
    """One step of tiny recurrentgemma-9b cut to 3 layers (rglru, rglru,
    local) on (data 2, model 4), 4 x 64 tokens, accum 2: the all-gather
    bytes counted beyond ZeRO-1's are the local layer's kv weights (cut
    on the head dim: 1 kv head does not divide 4), twice under remat, per
    microbatch; everything counted equals the closed forms."""
    cfg = get_tiny("recurrentgemma-9b").replace(num_layers=3)
    mesh = make_debug_mesh((2, 4), device="cpu")
    shs = TS.train_shardings(cfg, mesh)
    gen = torch.Generator().manual_seed(0)
    st = TS.shard_state(TS.init_train_state(cfg, gen), shs)
    step = TS.make_train_step(cfg, AdamWConfig(), 2,
                              grad_specs=shs["opt"]["m"])
    rng = np.random.default_rng(0)
    t = rng.integers(0, cfg.vocab_size, (4, 65)).astype(np.int32)
    CO.reset_bytes()
    step(st, {"tokens": torch.from_numpy(t[:, :-1].copy()),
              "labels": torch.from_numpy(t[:, 1:].copy())})
    z = DR.zero1_collective_bytes(cfg, mesh, 2)
    tp = DR.tp_collective_bytes(cfg, mesh, 2, 4, 64)
    assert CO.BYTES == {k: z[k] + tp[k] for k in z}
    local = TM.init_params(cfg, gen, device="meta")["groups"][
        cfg.pattern.index("local")]
    kv = sum(local[n][0].numel() * 4 for n in ("wk", "wv"))
    assert CO.BYTES["all-gather"] - z["all-gather"] == 2 * 2 * kv
    plan = SH.tp_plan(mesh, cfg, TM.param_axes(cfg))
    gathered = [n for lay in plan["groups"] for n, r in lay.items()
                if r is not None and r.route == "gather"]
    assert sorted(gathered) == ["wk", "wv"]
    assert all(r is None or r.route == "split"
               for r in tree_leaves(plan["groups"][0]))
