"""The tensor-parallel train step held to the parity standard where fp32
rounding hides it (ROADMAP C10, A21), on tiny configs on the CPU, with
the harness of chip_smoke.py's phase 15:

- mamba2: its random layers amplify any reordering of the fp32 sums, so
  the sharded step is held against the unsharded one in float64
  (``chip_smoke.Float64``, ``f64_check``), where that rounding is 2^-29
  of fp32's, to ``F64_TOL`` with no allowance;
- granite-moe: top-k routing is discontinuous, so the sharded run
  replays the unsharded run's expert ids (``chip_smoke.Routes.hand``)
  and is held to the strict fp32 standard (``tp_check``), on the route
  each data shard runs alone (its tokens whole GShard groups, as on the
  card) and on the lockstep route (groups across the shards);
- the float64 context fails on a cast site it does not cover;
- two faults each fail their gate: a replay one row off for one layer of
  one data shard, and a split SSD with two heads' rows of ``out_proj``
  swapped.

The float64 step against the reference's fp32 step is in
``tests/test_torch_training.py`` (``test_float64_step_matches_reference``).
This file imports neither jax nor the reference package."""
import os

import pytest
import torch

from repro_torch.configs import get_tiny
from repro_torch.distributed.sharding import Blocks
from repro_torch.models import layers as L
from repro_torch.models import model as TM
from repro_torch.training import steps as TS
from repro_torch.training.optimizer import tree_leaves

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
torch.set_num_threads(2)


@pytest.fixture
def cs(monkeypatch):
    """chip_smoke at the tests' size: 8 x 32 tokens, 2 steps."""
    monkeypatch.syspath_prepend(ROOT)
    import chip_smoke
    monkeypatch.setattr(chip_smoke, "SHARD_SEQ", 32)
    monkeypatch.setattr(chip_smoke, "SHARD_STEPS", 2)
    return chip_smoke


def _mamba2():
    return get_tiny("mamba2-370m")


def test_mamba2_float64_sharded_is_unsharded(cs):
    """Tiny mamba2 at 4 layers on (2, 4) against unsharded in float64 over
    2 steps: the first step from the same init and one step from the
    unsharded state before the second, losses within F64_TOL, ``m`` and
    ``v`` within F64_TOL of their leaves' largest magnitudes, the params
    within AdamW's propagation of that (``_f64_compare``); every state
    leaf float64, no float32 tensor made, the backward seen."""
    r = cs.f64_check(_mamba2(), CPU, (2, 4), free=False)
    assert r["ok"] and r["gated"] == ["after 1", "after 2"]
    assert r["state_dtypes"] == ["torch.float64"]
    assert r["backward_ops_seen"] > 0
    for k in r["gated"]:
        # fp32's gaps are small at 4 tiny layers: the fixed standard
        assert r[k]["tau"] == cs.F64_TOL
        assert r[k]["loss_rel_gap"] <= cs.F64_TOL
        for what in ("params", "m", "v"):
            assert r[k][what]["ratio"] <= 1.0 and not r[k][what]["beyond"]
        # m and v are held at F64_TOL of their scale, far below it here,
        # and their gap is fp32's scaled by about the unit roundoffs'
        # ratio 2^-29, not by F64_SCALE's 2^-20 alone
        assert r[k]["m"]["rel"] <= 1e-3 * cs.F64_TOL
        assert r[k]["m"]["rel"] <= 2.0 ** -26 * r["fp32"][k]["m"]["rel"]


@pytest.mark.parametrize("shape,seq", [((4, 1), 32), ((2, 2), 32),
                                       ((2, 2), 256)],
                         ids=["4x1-lockstep", "2x2-lockstep",
                              "2x2-whole-groups"])
def test_granite_replayed_is_strict(cs, monkeypatch, shape, seq):
    """Tiny granite-moe at 4 layers, replaying the unsharded run's expert
    ids on ``shape``: the strict standard (LOSS_RTOL, PARAM_TOL on params,
    ``m`` and ``v``, FLIP_SHARE) and the router probs within PARAM_TOL;
    its own top-k logged per step. At 32 tokens a row the GShard groups
    of 512 tokens span the data shards (``run_stack_lockstep``); at 256
    on (2, 2) each shard holds a whole group and runs its own forward, as
    on the card."""
    monkeypatch.setattr(cs, "SHARD_SEQ", seq)
    cfg = get_tiny("granite-moe-1b-a400m")
    t = 8 // 2 // shape[0] * seq
    whole = L.moe_groups(t, total=t * shape[0])
    assert (whole[0] == whole[1]) == (seq == 256)
    routes = cs.Routes()
    try:
        base = cs._plain_run(cfg, CPU, routes)
        r = cs.tp_check(cfg, CPU, shape, base, routes, replay=True)
    finally:
        routes.close()
    assert r["strict"] and r["replayed"]
    assert r["loss_rel_gap"] <= cs.LOSS_RTOL
    assert [p["outside"] for p in r["probs_vs_plain"]] == \
        [0] * cs.SHARD_STEPS
    assert len(r["flips"]) == cs.SHARD_STEPS
    assert len(base["order"]) == cs.SHARD_STEPS


def test_float64_fails_on_a_missed_cast_site(cs, monkeypatch):
    """A float32 cast that the context does not patch (``.to(float32)``
    in the RMS norm) makes fp32 tensors inside the step: leaving the
    context raises, naming the operator."""
    def rms_norm(x, w, eps=1e-6):
        dt = x.dtype
        x = x.to(torch.float32)
        x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
        return (x * (1.0 + w.float())).to(dt)
    monkeypatch.setattr(L, "rms_norm", rms_norm)
    cfg = _mamba2().replace(num_layers=1)
    state, _, batch = cs._shard_setup(cfg, CPU)
    state = cs._f64_state(state)
    with pytest.raises(RuntimeError, match="float32 tensors made inside"):
        with cs.Float64():
            loss, _ = TS.loss_fn(cfg, state.params, batch(0))
            torch.autograd.grad(loss, list(tree_leaves(state.params)))


def test_replay_one_row_off_fails(cs):
    """The replay with the ids of data shard 1's rows moved by one row in
    one layer of the first step's first microbatch (another function):
    the strict gate raises."""
    cfg = get_tiny("granite-moe-1b-a400m")
    routes = cs.Routes()
    try:
        base = cs._plain_run(cfg, CPU, routes)
        order = [[list(layers) for layers in mb] for mb in base["order"]]
        ids = order[0][0][1]
        t = ids.shape[0] // 2
        order[0][0][1] = torch.cat([ids[:t], ids[t:].roll(1, 0)])
        with pytest.raises(RuntimeError, match="tp"):
            cs.tp_check(cfg, CPU, (2, 2), dict(base, order=order), routes,
                        replay=True)
    finally:
        routes.close()


def test_swapped_ssd_heads_fail_float64(cs, monkeypatch):
    """The split SSD with model shard 0's rows of ``out_proj`` for its
    two heads swapped: the float64 gate raises."""
    pd = _mamba2().ssm_head_dim
    ssd_tp = TM._ssd_tp

    def swapped(ctx, p, x, state=None):
        w = p["out_proj"]
        w0 = w.parts[0]
        w0 = torch.cat([w0[pd:2 * pd], w0[:pd], w0[2 * pd:]])
        return ssd_tp(ctx, dict(p, out_proj=Blocks(
            [w0] + list(w.parts[1:]), w.dim, w.route)), x, state)
    monkeypatch.setattr(TM, "_ssd_tp", swapped)
    with pytest.raises(RuntimeError, match="float64"):
        cs.f64_check(_mamba2().replace(num_layers=2), CPU, (2, 4),
                     free=False)
