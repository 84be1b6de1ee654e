"""The tensor-parallel train step held to the parity standard where fp32
rounding hides it (ROADMAP C10, A21), on tiny configs on the CPU, with
the harness of chip_smoke.py's phase 15:

- mamba2: its random layers amplify any reordering of the fp32 sums, so
  the sharded step is held against the unsharded one in float64
  (``chip_smoke.Float64``, ``f64_check``), where that rounding is 2^-29
  of fp32's, to ``F64_TOL`` with no allowance;
- granite-moe: top-k routing is discontinuous, so the sharded run
  replays the unsharded run's expert ids (``chip_smoke.Routes.hand``)
  and is held to the strict fp32 standard, the whole run (``tp_check``)
  and one step from each unsharded state (``_stepwise``, the gate at
  full depth on the card), on the route each data shard runs alone
  (its tokens whole GShard groups, as on the card) and on the lockstep
  route (groups across the shards);
- the float64 context fails on a cast site it does not cover;
- two faults each fail their gate: a replay one row off for one layer of
  one data shard (in both granite gates), and a split SSD with two
  heads' rows of ``out_proj`` swapped.

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


@pytest.mark.parametrize("shape,seq", [((4, 1), 32), ((2, 2), 32),
                                       ((2, 2), 256)],
                         ids=["4x1-lockstep", "2x2-lockstep",
                              "2x2-whole-groups"])
def test_granite_one_replayed_step_is_strict(cs, monkeypatch, shape, seq):
    """Tiny granite-moe at 4 layers: after each unsharded step one sharded
    step on ``shape`` from the unsharded state before it (kept on the
    device), replaying that step's expert ids (``_stepwise``): every step
    strict (LOSS_RTOL, PARAM_TOL on ``m`` and ``v``, the params but for
    ``FLIP_GRAD``'s elements, each listed), its own top-k's flips and
    router probs logged, one step's counted bytes equal to the closed
    form and position 0's bytes to the layouts."""
    monkeypatch.setattr(cs, "SHARD_SEQ", seq)
    cfg = get_tiny("granite-moe-1b-a400m")
    routes = cs.Routes()
    try:
        base, steps = cs._stepwise(cfg, CPU, (shape,), routes)
        alone = cs._plain_run(cfg, CPU, routes)
    finally:
        routes.close()
    # the sharded steps leave the unsharded run as it runs alone
    assert base["losses"] == alone["losses"]
    assert all(torch.equal(a, b) for a, b in zip(base["params"],
                                                 alone["params"]))
    per = steps[shape]
    assert [st["step"] for st in per] == list(range(1, cs.SHARD_STEPS + 1))
    for st in per:
        assert st["strict"] and st["loss_rel_gap"] <= cs.LOSS_RTOL
        assert st["m_outside"] == st["v_outside"] == 0
        assert all(e["flip"] for e in st["params_outside_elements"])
        assert st["flips"] == 0 and st["probs_vs_plain"]["outside"] == 0
        assert st["position0_bytes"] == st["layout_bytes"]
        assert all(a > 0 for s in st["aux"] for a in s)


def test_step_gap_lists_elements_across_chunks(cs):
    """The one-step gate's comparison (``_step_gap``), a leaf and a chunk
    of elements at a time: a sharded state equal to the unsharded one but
    for two embedding elements in different chunks, each moved past
    PARAM_TOL by less than 2 lr, one with grads under FLIP_GRAD (a flip)
    and one with grads of rms 1e-3 (not): both listed in order with
    their moments and grad rms, the gate fails; with the flip alone it
    holds."""
    from repro_torch.launch.mesh import make_debug_mesh
    cfg = get_tiny("granite-moe-1b-a400m")
    state, opt, _ = cs._shard_setup(cfg, CPU)
    names = cs._leaf_names(state.params)
    e = state.params["embed"]
    i1, i2 = 5, e.numel() - 7
    with torch.no_grad():
        for v in tree_leaves(state.opt["v"]):
            v.fill_(1e-6 * (1 - opt.b2))            # grad rms 1e-3
        state.opt["v"]["embed"].view(-1)[i1] = 0.0
    want = {k: [x.detach().clone() for x in tree_leaves(tr)]
            for k, tr in (("params", state.params), ("m", state.opt["m"]),
                          ("v", state.opt["v"]))}
    shs = TS.train_shardings(cfg, make_debug_mesh((2, 2), device=CPU))

    def gap(moved):
        with torch.no_grad():
            e.view(-1).copy_(want["params"][names.index("/embed")]
                             .view(-1))
            for i in moved:
                e.view(-1)[i] += 5e-4
        return cs._step_gap(names, TS.shard_state(state, shs), want, 1e-3,
                            opt.b2, 1, chunk=1000)
    both = gap((i1, i2))
    assert both["params"]["outside"] == 2 and not both["ok"]
    assert both["m"]["outside"] == both["v"]["outside"] == 0
    assert [x["index"] for x in both["elements"]] == [i1, i2]
    assert [x["flip"] for x in both["elements"]] == [True, False]
    assert both["elements"][0]["grad_rms"] == [0.0, 0.0]
    assert both["elements"][1]["grad_rms"][0] == pytest.approx(1e-3)
    one = gap((i1,))
    assert one["ok"] and one["params"]["outside"] == 1


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


def test_one_step_replay_one_row_off_fails(cs, monkeypatch):
    """``test_replay_one_row_off_fails``'s fault in the one-step check:
    the first sharded step on (2, 2) handed the unsharded step's ids with
    data shard 1's rows moved by one row in one layer of its first
    microbatch; the gate raises, naming the mesh and the step."""
    cfg = get_tiny("granite-moe-1b-a400m")
    hand = cs.Routes.hand
    planted = []

    def off(self, order, dp):
        if not planted:
            order = [list(layers) for layers in order]
            ids = order[0][1]
            t = ids.shape[0] // 2
            order[0][1] = torch.cat([ids[:t], ids[t:].roll(1, 0)])
            planted.append(True)
        hand(self, order, dp)
    monkeypatch.setattr(cs.Routes, "hand", off)
    routes = cs.Routes()
    try:
        with pytest.raises(RuntimeError,
                           match=r"\[2, 2\] step 1: loss gap"):
            cs._stepwise(cfg, CPU, ((2, 2),), routes)
    finally:
        routes.close()
    assert planted


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
