"""The port's four examples (``examples/torch_*.py``) against the JAX
examples (``examples/*.py``) on the same weights, tiny llama3-8b, CPU.

Each JAX example runs in process (``runpy``, its stdout captured); its
weights are ``init_params(cfg, PRNGKey(0))``, which the port's ``run``
takes through ``params_from_jax``. Counts, hits, plans and per-segment
recompute sets are equal exactly; CFO, a_bar, b_bar, CCI and every
deviation are within ``TOL`` (2e-4 absolute, the port's parity
standard), read at full precision from what the JAX example computed
(its results, or its calls recorded), not from its rounded prints; the
100% recompute row is within ``FULL_RECOMPUTE``. The printed lines are
equal with their numbers masked. TTFT, the engine clock and throughput
are timing figures and are not compared, nor, at ``serve_rag``'s own
arrival rate, Cache-Craft's computed tokens, which the clock decides. ``train_tiny`` hands its
checkpoint from one package to the other and back. A fresh interpreter
that runs a torch example loads neither ``jax`` nor ``repro``."""
import contextlib
import importlib.util
import io
import math
import os
import re
import runpy
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest

from repro.configs import get_tiny as j_tiny
from repro.core import scoring as j_scoring
from repro.models import model as JM
from repro.serving import metrics as j_metrics
from repro.training import checkpoint as jckpt
from repro_torch.configs import get_tiny
from repro_torch.models.model import params_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "examples")
TOL = 2e-4
FULL_RECOMPUTE = 1e-6
NUMBER = re.compile(r"-?\d+(?:\.\d+)?")


def _torch_example(name):
    path = os.path.join(EXAMPLES, f"torch_{name}.py")
    spec = importlib.util.spec_from_file_location(f"torch_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_jax_example(name, argv=()):
    """Run ``examples/<name>.py`` as ``__main__`` with ``argv``; returns
    its globals and its stdout."""
    path = os.path.join(EXAMPLES, f"{name}.py")
    buf = io.StringIO()
    old = sys.argv
    sys.argv = [path, *argv]
    try:
        with contextlib.redirect_stdout(buf):
            g = runpy.run_path(path, run_name="__main__")
    finally:
        sys.argv = old
    return g, buf.getvalue()


def _capture(fn, *a, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*a, **kw)
    return out, buf.getvalue()


def _templates(text):
    return [NUMBER.sub("#", ln) for ln in text.splitlines()]


def _ints(pattern, text):
    return [tuple(int(x) for x in m) if isinstance(m, tuple) else int(m)
            for m in re.findall(pattern, text)]


@pytest.fixture(scope="module")
def weights():
    """The JAX examples' weights, and the same on the port (CPU)."""
    cfg = get_tiny("llama3-8b")
    np_params = jax.tree.map(
        np.asarray, JM.init_params(j_tiny("llama3-8b"),
                                   jax.random.PRNGKey(0)))
    return cfg, params_from_jax(cfg, np_params, device="cpu")


def test_quickstart_matches_jax(weights):
    cfg, params = weights
    g, jout = _run_jax_example("quickstart")
    mine, out = _capture(_torch_example("quickstart").run, cfg, params,
                         "cpu")
    assert _templates(out) == _templates(jout)

    r1, r2 = g["r1"], g["r2"]
    assert (mine["r1_computed"], mine["r1_total"]) == \
        (r1.plan.num_active_tokens, r1.total_len)
    # the JAX store's count after request 1 is in its print only
    assert mine["variants"] == _ints(r"(\d+) chunk-caches stored", jout)[0]
    assert mine["hits"] == sum(d.is_hit for d in r2.plan.decisions)
    assert (mine["r2_computed"], mine["r2_total"]) == \
        (r2.plan.num_active_tokens, r2.total_len)
    assert mine["compute_fraction"] == pytest.approx(r2.compute_fraction,
                                                     abs=1e-12)
    assert len(mine["segments"]) == len(r2.plan.decisions)
    for seg, d in zip(mine["segments"], r2.plan.decisions):
        assert (seg["stat_id"], seg["hit"], seg["length"]) == \
            (d.seg.stat_id, d.is_hit, d.seg.length)
        assert seg["recompute_idx"] == [int(i) for i in d.recompute_idx]
        assert abs(seg["cfo"] - float(d.cfo)) <= TOL
    dev_naive = j_metrics.relative_deviation(g["rn"].logits_last,
                                             g["ro"].logits_last)
    dev_cc = j_metrics.relative_deviation(r2.logits_last,
                                          g["ro"].logits_last)
    assert abs(mine["dev_naive"] - dev_naive) <= TOL
    assert abs(mine["dev_cachecraft"] - dev_cc) <= TOL
    # the quickstart's premises hold on these weights in both packages
    assert mine["hits"] >= 2 and mine["r2_computed"] < mine["r2_total"]


def test_cache_analysis_matches_jax(weights, monkeypatch):
    """The JAX example's train-mode forwards, its ``chunk_scores`` calls
    (those with its ``h<j>`` prefix hashes; the executor scores chunks
    too, the first one with no prefix) and its ``relative_deviation``
    calls are recorded as it runs."""
    cfg, params = weights
    forwards, scores, devs = [], [], []
    forward, chunk_scores = JM.forward, j_scoring.chunk_scores
    relative_deviation = j_metrics.relative_deviation

    def rec_forward(*a, **kw):
        out = forward(*a, **kw)
        if kw.get("mode") == "train":
            forwards.append(np.asarray(out.hidden))
        return out

    def rec_scores(inter, lengths, i, hashes, *a, **kw):
        sc = chunk_scores(inter, lengths, i, hashes, *a, **kw)
        if i and list(hashes) == [f"h{j}" for j in range(i)]:
            scores.append(sc)
        return sc

    def rec_dev(a, b):
        d = relative_deviation(a, b)
        devs.append(d)
        return d

    monkeypatch.setattr(JM, "forward", rec_forward)
    monkeypatch.setattr(j_scoring, "chunk_scores", rec_scores)
    monkeypatch.setattr(j_metrics, "relative_deviation", rec_dev)
    _, jout = _run_jax_example("cache_analysis")
    monkeypatch.undo()
    mine, out = _capture(_torch_example("cache_analysis").run, cfg, params,
                         "cpu")
    assert _templates(out) == _templates(jout)

    # Fig. 7: the chunk alone, then after 0-3 prefix chunks
    assert len(forwards) == 6
    h_alone = forwards[0][0]
    n = len(h_alone)
    fig7 = [np.linalg.norm(h[0, -n:] - h_alone) / np.linalg.norm(h_alone)
            for h in forwards[1:5]]
    assert len(mine["fig7"]) == 4
    for got, want in zip(mine["fig7"], fig7):
        assert abs(got - want) <= TOL
    # Eq. 9-11
    assert [c["chunk"] for c in mine["chunks"]] == [1, 2, 3]
    assert len(scores) == 3
    for got, sc in zip(mine["chunks"], scores):
        for k in ("a_bar", "b_bar", "cci"):
            assert abs(got[k] - float(getattr(sc, k))) <= TOL, k
    # Fig. 15
    assert [r["fraction"] for r in mine["fig15"]] == \
        [0.0, 0.2, 0.4, 0.6, 0.8, 1.0]
    assert len(devs) == 6
    for got, want in zip(mine["fig15"], devs):
        assert abs(got["deviation"] - want) <= TOL
    assert mine["fig15"][-1]["deviation"] <= FULL_RECOMPUTE
    assert devs[-1] <= FULL_RECOMPUTE


@pytest.mark.parametrize("qpm", ["1e9", "600"])
def test_serve_rag_matches_jax(weights, qpm):
    """At ``--qpm 1e9`` every request arrives at once and every count is
    equal. At the example's 600 the engine clock (measured compute time,
    and in the JAX package its compiles) decides which requests share a
    prefill pass, and so which chunks are already stored: Cache-Craft's
    computed tokens are then a timing figure (two runs of the JAX example
    in one process read 669 and 638 of 741), and only the counts the
    clock does not move are compared."""
    cfg, params = weights
    _, jout = _run_jax_example("serve_rag", ["--requests", "4", "--qpm",
                                             qpm])
    mine, out = _capture(_torch_example("serve_rag").run, cfg, params,
                         "cpu", requests=4, qpm=float(qpm))
    assert _templates(out) == _templates(jout)
    want_completed = _ints(r"completed (\d+),", jout)
    want_tokens = _ints(r"prefill tokens computed (\d+)/(\d+)", jout)
    names = ("full-recompute", "cache-craft")
    assert list(mine) == list(names)
    assert [mine[n]["completed"] for n in names] == want_completed == [4, 4]
    got = [(mine[n]["prefill_tokens_computed"],
            mine[n]["prefill_tokens_total"]) for n in names]
    if qpm == "1e9":
        assert got == want_tokens
    else:
        assert [t for _, t in got] == [t for _, t in want_tokens]
    fr, cc = (mine[n] for n in names)
    assert fr["prefill_tokens_computed"] == fr["prefill_tokens_total"]
    assert cc["prefill_tokens_computed"] < cc["prefill_tokens_total"]


def test_train_tiny_hands_checkpoints_across_packages(tmp_path):
    """JAX 4 steps -> the port resumes to 6 -> JAX resumes to 8."""
    ck = str(tmp_path / "ckpt")
    _, jout = _run_jax_example("train_tiny", ["--steps", "4", "--ckpt-every",
                                              "2", "--ckpt-dir", ck])
    assert "done: 4 steps" in jout and jckpt.latest_step(ck) == 4
    _, out = _capture(_torch_example("train_tiny").main,
                      ["--steps", "6", "--ckpt-dir", ck, "--device", "cpu"])
    assert "resumed from step 4" in out
    m = re.search(r"done: 6 steps on cpu, final loss (\S+)", out)
    assert m and math.isfinite(float(m.group(1))), out
    assert jckpt.latest_step(ck) == 6
    _, jout = _run_jax_example("train_tiny", ["--steps", "8", "--ckpt-dir",
                                              ck])
    assert "resumed from step 6" in jout and "done: 8 steps" in jout
    assert jckpt.latest_step(ck) == 8


@pytest.mark.parametrize("name,argv", [
    ("quickstart", []), ("cache_analysis", []),
    ("serve_rag", ["--requests", "2"]),
    ("train_tiny", ["--steps", "2", "--seq-len", "32", "--ckpt-dir", "CKPT"]),
])
def test_torch_example_loads_no_jax(name, argv, tmp_path):
    """``python examples/torch_<name>.py --device cpu`` in a fresh
    interpreter without ``PYTHONPATH``: it runs, and neither ``jax`` nor
    any module of the reference package gets loaded."""
    argv = [str(tmp_path) if a == "CKPT" else a for a in argv]
    path = os.path.join(EXAMPLES, f"torch_{name}.py")
    code = textwrap.dedent(f"""
        import runpy, sys
        sys.argv = {[path, *argv, "--device", "cpu"]!r}
        runpy.run_path(sys.argv[0], run_name="__main__")
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m == "repro" or m.startswith("repro."))
        assert not bad, bad
        assert "repro_torch.models.model" in sys.modules
        print("imports ok")
    """)
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "JAX_PLATFORMS")}
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().endswith("imports ok")


def test_chip_smoke_examples_phase_rehearsal(tmp_path, monkeypatch):
    """``chip_smoke.run_examples`` (phase 23) on tiny llama3-8b with
    ``device="cpu"`` and the tiny mains given ``--device cpu``: RoPE goes
    through the wrapper's CPU path, by a stand-in of ``rope_np`` that
    counts its calls as launches (the CPU path launches nothing), so that
    the phase's counts, recorders and gates run as on the card. The
    replay's ``measure_rope`` (timed with CUDA events on the card) is a
    stand-in here that holds the recorded inputs against the model's
    plain ``apply_rope``."""
    import torch

    from repro_torch.core import prefill
    from repro_torch.kernels.rope import ops as rops
    from repro_torch.models import model as M
    from repro_torch.models.layers import apply_rope

    monkeypatch.syspath_prepend(ROOT)
    import chip_smoke as cs

    def counted(cfg, k, pos, *, device, inverse=False):
        rops.rope.launches += 1
        return rops.rope(torch.from_numpy(np.array(k, np.float32)),
                         torch.from_numpy(np.asarray(pos, np.int32)),
                         theta=cfg.rope_theta, inverse=inverse).numpy()

    replayed = {}

    def measure_rope(label, x32, pos, theta):
        err = max(float((rops.rope(x32, pos, theta=theta, inverse=inv)
                         - apply_rope(x32, pos, theta, inverse=inv))
                        .abs().max()) for inv in (False, True))
        replayed[label] = tuple(x32.shape)
        fig = dict(err=err, ms=0.0, device_ms=0.0, plain_ms=0.0,
                   bound_ms=0.0, bound_by="bytes")
        return {"float32": fig, "bfloat16": fig}

    monkeypatch.setattr(prefill, "rope_np", counted)
    monkeypatch.setattr(cs, "measure_rope", measure_rope)
    monkeypatch.setattr(rops.rope, "launches", 0)
    cfg = get_tiny("llama3-8b")
    gen = torch.Generator()
    gen.manual_seed(0)
    figs = cs.run_examples(cfg, M.init_params(cfg, gen),
                           torch.device("cpu"), "cpu", str(tmp_path),
                           mains_argv=("--device", "cpu"))
    assert {n: m["exit"] for n, m in figs["tiny_mains"].items()} == \
        {n: 0 for n, _ in cs.EXAMPLE_MAINS}
    sr = figs["serve_rag"]
    assert sr["cache-craft"]["requests"] == cs.EXAMPLE_REQUESTS
    assert sr["cache-craft"]["launches"]["rope"] > 0
    assert sr["full-recompute"]["launches"]["rope"] == 0
    assert figs["quickstart"]["launches"]["rope"] > 0
    assert figs["cache_analysis"]["launches"]["rope"] > 0
    assert figs["peak_gb"] is None
    # every example's RoPE calls replayed at its most frequent shape
    names = ("quickstart", "cache_analysis", "serve_rag cache-craft")
    assert set(figs["rope_replay"]) == set(names)
    assert set(replayed) == {f"example {n}" for n in names}
    for n in names:
        r = figs["rope_replay"][n]
        assert replayed[f"example {n}"] == tuple(r["shape"])
        assert r["shape"][0] == cfg.num_layers
        assert r["shape"][2:] == [cfg.num_kv_heads, cfg.head_dim]
        assert r["calls"] > 0 and r["float32"]["err"] <= 3e-5
