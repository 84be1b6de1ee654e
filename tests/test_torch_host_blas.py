"""The host BLAS under the port's byte-equality gates (ROADMAP C9).

``tests/test_shared_chunks.py:66``'s workload on the port (tiny
llama3-8b with the reference's weights, ``attn_impl="dense"``, the CPU,
2 torch threads): two warm-up runs and the measured run, copy then
zero-copy, in one fresh interpreter. Unpinned, the first
``process_batch`` of a process now and then computes along another path
of the host's MKL and the store carries those bytes into the copy
engine's measured run; ``MKL_CBWR=COMPATIBLE`` pins it.

Run as a script, it counts the mismatches over many fresh processes::

    PYTHONPATH=src python tests/test_torch_host_blas.py --runs 60 --jobs 4
    PYTHONPATH=src python tests/test_torch_host_blas.py --runs 240 --jobs 4 \\
        --env MKL_CBWR=COMPATIBLE
    ... --poison | --mkldnn-off | --threads 1 | --env MKL_DYNAMIC=FALSE

``--poison`` fills every ``torch.empty`` / ``empty_like`` /
``Tensor.new_empty`` and ``np.empty`` / ``empty_like`` of the process
with NaN (integers with a sentinel): padding that leaked into a result
would then show in every run. Each process prints one JSON line; the
script prints the rate, which run holds the odd bytes (the minority
digest of each run across processes) and where the results of the
process's prefill calls first part from the majority.
"""
import argparse
import collections
import hashlib
import json
import os
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _poison():
    import torch
    t_empty, t_like, t_new = torch.empty, torch.empty_like, \
        torch.Tensor.new_empty
    n_empty, n_like = np.empty, np.empty_like

    def fill(t):
        if t.is_floating_point():
            t.fill_(float("nan"))
        elif t.dtype != torch.bool:
            t.fill_(-12345)
        return t

    def nfill(x):
        if x.dtype.kind == "f":
            x.fill(np.nan)
        elif x.dtype.kind in "iu":
            x.fill(12345)
        return x

    torch.empty = lambda *a, **k: fill(t_empty(*a, **k))
    torch.empty_like = lambda *a, **k: fill(t_like(*a, **k))
    torch.Tensor.new_empty = lambda self, *a, **k: fill(t_new(self, *a, **k))
    np.empty = lambda *a, **k: nfill(n_empty(*a, **k))
    np.empty_like = lambda *a, **k: nfill(n_like(*a, **k))


def _digest(*arrays) -> str:
    h = hashlib.sha1()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:12]


def one_process(threads=2, poison=False, mkldnn_off=False):
    """The workload in this process: copy, then zero-copy. Returns the
    decode traces' digests, byte equality, the first differing (step,
    rid), the largest difference and the digest of every prefill
    result in call order."""
    import torch
    torch.set_num_threads(threads)
    if mkldnn_off:
        torch.backends.mkldnn.flags(enabled=False).__enter__()
    if poison:
        _poison()
    import jax

    from repro.configs import get_tiny as j_tiny
    from repro.models import model as JM
    from repro_torch.configs import get_tiny
    from repro_torch.core import prefill
    from repro_torch.core.chunkstore import ChunkStore
    from repro_torch.core.tiers import TieredStore
    from repro_torch.models import model as TM
    from repro_torch.serving.api import EngineSpec, build_engine
    from repro_torch.serving.engine import EngineStats
    from repro_torch.serving.rag import KnowledgeBase
    from repro_torch.serving.request import Request
    from repro_torch.serving.scheduler import SchedulerConfig

    cfg = get_tiny("llama3-8b")
    jparams = JM.init_params(j_tiny("llama3-8b"), jax.random.PRNGKey(0))
    params = TM.params_from_jax(cfg, jax.tree.map(np.asarray, jparams),
                                "cpu")
    kb = KnowledgeBase(num_chunks=8, vocab_size=cfg.vocab_size, seed=0)
    calls = []
    batch = prefill.CacheCraftExecutor.process_batch

    def traced(self, *a, **k):
        out = batch(self, *a, **k)
        calls.extend(_digest(r.k_layers, r.logits_last) for r in out)
        return out

    prefill.CacheCraftExecutor.process_batch = traced

    def requests():
        rng = np.random.default_rng(17)
        sys_t = rng.integers(0, kb.vocab_size, 8).astype(np.int32)
        chunks = [kb.chunks[0], kb.chunks[1], kb.chunks[2]]
        return [Request(rid=i, system_tokens=sys_t,
                        chunk_tokens=[c.copy() for c in chunks],
                        question_tokens=rng.integers(
                            0, kb.vocab_size, 10).astype(np.int32),
                        max_new_tokens=4, arrival_time=0.0)
                for i in range(4)]

    traces = {}
    with tempfile.TemporaryDirectory() as tmp:
        for share in (False, True):
            store = ChunkStore(TieredStore(
                1 << 28, 1 << 28, os.path.join(tmp, str(share)),
                start_worker=False), n_chunks=50, m_variants=4)
            eng = build_engine(
                EngineSpec(use_focus=False, store_fixed_variants=False,
                           force_recompute_fraction=0.3, pool_blocks=256,
                           attn_impl="dense", device="cpu",
                           sched=SchedulerConfig(max_batch_tokens=100_000,
                                                 max_decode_batch=8,
                                                 max_prefill_batch=4),
                           share_chunk_kv=share, trace_decode=True),
                cfg=cfg, params=params, store=store)
            eng.run(requests())
            eng.run(requests())
            eng.stats, eng.decode_trace = EngineStats(), []
            eng.run(requests())
            traces[share] = eng.decode_trace
    first, worst = None, 0.0
    for step, (a, b) in enumerate(zip(traces[False], traces[True])):
        for rid in sorted(a):
            d = float(np.abs(a[rid] - b[rid]).max())
            if d > 0 and first is None:
                first = [step, rid]
            worst = max(worst, d)
    return dict(
        copy=_digest(*[st[r] for st in traces[False] for r in sorted(st)]),
        zero_copy=_digest(*[st[r] for st in traces[True]
                            for r in sorted(st)]),
        equal=worst == 0.0, first=first, max_diff=worst, calls=calls,
        finite=all(np.isfinite(lg).all() for tr in traces.values()
                   for st in tr for lg in st.values()))


def run_fresh(env=None, **kw):
    """``one_process(**kw)`` in a fresh interpreter with ``env`` added;
    returns its JSON result."""
    args = [sys.executable, os.path.abspath(__file__), "--one",
            "--threads", str(kw.get("threads", 2))]
    args += ["--poison"] * bool(kw.get("poison")) + \
        ["--mkldnn-off"] * bool(kw.get("mkldnn_off"))
    r = subprocess.run(args, cwd=ROOT, capture_output=True, text=True,
                       timeout=900, env=dict(
                           os.environ, **(env or {}),
                           PYTHONPATH="src" + os.pathsep
                           + os.environ.get("PYTHONPATH", "")))
    if r.returncode:
        raise RuntimeError(r.stderr[-3000:])
    return json.loads(r.stdout.strip().splitlines()[-1])


def summarize(results):
    """The mismatch count, the run holding the odd bytes (a digest seen
    in fewer processes than the majority's) and the first prefill call
    whose digest parts from the majority, per odd process."""
    odd = [r for r in results if not r["equal"]]
    major = {k: collections.Counter(r[k] for r in results).most_common(1)[0][0]
             for k in ("copy", "zero_copy")}
    n_calls = max(len(r["calls"]) for r in results)
    call_major = [collections.Counter(
        r["calls"][i] for r in results if i < len(r["calls"])
    ).most_common(1)[0][0] for i in range(n_calls)]
    return dict(
        processes=len(results), mismatched=len(odd),
        max_diff=sorted({r["max_diff"] for r in odd}),
        first_step=sorted({tuple(r["first"]) for r in odd}),
        odd_run=collections.Counter(
            "copy" if r["copy"] != major["copy"] else "zero_copy"
            if r["zero_copy"] != major["zero_copy"] else "neither"
            for r in odd),
        odd_calls=[[i for i, (c, m) in enumerate(zip(r["calls"],
                                                     call_major)) if c != m]
                   for r in odd],
        finite=all(r["finite"] for r in results))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", type=int, default=60)
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--threads", type=int, default=2)
    ap.add_argument("--env", action="append", default=[],
                    help="NAME=VALUE for every process")
    ap.add_argument("--poison", action="store_true")
    ap.add_argument("--mkldnn-off", action="store_true")
    ap.add_argument("--one", action="store_true",
                    help="one process's run (what --runs starts)")
    a = ap.parse_args(argv)
    kw = dict(threads=a.threads, poison=a.poison, mkldnn_off=a.mkldnn_off)
    if a.one:
        print(json.dumps(one_process(**kw)))
        return 0
    env = dict(e.split("=", 1) for e in a.env)
    with ThreadPoolExecutor(a.jobs) as pool:
        results = list(pool.map(lambda _: run_fresh(env, **kw),
                                range(a.runs)))
    print(json.dumps(dict(env=env, **kw, **summarize(results))))
    return 0


def test_poisoned_allocations_leave_zero_copy_byte_equal():
    """With every empty allocation poisoned and the host BLAS pinned, the
    copy and zero-copy runs are finite and byte-equal: no padding row,
    key or position of the port reaches a result."""
    r = run_fresh({"MKL_CBWR": "COMPATIBLE"}, poison=True)
    assert r["finite"] and r["equal"], r


if __name__ == "__main__":
    sys.exit(main())
