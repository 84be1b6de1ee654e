"""One run of one cell: set-up, the measured window on the wall clock,
the correctness check against the plain reference, and the result line.

The window drives the engine itself: it submits each request when it is
due (``Engine.submit``), calls ``Engine.step`` in a loop, reads
``Engine.drain_tokens`` after every step and stamps each token with
``time.perf_counter()``. It never uses ``Engine.run`` or the engine's own
clock. Set-up (``setup_s``) runs from process start to the window's
start: weights made on the card from the seed, the kernels built, the
engine built and warmed by a warm-up trace from the same generator.
"""
from __future__ import annotations

import gc
import json
import os
import resource
import shutil
import sys
import tempfile
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from perfbench import spec, weights
from perfbench.traffic import Trace

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
DRAIN_S = 90.0
RAMP_S = 120.0     # a closed loop's ramp is cut here


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (``repro_torch`` is not ``repro``)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


@dataclass
class ReqLog:
    rid: int
    due: float                      # seconds after the window's start
    prompt_len: int
    segments: int                   # cacheable segments: system + chunks
    t_admit: Optional[float] = None  # start of the step it left the queue
    t_tokens: List[float] = field(default_factory=list)
    cache_hits: int = 0
    failed: bool = False


class RunData:
    """What the metric readers read (``metrics/<name>.py``)."""

    def __init__(self, m, seconds):
        self.m = m
        self.seconds = seconds
        self.reqs: Dict[int, ReqLog] = {}
        self.window_rids: List[int] = []
        self.stats0: Dict = {}
        self.stats1: Dict = {}
        self.prefill_windows: List = []
        self.kernels = None
        self.dtrace = None
        self.spans = None
        self.window_end: float = seconds

    # ---- helpers the readers share ------------------------------------
    def delta(self, key: str) -> float:
        return float(self.stats1[key]) - float(self.stats0[key])

    def ttfts(self) -> List[float]:
        out = []
        for rid in self.window_rids:
            r = self.reqs[rid]
            t = r.t_tokens[0] if r.t_tokens else self.window_end
            out.append(t - r.due)
        return out

    def tokens_in_window(self):
        """(rid, output index, time) of every token emitted in the
        window."""
        return [(r.rid, i, t) for r in self.reqs.values()
                for i, t in enumerate(r.t_tokens)
                if 0.0 <= t <= self.window_end]

    def in_window_prefilled(self) -> List[ReqLog]:
        return [r for r in self.reqs.values()
                if r.t_tokens and 0.0 <= r.t_tokens[0] <= self.window_end]


def percentile(xs, q: float) -> Optional[float]:
    if not len(xs):
        return None
    return float(np.percentile(np.asarray(xs, np.float64), q))


def _model_cfg(m: Dict):
    from repro_torch.models.config import ModelConfig
    keys = ("name", "family", "num_layers", "d_model", "num_heads",
            "num_kv_heads", "head_dim", "d_ff", "vocab_size", "rope_theta",
            "norm_eps", "num_experts", "experts_per_token",
            "capacity_factor", "dtype", "param_dtype")
    return ModelConfig(pattern=("attn",), **{k: m[k] for k in keys
                                             if k in m})


def _modules():
    from repro_torch.core import prefill
    from repro_torch.kernels.chunk_attention import ops as chunk_ops
    from repro_torch.kernels.decode_attention import ops as decode_ops
    from repro_torch.models import model
    return {"prefill": prefill, "model": model, "chunk_ops": chunk_ops,
            "decode_ops": decode_ops}


def _request(r):
    from repro_torch.serving.request import Request
    return Request(rid=r.idx, system_tokens=r.system,
                   chunk_tokens=list(r.chunks), question_tokens=r.question,
                   max_new_tokens=r.max_new, arrival_time=0.0,
                   session=r.session)


def build(cellname: str, seed: int, seconds: float, device: str,
          overrides: Optional[Dict] = None):
    """Everything up to the warm-up: (cell, model dict, trace, engine,
    params, store dir)."""
    import torch
    from repro_torch.serving.api import EngineSpec, StoreSpec, build_engine
    from repro_torch.serving.scheduler import SchedulerConfig
    cell = dict(spec.cell(cellname))
    conf = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    m = dict(conf["model"])
    m["reference"] = conf["reference"]
    ov = dict(overrides or {})
    m.update(ov.get("model", {}))
    traffic = {**traffic, **ov.get("traffic", {})}
    eng_cfg = {**cell["engine"], **ov.get("engine", {})}
    cell["limits"] = {**cell["limits"], **ov.get("limits", {})}
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        from repro_torch.kernels import build as kbuild
        kbuild.build_all()
    params = weights.make_params(m, seed, dev, weights_dtype(m))
    trace = Trace(traffic, seed, m["vocab_size"], seconds)
    store_dir = tempfile.mkdtemp(prefix="perfbench-store-",
                                 dir=os.environ.get("TMPDIR"))
    st = eng_cfg["store"]
    eng = build_engine(EngineSpec(
        strategy=eng_cfg.get("strategy", "cachecraft"),
        attn_impl=eng_cfg.get("attn_impl", "kernel"),
        pool_blocks=int(eng_cfg["pool_blocks"]),
        block_size=int(eng_cfg.get("block_size", 16)),
        sched=SchedulerConfig(
            max_decode_batch=int(eng_cfg["max_decode_batch"]),
            max_prefill_batch=int(eng_cfg["max_prefill_batch"]),
            max_batch_tokens=int(eng_cfg.get("max_batch_tokens", 150_000))),
        store=StoreSpec(hbm_bytes=int(st["hbm_bytes"]),
                        cpu_bytes=int(st["cpu_bytes"]), ssd_dir=store_dir,
                        n_chunks=int(st["n_chunks"]),
                        m_variants=int(st.get("m_variants", 5))),
        device=str(dev)), cfg=_model_cfg(m), params=params)
    return cell, m, traffic, trace, eng, params, store_dir


def weights_dtype(m: Dict):
    import torch
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[
        m["param_dtype"]]


def warm_up(eng, trace: Trace, traffic: Dict):
    """Serve the warm-up trace to completion: the store fills as in a
    steady state, and every kernel and path the window takes has run."""
    cap = traffic.get("warmup_max_new")
    reqs = []
    for r in trace.warmup:
        q = _request(r)
        if cap is not None:
            q.max_new_tokens = min(q.max_new_tokens, int(cap))
        reqs.append(q)
        eng.submit(q)
    while any(not q.finished for q in reqs):
        eng.step()
    eng.drain_tokens()
    return reqs


def choose_sample(trace: Trace, n: int, seed: int, seconds: float,
                  kind: str) -> Optional[set]:
    """Open loop: ``n`` requests due in the first 60% of the window drawn
    from the seed, and the one with the longest prompt among those.
    Closed loop: None (every request is captured and the sample is drawn
    after the window from those finished)."""
    if kind != "open_loop":
        return None
    early = [r for r in trace.window if r.due <= 0.6 * seconds]
    if not early:
        early = trace.window[:1]
    rng = np.random.default_rng([seed, 303])
    pick = rng.permutation(len(early))[:n]
    out = {early[i].idx for i in pick}
    out.add(max(early, key=lambda r: (r.prompt_len, r.max_new)).idx)
    # and the first whose retrieval holds a chunk not seen before: its
    # prefill computes and stores that chunk (the store check's subject)
    seen = {c for r in trace.warmup for c in r.chunk_ids}
    for r in trace.window:
        if r.due > 0.6 * seconds:
            break
        if set(r.chunk_ids) - seen:
            out.add(r.idx)
            break
        seen.update(r.chunk_ids)
    return out


def drive(eng, trace: Trace, traffic: Dict, run: RunData, seconds: float,
          hooks: Dict, sample_need: int, sample_rids: Optional[set]):
    """The measured window, then the drain past its close.

    A closed loop starts in set-up: every client sends its first request,
    and the window opens once the decode batch holds as many rows as it
    will in steady state and one decode step has run at that size (the
    ramp). Times are kept from the window's start; the ramp's are
    negative, and its requests are not among the window's."""
    from repro_torch.serving.request import State
    kind = traffic["kind"]
    live: Dict[int, object] = {}
    waiting: Dict[int, object] = {}
    by_rid = {r.idx: r for r in trace.window}
    t0 = time.perf_counter()

    def submit(r, due, in_window):
        q = _request(r)
        run.reqs[r.idx] = ReqLog(rid=r.idx, due=due, prompt_len=r.prompt_len,
                                 segments=len(r.chunks) + 1)
        if in_window:
            run.window_rids.append(r.idx)
        live[r.idx] = q
        waiting[r.idx] = q
        eng.submit(q)

    pending = list(trace.window)
    nxt = 0
    clients: List[Optional[int]] = []
    opened = kind != "closed_loop"
    if kind == "closed_loop":
        C = int(traffic["clients"])
        queues = [pending[c::C] for c in range(C)]
        heads = [0] * C
        clients = [None] * C
        rows = min(C, int(eng.scheduler.cfg.max_decode_batch))
        steps_full = 0
        ramp_end = t0 + RAMP_S
    else:
        hooks["open"]()
        t0 = time.perf_counter()
        hooks["start"](t0)
    closed = False
    drain_end = None
    while True:
        now = time.perf_counter() - t0
        if not opened and (steps_full >= 1 or now + t0 > ramp_end):
            # the ramp is over: the window starts now
            opened = True
            hooks["open"]()
            shift = time.perf_counter() - t0
            t0 += shift
            now = 0.0
            for log in run.reqs.values():
                log.due -= shift
                log.t_admit = None if log.t_admit is None else \
                    log.t_admit - shift
                log.t_tokens = [t - shift for t in log.t_tokens]
            _log(f"closed-loop ramp {shift:.1f} s: {len(eng.decoding)} rows "
                 f"decoding, {len(run.reqs)} requests sent")
            hooks["start"](t0)
        if opened and not closed and now >= seconds:
            closed = True
            run.window_end = now
            hooks["close"]()
            # the drain's time starts once the close's work is done
            drain_end = time.perf_counter() - t0 + DRAIN_S
        if kind == "open_loop":
            # every request due in the window is sent, also when a long
            # step carried the loop past the window's close
            while nxt < len(pending) and pending[nxt].due <= now:
                submit(pending[nxt], pending[nxt].due, True)
                nxt += 1
        if not closed:
            if kind == "closed_loop":
                for c in range(len(clients)):
                    rid = clients[c]
                    if rid is None or live[rid].finished:
                        if heads[c] >= len(queues[c]):
                            raise RuntimeError(
                                "closed loop: client ran out of requests; "
                                "raise requests_per_client")
                        r = queues[c][heads[c]]
                        heads[c] += 1
                        clients[c] = r.idx
                        submit(r, now, opened)
        else:
            if kind == "open_loop":
                due_done = nxt >= len(pending) and all(
                    run.reqs[rid].t_tokens or live[rid].finished
                    for rid in run.window_rids)
                smp = all(live[rid].finished for rid in sample_rids
                          if rid in live)
                if due_done and smp:
                    break
            else:
                done = sum(1 for q in live.values()
                           if q.state == State.DONE)
                if done >= sample_need or not (
                        eng.scheduler.queue or eng.decoding):
                    break
            if now > drain_end:
                break
        t_step = time.perf_counter() - t0
        full = not opened and len(eng.decoding) >= rows
        worked = eng.step()
        if full and len(eng.decoding) >= rows:
            steps_full += 1
        t = time.perf_counter() - t0
        for rid, _tok in eng.drain_tokens():
            log = run.reqs.get(rid)
            if log is not None:
                log.t_tokens.append(t)
        for rid in [rid for rid, q in waiting.items()
                    if q.state != State.QUEUED]:
            run.reqs[rid].t_admit = t_step
            del waiting[rid]
        if not worked and kind == "open_loop" and not closed and \
                nxt < len(pending):
            time.sleep(max(0.0, min(pending[nxt].due - t, 0.05)))
        elif not worked and closed:
            break
    for rid, q in live.items():
        log = run.reqs[rid]
        log.cache_hits = q.cache_hits
        log.failed = q.state == State.FAILED
    return live, by_rid


def _cases(cap, live, by_rid, rids):
    """The sampled requests as the reference needs them, and the count
    of what their plans do otherwise than the frozen selection rule."""
    from perfbench.reference.gqa import Case
    from perfbench.reference.select import plan_mismatches
    cases, bad = [], 0
    for rid in rids:
        c = cap.by_rid.get(rid)
        q = live[rid]
        if c is None or cap.attempts.get(rid, 0) != 1 or \
                any(h[2] is None for h in c["hits"]):
            continue
        r = by_rid[rid]
        bad += plan_mismatches(r.system, r.chunks, r.question, c["plan"],
                               c["windows"])
        toks = np.concatenate([r.system] + list(r.chunks) + [r.question])
        # one "attn" layer per pattern group and no tail: group g is
        # layer g
        wins = [(g0, g1, act.astype(np.int64))
                for g0, g1, _tail, act in c["windows"]]
        cases.append(Case(tokens=toks.astype(np.int64), windows=wins,
                          injected=[(s, e, k, v) for s, e, k, v in c["hits"]],
                          served=list(q.output_tokens),
                          stored=c["stored"]))
    return cases, bad


def reference_checks(m, seed, cases, device, limits,
                     control: bool = False) -> Dict:
    """The comparison that decides ``correct``, run once the window has
    closed and the program's state is freed. With ``control`` the
    reference computed in float8 (``mode="fp8"``) takes the program's
    place, on the same prompts and served tokens: the tokens judged are
    the ones it puts first at each position, and the chunk KV judged is
    the one it stores."""
    import dataclasses
    import importlib

    import torch
    gqa = importlib.import_module(f"perfbench.reference.{m['reference']}")
    dev = torch.device(device)
    wd = weights_dtype(m)

    def lw(layer):
        return weights.layer_params(m, seed, layer, dev, wd)

    head = weights.head_params(m, seed, dev, wd)
    judged = [c.served for c in cases]
    if control:
        ctl = gqa.run(m, cases, lw, head, dev, mode="fp8", keep_stored=True)
        judged = [r["logits"].argmax(-1).tolist() for r in ctl]
        cases = [dataclasses.replace(c, stored=r["stored_ref"])
                 for c, r in zip(cases, ctl)]
        del ctl
    res = gqa.run(m, cases, lw, head, dev, mode="fp32")
    gaps = torch.cat([gqa.served_gaps(r["logits"], j)
                      for r, j in zip(res, judged)])
    errs = [e for r in res for e in r["store_err"]]
    found = {"served_gap": float(gaps.max()),
             "served_gap_mean": float(gaps.mean())}
    if errs:
        found["store_kv_err"] = max(errs)
    # the cell's limits name the numbers it is judged by; the others are
    # printed beside them with no limit
    out = {k: {"value": v, "limit": limits.get(k)} for k, v in found.items()}
    return out


@dataclass
class Served:
    """A run up to the comparison: the result line without ``correct``
    and ``checks``, and what the reference needs."""
    line: Dict
    cases: list
    m: Dict
    cell: Dict
    read_mismatch: int
    reads_checked: int
    plan_mismatch: int
    run_end: float


def run_cell(cellname: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", overrides: Optional[Dict] = None,
             t_process: Optional[float] = None, fault=None) -> Dict:
    """One whole run; returns the result line as a dict, ``checks``
    last. ``fault`` (tests only) is called with the engine before the
    warm-up, to break the timed path underneath."""
    sv = serve(cellname, seed, seconds, trace, device, overrides,
               t_process, fault)
    return judge(sv, seed, device)


def judge(sv: "Served", seed: int, device: str = "cuda",
          control: bool = False) -> Dict:
    """The result line of a served run, with ``correct`` and ``checks``:
    the program's outputs against the plain reference, or with
    ``control`` the reference's float8 control in the program's place."""
    cases, cell = sv.cases, sv.cell
    smp = cell["sample"]
    checks = {}
    correct = bool(cases)
    t_r = time.perf_counter()
    if cases:
        checks = reference_checks(sv.m, seed, cases, device, cell["limits"],
                                  control)
    _log(f"drain to {sv.run_end:.1f} s; reference{' (control)' * control} "
         f"{time.perf_counter() - t_r:.1f} s over {len(cases)} requests")
    checks["store_read_mismatch"] = {"value": sv.read_mismatch, "limit": 0}
    checks["plan_mismatch"] = {"value": sv.plan_mismatch, "limit": 0}
    checks["sampled_requests"] = {"value": len(cases),
                                  "limit": int(smp["min_checked"])}
    for name, c in checks.items():
        if c["limit"] is None:
            continue
        if name == "sampled_requests":
            correct &= c["value"] >= c["limit"]
        else:
            correct &= c["value"] <= c["limit"]
    checks["sampled_tokens"] = {"value": sum(len(c.served) for c in cases),
                                "limit": None}
    checks["store_reads_checked"] = {"value": sv.reads_checked,
                                     "limit": None}
    line = dict(sv.line)
    line["correct"] = bool(correct)
    line["checks"] = checks
    return line


def serve(cellname: str, seed: int, seconds: float, trace: bool,
          device: str = "cuda", overrides: Optional[Dict] = None,
          t_process: Optional[float] = None, fault=None) -> Served:
    """Set-up, the window, the metrics, the sample's captures; the
    program's state is freed before it returns."""
    import torch
    from perfbench import probes
    from perfbench.devtrace import DeviceTrace
    t_process = time.perf_counter() if t_process is None else t_process
    bench = spec.benchmark()
    cell, m, traffic, tr, eng, params, store_dir = build(
        cellname, seed, seconds, device, overrides)
    _log(f"built in {time.perf_counter() - t_process:.1f} s since start")
    dev = torch.device(device)
    is_cuda = dev.type == "cuda"
    mods = _modules()
    patches = probes.Patches()
    smp = cell["sample"]
    sample_rids = choose_sample(tr, int(smp["requests"]), seed, seconds,
                                traffic["kind"])
    n_warm = len(tr.warmup)
    # the warm-up's requests too: one that stored a chunk the sample
    # reads is checked against the reference
    want = (lambda rid: True) if sample_rids is None else \
        (lambda rid: rid < n_warm or rid in sample_rids)
    cap = probes.Capture(patches, eng, mods, want, record_windows=trace)
    spans = kcalls = dtrace = None
    if trace:
        spans = probes.Spans(patches, eng, mods)
        kcalls = probes.KernelCalls(patches, mods)
    if fault is not None:
        fault(eng)
    t_w = time.perf_counter()
    warm = {q.rid: q for q in warm_up(eng, tr, traffic)}
    _log(f"warm-up {time.perf_counter() - t_w:.1f} s "
         f"({len(tr.warmup)} requests)")
    if is_cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    run = RunData(m, seconds)
    cap.recording = False
    cap.windows = []
    setup_s = None
    host = {}

    def open_trace():
        nonlocal dtrace
        if trace and is_cuda:
            dtrace = DeviceTrace(dev)
            dtrace.open()

    def start(t0):
        nonlocal setup_s
        setup_s = t0 - t_process
        run.stats0 = eng.stats.stats_dict()
        host["start"] = resource.getrusage(resource.RUSAGE_SELF)
        cap.recording = cap.timing = True
        if trace:
            spans.on = kcalls.on = True
            if dtrace is not None:
                dtrace.start()

    def close():
        run.stats1 = eng.stats.stats_dict()
        host["close"] = resource.getrusage(resource.RUSAGE_SELF)
        cap.recording = cap.timing = False
        if trace:
            spans.on = kcalls.on = False
            if dtrace is not None:
                dtrace.stop()

    live, by_rid = drive(eng, tr, traffic, run, seconds,
                         {"open": open_trace, "start": start,
                          "close": close},
                         int(smp["requests"]), sample_rids)
    if not run.stats1:
        close()
    _log(f"capture's own host time in the window {cap.own_s * 1e3:.3f} ms")
    if "start" in host:
        a, b = host["start"], host["close"]
        # the host's CPU time over the window tracks TTFT from run to run
        _log(f"window on the host: user {b.ru_utime - a.ru_utime:.2f} s, "
             f"system {b.ru_stime - a.ru_stime:.2f} s; torch threads "
             f"{torch.get_num_threads()} of {os.cpu_count()} CPUs")
    cap.finish()
    cnt = eng.counters.stats_dict()
    _log("window: " + ", ".join(
        f"{k} {run.delta(k):.6g}" for k in (
            "prefill_batches", "prefill_compute_s", "decode_steps",
            "decode_compute_s", "prefill_tokens_computed",
            "prefill_tokens_total")) +
        f"; whole run: decode_rebuilds {cnt['decode_rebuilds']}, "
        f"decode_joins {cnt['decode_joins']}, "
        f"decode_gather_bytes {cnt['decode_gather_bytes']}")
    run.prefill_windows = cap.windows
    run.kernels = kcalls
    run.dtrace = dtrace
    run.spans = spans
    mem_peak = int(torch.cuda.max_memory_allocated(dev)) if is_cuda else 0

    kinds = "per_layer" if trace else "end_to_end"
    metrics = {}
    for mt in spec.metrics_for(bench, kinds, cellname):
        if mt["name"] == "setup_s":
            val = setup_s
        else:
            val = spec.reader(mt["name"])(run)
        if val is not None:
            metrics[mt["name"]] = {"value": float(val), "unit": mt["unit"]}
    breakdown = None
    busy = win_s = None
    if trace and dtrace is not None:
        busy, win_s = dtrace.busy_s(), dtrace.window_s
        breakdown = {"device_ops": dtrace.top_ops(10),
                     "idle_gaps": dtrace.idle_gaps(spans.spans, 10)}

    # the sample for the check: open loop, the requests chosen before the
    # window; closed loop, drawn from the seed among those finished, with
    # the longest in it
    from repro_torch.serving.request import State
    if sample_rids is None:
        done = sorted(rid for rid, q in live.items()
                      if q.state == State.DONE)
        rng = np.random.default_rng([seed, 404])
        pick = [done[i] for i in rng.permutation(len(done))[
            :int(smp["requests"])]]
        if done:
            longest = max(done, key=lambda rid: len(live[rid].output_tokens)
                          + by_rid[rid].prompt_len)
            if longest not in pick:
                pick.append(longest)
            # and one that stored a chunk, where any did
            if not any(cap.by_rid.get(rid, {}).get("stored") for rid in pick):
                st = [rid for rid in done
                      if cap.by_rid.get(rid, {}).get("stored")]
                if st:
                    pick.append(st[0])
        sample = pick
    else:
        sample = sorted(rid for rid in sample_rids
                        if live[rid].state == State.DONE)
    # and the warm-up request that stored the first chunk the sample
    # reads that the warm-up stored
    for rid in list(sample):
        src = [cap.stored_by.get(v) for v in
               cap.by_rid.get(rid, {}).get("hit_variants", [])]
        src = [w for w in src if w in warm]
        if src:
            sample.append(src[0])
            break
    served_reqs = {**warm, **live}
    trace_reqs = {r.idx: r for r in tr.warmup}
    trace_reqs.update(by_rid)
    cases, plan_bad = _cases(cap, served_reqs, trace_reqs, sample)
    read_mismatch, reads_checked = cap.read_mismatch, cap.reads_checked

    attempted = len(run.window_rids)
    run_end = time.perf_counter() - t_process
    # open loop: every request due in the window is waited for, and one
    # with no first token by the drain's end has failed; closed loop:
    # the clients' last requests are still being served when the run
    # stops, and only those the engine failed count
    failed = sum(1 for rid in run.window_rids
                 if run.reqs[rid].failed or (
                     traffic["kind"] == "open_loop"
                     and not run.reqs[rid].t_tokens))

    # free the program's state before the reference runs
    patches.remove()
    if eng.store is not None and eng.store.tiers is not None:
        eng.store.tiers.close()
    del eng, params, live, warm, served_reqs, cap, run, kcalls, spans, \
        dtrace
    gc.collect()
    if is_cuda:
        torch.cuda.empty_cache()
    shutil.rmtree(store_dir, ignore_errors=True)

    device_info = {"platform": "gpu" if is_cuda else "cpu",
                   "kind": torch.cuda.get_device_name(dev) if is_cuda
                   else "cpu",
                   "count": 1, "memory_peak_bytes": mem_peak}
    if busy is not None:
        device_info["busy_s"] = busy
        device_info["window_s"] = win_s
    line = {"correct": False, "attempted": attempted, "failed": failed,
            "metrics": metrics, "device": device_info}
    if breakdown is not None:
        line["breakdown"] = breakdown
    return Served(line, cases, m, cell, read_mismatch, reads_checked,
                  plan_bad, run_end)


def _log(msg: str):
    print(f"perfbench: {msg}", file=sys.stderr, flush=True)


def print_result(line: Dict):
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
