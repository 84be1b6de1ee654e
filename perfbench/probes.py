"""What the benchmark reads from the program while it runs, from its own
wrappers around the calls into each layer (nothing inside the program
changes):

* ``Capture`` (every run): for the requests sampled for the correctness
  check and the warm-up's, the plan of their prefill with the variants
  it chose among, the stored chunk KV it injected, the rows each layer
  window computed, and the KV it stored; every chunk KV handed to the
  store, and each read of it in those passes. In the window it keeps
  references only; the comparisons run after the window's close.
* ``Spans`` (traced runs): host-clock spans around the calls into each
  layer, for the idle gaps of the device trace.
* ``KernelCalls`` (traced runs): the shapes and position tensors of each
  chunk- and decode-attention launch, for their rooflines.
* ``Windows`` (traced runs): the rows each prefill window computed, for
  the prefill's closed-form FLOPs.

Each wrapper is installed on the engine instance or on the module
attribute the program looks up at call time, and removed by ``remove``.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Set

import numpy as np


class Patches:
    def __init__(self):
        self._undo: List[Callable] = []

    def wrap(self, owner, name: str, make: Callable):
        orig = getattr(owner, name)
        had = name in getattr(owner, "__dict__", {})
        setattr(owner, name, make(orig))

        def undo():
            if had:
                setattr(owner, name, orig)
            else:
                delattr(owner, name)
        self._undo.append(undo)

    def remove(self):
        while self._undo:
            self._undo.pop()()


class Capture:
    """Per-request record of a prefill for the correctness check.

    While the engine runs it keeps references only: the plan of each
    captured request with the store's variants it chose among, the
    stored chunk KV it read, the position rows each layer window
    computed, each chunk KV handed to the store (of every request), and
    each read of a stored chunk in a captured pass. ``finish``, called
    once the window has closed, copies the rows to the host and compares
    every read with what was stored. ``own_s`` is the wrappers' own host
    time while ``timing`` is on (the window)."""

    def __init__(self, patches: Patches, engine, modules, want: Callable,
                 record_windows: bool):
        self.want = want                 # rid -> capture this request?
        self.by_rid: Dict[int, dict] = {}
        self.attempts: Dict[int, int] = {}
        self.stored: Dict[str, dict] = {}      # variant id -> kv as stored
        self.stored_by: Dict[str, int] = {}    # variant id -> rid
        self.reads: List[tuple] = []           # (variant id, kv as read)
        self.read_mismatch = 0
        self.reads_checked = 0
        self.windows: List[tuple] = []   # (pass id, g0, g1, tail, pos, seg)
        self.record_windows = record_windows
        self.recording = True
        self.timing = False
        self.own_s = 0.0
        self._pass = None                # current pass: dict
        ex, store = engine.executor, engine.store
        model = modules["model"]
        cap = self

        def own(t0):
            if cap.timing:
                cap.own_s += time.perf_counter() - t0

        def run_prefills(orig):
            def f(reqs):
                t0 = time.perf_counter()
                want = any(cap.want(r.rid) for r in reqs)
                cap._pass = {"reqs": list(reqs), "kv": {}, "stored": [],
                             "win": [], "want": want,
                             # the variants the plans choose among
                             "table": {h: list(vs) for h, vs in
                                       store.table.items()}
                             if want and store is not None else {}}
                own(t0)
                try:
                    return orig(reqs)
                finally:
                    cap._pass = None
            return f

        def process_batch(orig):
            def f(requests, collect_stats=True):
                res = orig(requests, collect_stats)
                t0 = time.perf_counter()
                ps = cap._pass
                if ps is not None:
                    cap._after_pass(ps, res)
                own(t0)
                return res
            return f

        def run_stack(orig):
            def f(cfg, params, h, ctx, *a, **kw):
                t0 = time.perf_counter()
                ps = cap._pass
                if ps is not None and (ps["want"] or (
                        cap.record_windows and cap.recording)):
                    g0 = kw.get("g0", 0)
                    g1 = kw.get("g1", cfg.n_groups)
                    tail = kw.get("tail", True)
                    ps["win"].append((g0, g1, tail, ctx.positions,
                                      ctx.seg_ids))
                own(t0)
                return orig(cfg, params, h, ctx, *a, **kw)
            return f

        def get_kv(orig):
            def f(var):
                kv, info = orig(var)
                t0 = time.perf_counter()
                ps = cap._pass
                if ps is not None and ps["want"] and kv is not None:
                    ps["kv"][var.variant_id] = kv
                    cap.reads.append((var.variant_id, kv))
                own(t0)
                return kv, info
            return f

        def capture(orig):
            def f(plan, *a, **kw):
                ps = cap._pass
                if ps is not None:
                    ps["plan"] = plan
                try:
                    return orig(plan, *a, **kw)
                finally:
                    if ps is not None:
                        ps["plan"] = None
            return f

        def add_variant(orig):
            def f(chash, kv, scores):
                var = orig(chash, kv, scores)
                t0 = time.perf_counter()
                cap.stored[var.variant_id] = kv
                ps = cap._pass
                if ps is not None and ps["want"]:
                    ps["stored"].append((id(ps.get("plan")), chash, kv,
                                         var.variant_id))
                own(t0)
                return var
            return f

        patches.wrap(engine, "_run_prefills", run_prefills)
        patches.wrap(ex, "process_batch", process_batch)
        patches.wrap(model, "run_stack", run_stack)
        patches.wrap(ex, "_capture", capture)
        if store is not None:
            patches.wrap(store, "get_kv", get_kv)
            patches.wrap(store, "add_variant", add_variant)

    def _after_pass(self, ps, results):
        """References only: the pass's rows are read in ``finish``."""
        reqs = ps["reqs"]
        if self.record_windows and self.recording:
            self.windows.append([(g0, g1, tail, pos, seg, len(reqs))
                                 for g0, g1, tail, pos, seg in ps["win"]])
        if not ps["want"]:
            return
        table = ps["table"]
        for r, (req, res) in enumerate(zip(reqs, results)):
            if not self.want(req.rid):
                continue
            self.attempts[req.rid] = self.attempts.get(req.rid, 0) + 1
            plan = res.plan
            hits = []
            decisions = []
            for d in plan.decisions:
                vid = d.variant.variant_id if d.is_hit else None
                if d.is_hit:
                    kv = ps["kv"].get(vid)
                    hits.append((d.seg.start, d.seg.end,
                                 None if kv is None else kv["k"],
                                 None if kv is None else kv["v"]))
                decisions.append({
                    "start": d.seg.start, "end": d.seg.end,
                    "chash": d.seg.chash, "variant": vid,
                    "cfo": d.cfo, "recompute": d.recompute_idx,
                    "candidates": [(v.variant_id, v.scores)
                                   for v in table.get(d.seg.chash, [])]})
            st = []
            for pid, h, kv, vid in ps["stored"]:
                if pid != id(plan):
                    continue
                self.stored_by[vid] = req.rid
                d = next(d for d in plan.decisions if d.seg.chash == h)
                st.append((d.seg.start, d.seg.end, kv["k"], kv["v"]))
            self.by_rid[req.rid] = {
                "total_len": plan.total_len, "hits": hits, "stored": st,
                "hit_variants": [d["variant"] for d in decisions
                                 if d["variant"] is not None],
                "plan": {"decisions": decisions,
                         "question": (plan.question.start,
                                      plan.question.end)},
                "windows": [(g0, g1, tail, pos, seg, r)
                            for g0, g1, tail, pos, seg in ps["win"]]}

    def finish(self):
        """After the window: each captured window's rows on the host, and
        every read of a stored chunk against the KV handed to the store."""
        for c in self.by_rid.values():
            c["windows"] = [
                (g0, g1, tail, _rows(pos, seg, r))
                for g0, g1, tail, pos, seg, r in c["windows"]]
        for vid, kv in self.reads:
            want = self.stored.get(vid)
            if want is None:
                continue
            self.reads_checked += 1
            if not all(np.array_equal(np.asarray(kv[n]), np.asarray(want[n]))
                       for n in ("k", "v")):
                self.read_mismatch += 1
        self.reads = []


def _rows(pos, seg, r) -> np.ndarray:
    p = pos[0].cpu().numpy()
    s = seg[0].cpu().numpy()
    return p[(s == r) & (p >= 0)]


class Spans:
    """Host-clock spans ``(name, t0, t1, depth)`` around calls into the
    program's layers."""

    def __init__(self, patches: Patches, engine, modules):
        self.spans: List[tuple] = []
        self.on = False
        self._depth = 0
        sp = self

        def timed(name):
            def make(orig):
                def f(*a, **kw):
                    if not sp.on:
                        return orig(*a, **kw)
                    t0 = time.perf_counter()
                    sp._depth += 1
                    try:
                        return orig(*a, **kw)
                    finally:
                        sp._depth -= 1
                        sp.spans.append((name, t0, time.perf_counter(),
                                         sp._depth))
                return f
            return make

        ex, store, pool = engine.executor, engine.store, engine.pool
        prefill = modules["prefill"]
        for owner, attr, name in (
                (engine, "step", "engine.step"),
                (engine, "_admit", "scheduler.admit"),
                (engine, "_prefetch_lookahead", "store.prefetch"),
                (engine, "_run_prefills", "engine.prefill_pass"),
                (ex, "process_batch", "executor.process_batch"),
                (ex, "_capture", "executor.capture_store"),
                (prefill, "pack_cache", "executor.pack_cache"),
                (prefill, "unpack_cache", "executor.unpack_cache"),
                (prefill, "rope_np", "executor.rope_np"),
                (modules["model"], "run_stack", "model.run_stack"),
                (modules["model"], "lm_head", "model.lm_head"),
                (engine, "_write_back", "pool.write_back"),
                (engine, "_decode_join_batch", "engine.decode_join"),
                (engine, "_rebuild_decode_batch", "engine.decode_rebuild"),
                (engine, "_run_decode_step", "engine.decode_step"),
                (engine, "_decode_fn", "model.decode_forward"),
                (engine, "_extract_slot_kv", "engine.decode_readback"),
                (pool, "append_token", "pool.append_token"),
                (engine, "_finish", "engine.finish")):
            patches.wrap(owner, attr, timed(name))
        if store is not None:
            patches.wrap(store, "get_kv", timed("store.get_kv"))
            patches.wrap(store, "add_variant", timed("store.add_variant"))


class KernelCalls:
    """Shapes and position tensors of each attention-kernel call. The key
    positions are copied (one small copy on the card per call): a cache's
    position row is updated in place by the steps after it."""

    def __init__(self, patches: Patches, modules):
        self.chunk: List[tuple] = []
        self.decode: List[tuple] = []
        self.on = False
        kc = self

        def chunk(orig):
            def f(q, k, v, q_pos, k_pos, k_chunk, *, q_seg=None, k_seg=None,
                  num_chunks=16, window=0):
                if kc.on:
                    kc.chunk.append((tuple(q.shape), tuple(k.shape),
                                     q.dtype, k.dtype, q_pos, k_pos.clone(),
                                     q_seg, None if k_seg is None
                                     else k_seg.clone(), num_chunks))
                return orig(q, k, v, q_pos, k_pos, k_chunk, q_seg=q_seg,
                            k_seg=k_seg, num_chunks=num_chunks,
                            window=window)
            return f

        def decode(orig):
            def f(q, k, v, q_pos, k_pos, *, window=0):
                if kc.on:
                    kc.decode.append((tuple(q.shape), tuple(k.shape),
                                      q.dtype, k.dtype, q_pos, k_pos.clone()))
                return orig(q, k, v, q_pos, k_pos, window=window)
            return f

        def keep_counters(make):
            # the wrapped function's launch counters stay where the
            # wrapper module's own code increments them (by the name)
            def m(orig):
                f = make(orig)
                f.launches = orig.launches
                f.launches_by_type = orig.launches_by_type
                return f
            return m

        patches.wrap(modules["chunk_ops"], "chunk_attention",
                     keep_counters(chunk))
        patches.wrap(modules["decode_ops"], "decode_attention",
                     keep_counters(decode))
