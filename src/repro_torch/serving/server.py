"""Online serving front end of the port: the ``Engine`` on a background
stepping thread behind a minimal stdlib-only HTTP API (the same routes,
threading contract and client as ``repro/serving/server.py``).

Routes (JSON in / JSON or NDJSON out):

* ``POST /v1/submit``      — enqueue a request, returns ``{"rid": n}``
* ``GET  /v1/stream/<rid>``— NDJSON token stream: one ``{"token": t}``
  line per generated token as it is produced, then a final
  ``{"done": true, "state": ...}`` line (close-delimited)
* ``POST /v1/cancel/<rid>``— cancel wherever the request currently is
  (queued / prefilling next pass / mid-decode)
* ``GET  /health``         — liveness of the HTTP and engine threads
* ``GET  /stats``          — ``Engine.stats_dict()`` plus per-tenant
  SLO rollups (``metrics.tenant_rollups``) and server info

Threading / ownership contract
------------------------------
The engine-loop thread OWNS all torch/CUDA, pool, store, and scheduler
state. HTTP handler threads never touch a tensor: they only

* enqueue submissions into the inbox ``queue.Queue`` (picked up by the
  loop's ``feed`` callback, stamped with a wall-clock arrival time);
* flag cancellations via ``Engine.request_cancel`` (a set-add under
  no lock contention; the engine thread applies them at the top of its
  next ``step``);
* block on their per-request stream ``queue.Queue`` for tokens the
  engine thread fanned out (``_dispatch`` drains
  ``Engine.drain_tokens()`` after every step, on the engine thread).

The server-side registries (``_streams`` / ``_requests`` /
``_inflight``) are shared between the engine thread and HTTP handler
threads and are guarded by one ``_lock``: submit inserts under it, the
dispatcher and ``/stats`` snapshot under it before iterating. Engine
counters read by ``/stats`` are still read racily — integers only,
monitoring-grade, never used for control decisions. Everything that
mutates engine state happens on exactly one thread, which is what makes
cancellation mid-decode safe: the row mask, shared-run release, and
pool reclaim all run between steps, never concurrent with them.

CUDA on the engine thread: every tensor the engine makes names the
engine's device explicitly, and the loop makes that device current on
its thread before the first step (a new thread starts on device 0, and
the kernels launch on the current device's stream). Waiting for the
card (``devmod.sync``, ``torch.cuda.synchronize(device)``) is safe from
any thread.

The engine loop is ``Engine.step_until_idle`` — the same loop batch
replay (``Engine.run``) uses, but unbounded (``max_iters=None``) so a
long-lived server never exhausts a replay-sized iteration budget —
with the server's inbox as ``feed`` and a short blocking inbox wait as
``idle``, so the thread sleeps when there is no work instead of
spinning.

Clock: in serve mode the loop advances ``Engine.clock`` to wall time
(``time.monotonic`` since ``start``) before every feed, so per-request
``deadline_s`` SLOs and queue-wait metrics are measured in real
seconds; modeled prefill/load durations still add on top, making the
clock an upper bound on wall time rather than a pure simulation.

Terminal streams a client never read (or abandoned mid-read) are
garbage-collected ``stream_ttl_s`` after the terminal event, and the
finished-request registry is capped at ``request_cap`` (oldest
finished evicted first), so a long-running server does not leak one
queue + Request per submission.
"""
from __future__ import annotations

import itertools
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.serving.metrics import tenant_rollups
from repro_torch.serving.request import Request


def _request_from_json(rid: int, body: dict) -> Request:
    return Request(
        rid=rid,
        system_tokens=np.asarray(body["system_tokens"], np.int32),
        chunk_tokens=[np.asarray(c, np.int32)
                      for c in body.get("chunk_tokens", [])],
        question_tokens=np.asarray(body["question_tokens"], np.int32),
        max_new_tokens=int(body.get("max_new_tokens", 32)),
        tenant=str(body.get("tenant", "default")),
        deadline_s=float(body.get("deadline_s", 0.0)),
        session=int(body.get("session", -1)),
        turn=int(body.get("turn", 0)),
    )


class CacheCraftServer:
    """Run an ``Engine`` behind HTTP. Construct the engine through
    ``serving.api.build_engine`` and hand it over — the server takes
    ownership of stepping it (do not call ``run``/``step`` yourself
    while the server is started)."""

    def __init__(self, engine, host: str = "127.0.0.1", port: int = 0,
                 stream_ttl_s: float = 300.0, request_cap: int = 10_000):
        self.engine = engine
        self.stream_ttl_s = stream_ttl_s
        self.request_cap = request_cap
        self._rid = itertools.count()
        self._inbox: "queue.Queue[Request]" = queue.Queue()
        # rid -> per-request stream queue; created at submit (before
        # the request can produce tokens) so no event is ever dropped
        self._streams: Dict[int, "queue.Queue"] = {}
        # every request ever submitted (for /stats rollups) and the
        # subset not yet observed terminal by the dispatcher
        self._requests: Dict[int, Request] = {}
        self._inflight: Dict[int, Request] = {}
        # rid -> wall time its terminal event was queued; drives the
        # unread-stream GC
        self._done_at: Dict[int, float] = {}
        # one lock for every registry above: they are written by HTTP
        # submit threads and iterated by the engine thread (_dispatch)
        # and /stats — unguarded, a concurrent insert during iteration
        # raises and kills the engine loop
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._t0 = time.monotonic()
        self._thread: Optional[threading.Thread] = None

        self.httpd = ThreadingHTTPServer((host, port), _Handler)
        self.httpd.daemon_threads = True
        self.httpd.cc = self          # handler back-pointer
        self.host, self.port = self.httpd.server_address[:2]

    # ---- lifecycle -------------------------------------------------------
    def start(self):
        self._t0 = time.monotonic()
        self._thread = threading.Thread(target=self._engine_loop,
                                        name="cc-engine", daemon=True)
        self._thread.start()
        self._http_thread = threading.Thread(
            target=self.httpd.serve_forever, name="cc-http", daemon=True)
        self._http_thread.start()
        return self

    def shutdown(self, timeout: float = 30.0):
        """Stop accepting work, let the engine drain in-flight
        requests, then stop both threads."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
        self.httpd.shutdown()
        self.httpd.server_close()
        self._http_thread.join(timeout)

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    # ---- engine-loop thread ----------------------------------------------
    def _now(self) -> float:
        return time.monotonic() - self._t0

    def _drain_inbox(self) -> bool:
        got = False
        while True:
            try:
                req = self._inbox.get_nowait()
            except queue.Empty:
                return got
            req.arrival_time = self._now()
            self.engine.submit(req)
            got = True

    def _engine_loop(self):
        eng = self.engine
        if eng.device.type == "cuda":
            torch.cuda.set_device(eng.device)
        # discard token events a pre-server Engine.run left undrained
        # (warm-up traces): their rids would collide with fresh server
        # rids and misroute stale tokens into new streams
        eng.drain_tokens()

        def feed():
            # live serving measures SLOs in real seconds: pull the
            # engine clock up to wall time so deadline expiry and
            # queue-wait are not stuck on the modeled step durations
            eng.clock = max(eng.clock, self._now())
            self._drain_inbox()
            return None            # arrivals are live, never known ahead

        def idle():
            # nothing queued, nothing decoding: sleep on the inbox so
            # the loop does not spin while the server is quiescent
            if self._stop.is_set() and self._inbox.empty():
                return False
            try:
                req = self._inbox.get(timeout=0.02)
            except queue.Empty:
                return not self._stop.is_set()
            eng.clock = max(eng.clock, self._now())
            req.arrival_time = self._now()
            eng.submit(req)
            return True

        # max_iters=None: the live loop must never exhaust a finite
        # iteration budget and silently exit with streams in flight
        eng.step_until_idle(max_iters=None, feed=feed,
                            on_step=self._dispatch, idle=idle)
        self._dispatch()           # flush events from the final step

    def _dispatch(self):
        """Fan engine output out to the HTTP side (engine thread only):
        route drained (rid, token) events into per-request stream
        queues, close the streams of requests that went terminal this
        step, then collect garbage (unread terminal streams past their
        TTL, finished requests beyond the retention cap). All registry
        access happens under ``_lock`` because HTTP submit threads
        insert concurrently."""
        events = self.engine.drain_tokens()
        now = time.monotonic()
        with self._lock:
            for rid, tok in events:
                q = self._streams.get(rid)
                if q is not None:
                    q.put(("token", tok))
            done = [rid for rid, r in self._inflight.items()
                    if r.finished]
            for rid in done:
                req = self._inflight.pop(rid)
                q = self._streams.get(rid)
                if q is not None:
                    q.put(("done", req.state.value))
                    self._done_at[rid] = now
            self._gc_locked(now)

    def _gc_locked(self, now: float):
        """Reap abandoned state (caller holds ``_lock``): stream
        queues whose terminal event nobody consumed within
        ``stream_ttl_s`` (client never connected, or disconnected
        early), and the oldest finished requests once ``_requests``
        exceeds ``request_cap`` — /stats rollups lose ancient history
        instead of the server growing without bound."""
        expired = [rid for rid, t in self._done_at.items()
                   if now - t > self.stream_ttl_s]
        for rid in expired:
            self._done_at.pop(rid, None)
            self._streams.pop(rid, None)
        if len(self._requests) > self.request_cap:
            for rid in list(self._requests):
                if len(self._requests) <= self.request_cap:
                    break
                r = self._requests[rid]
                if r.finished and rid not in self._streams:
                    del self._requests[rid]

    # ---- HTTP-thread entry points ----------------------------------------
    def submit(self, body: dict) -> int:
        req = _request_from_json(next(self._rid), body)
        with self._lock:
            self._streams[req.rid] = queue.Queue()
            self._requests[req.rid] = req
            self._inflight[req.rid] = req
        self._inbox.put(req)
        return req.rid

    def cancel(self, rid: int) -> bool:
        with self._lock:
            known = rid in self._requests
        if not known:
            return False
        self.engine.request_cancel(rid)
        return True

    def stream(self, rid: int):
        """Yield stream events for ``rid`` until its terminal event.
        Runs on the HTTP handler thread; only ever touches the
        per-request queue."""
        with self._lock:
            q = self._streams.get(rid)
        if q is None:
            return
        while True:
            try:
                kind, val = q.get(timeout=120.0)
            except queue.Empty:
                yield {"error": "stream timeout"}
                return
            if kind == "token":
                yield {"token": int(val)}
            else:
                yield {"done": True, "state": val}
                with self._lock:
                    self._streams.pop(rid, None)
                    self._done_at.pop(rid, None)
                return

    def stats(self) -> dict:
        d = self.engine.stats_dict()
        with self._lock:
            requests = list(self._requests.values())
            inflight = len(self._inflight)
        d["tenants"] = tenant_rollups(requests)
        d["server"] = dict(
            inflight=inflight,
            submitted=len(requests),
            uptime_s=self._now(),
            engine_thread_alive=bool(self._thread
                                     and self._thread.is_alive()))
        return d


class _Handler(BaseHTTPRequestHandler):
    # close-delimited streaming: HTTP/1.0 + Connection: close means the
    # client reads NDJSON lines until EOF, no chunked framing needed
    protocol_version = "HTTP/1.0"

    def log_message(self, fmt, *args):   # quiet by default
        pass

    @property
    def cc(self) -> CacheCraftServer:
        return self.server.cc

    def _json(self, code: int, obj: dict):
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path == "/health":
            alive = bool(self.cc._thread and self.cc._thread.is_alive())
            self._json(200 if alive else 503,
                       {"ok": alive, "engine_thread_alive": alive})
        elif self.path == "/stats":
            self._json(200, self.cc.stats())
        elif self.path.startswith("/v1/stream/"):
            try:
                rid = int(self.path.rsplit("/", 1)[1])
            except ValueError:
                return self._json(400, {"error": "bad rid"})
            with self.cc._lock:
                known = rid in self.cc._requests
            if not known:
                return self._json(404, {"error": f"unknown rid {rid}"})
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.send_header("Connection", "close")
            self.end_headers()
            try:
                for event in self.cc.stream(rid):
                    self.wfile.write(
                        (json.dumps(event) + "\n").encode())
                    self.wfile.flush()
            except BrokenPipeError:
                pass               # client went away; engine unaffected
        else:
            self._json(404, {"error": f"no route {self.path}"})

    def do_POST(self):
        n = int(self.headers.get("Content-Length", 0))
        raw = self.rfile.read(n) if n else b"{}"
        if self.path == "/v1/submit":
            try:
                body = json.loads(raw)
                rid = self.cc.submit(body)
            except (KeyError, ValueError, TypeError) as e:
                return self._json(400, {"error": repr(e)})
            self._json(200, {"rid": rid})
        elif self.path.startswith("/v1/cancel/"):
            try:
                rid = int(self.path.rsplit("/", 1)[1])
            except ValueError:
                return self._json(400, {"error": "bad rid"})
            ok = self.cc.cancel(rid)
            self._json(200 if ok else 404, {"cancelled": ok})
        else:
            self._json(404, {"error": f"no route {self.path}"})


# ---- tiny stdlib client (tests / CI serve gate / examples) ---------------
class ServeClient:
    """http.client-based helper for driving a ``CacheCraftServer``:
    submit, read a token stream to completion, cancel, fetch stats."""

    def __init__(self, host: str, port: int, timeout: float = 120.0):
        self.host, self.port, self.timeout = host, port, timeout

    def _conn(self):
        import http.client
        return http.client.HTTPConnection(self.host, self.port,
                                          timeout=self.timeout)

    def _post(self, path: str, body: Optional[dict] = None) -> dict:
        c = self._conn()
        try:
            payload = json.dumps(body or {})
            c.request("POST", path, payload,
                      {"Content-Type": "application/json"})
            return json.loads(c.getresponse().read())
        finally:
            c.close()

    def _get(self, path: str) -> dict:
        c = self._conn()
        try:
            c.request("GET", path)
            return json.loads(c.getresponse().read())
        finally:
            c.close()

    def submit(self, req: Request, **over) -> int:
        body = dict(system_tokens=req.system_tokens.tolist(),
                    chunk_tokens=[c.tolist() for c in req.chunk_tokens],
                    question_tokens=req.question_tokens.tolist(),
                    max_new_tokens=req.max_new_tokens,
                    tenant=req.tenant, deadline_s=req.deadline_s,
                    session=req.session, turn=req.turn)
        body.update(over)
        return int(self._post("/v1/submit", body)["rid"])

    def stream(self, rid: int, on_token=None):
        """Read the NDJSON stream to completion. Returns
        ``(tokens, final_state)``; ``on_token(tok)`` fires per line as
        it arrives (incrementality assertions hook here)."""
        c = self._conn()
        try:
            c.request("GET", f"/v1/stream/{rid}")
            resp = c.getresponse()
            tokens, state = [], None
            for line in resp:
                if not line.strip():
                    continue
                ev = json.loads(line)
                if "token" in ev:
                    tokens.append(ev["token"])
                    if on_token is not None:
                        on_token(ev["token"])
                elif ev.get("done"):
                    state = ev.get("state")
            return tokens, state
        finally:
            c.close()

    def cancel(self, rid: int) -> bool:
        return bool(self._post(f"/v1/cancel/{rid}").get("cancelled"))

    def health(self) -> dict:
        return self._get("/health")

    def stats(self) -> dict:
        return self._get("/stats")
