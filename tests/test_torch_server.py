"""The port's HTTP server (``repro_torch/serving/server.py``) on the CPU,
tiny llama3-8b with the JAX package's weights (``params_from_jax``).

Ported from the reference's server tests (``tests/test_server.py``):
streams over a real socket bit-identical to an offline replay of the
port's engine, a mid-decode cancel that leaves a strict prefix and no
reserved blocks, and garbage collection of streams nobody read. One
cross-package check: the port server's streams equal the JAX engine's
offline ``output_tokens`` on the same requests, wherever the JAX decode
logits' top-2 gap exceeds the parity tolerance. Every server is shut
down in ``finally`` and every client read times out in 30 s, so a hung
engine thread fails the test instead of stalling the run."""
import threading
import time

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_tiny as j_tiny
from repro.models import model as JM
from repro.serving.api import EngineSpec as JSpec
from repro.serving.api import build_engine as j_build
from repro.serving.request import Request as JRequest
from repro.serving.scheduler import SchedulerConfig as JSched
from repro_torch.configs import get_tiny
from repro_torch.launch import serve as launcher
from repro_torch.models import model as TM
from repro_torch.serving.api import EngineSpec, build_engine
from repro_torch.serving.rag import KnowledgeBase
from repro_torch.serving.request import Request, State
from repro_torch.serving.scheduler import SchedulerConfig
from repro_torch.serving.server import CacheCraftServer, ServeClient

torch.set_num_threads(2)
TIMEOUT = 30.0
GAP_TOL = 2e-4          # the port's engine-logit parity tolerance


@pytest.fixture(scope="module")
def world():
    cfg = get_tiny("llama3-8b")
    jcfg = j_tiny("llama3-8b")
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    params = TM.params_from_jax(cfg, jax.tree.map(np.asarray, jparams),
                                "cpu")
    kb = KnowledgeBase(num_chunks=12, vocab_size=cfg.vocab_size, seed=0)
    return cfg, params, kb, jcfg, jparams


def _sched(mod_sched):
    return mod_sched(max_batch_tokens=100_000, max_decode_batch=4,
                     max_prefill_batch=1)


def _engine(world, **kw):
    cfg, params = world[:2]
    spec = EngineSpec(strategy="all", use_focus=False, pool_blocks=512,
                      sched=_sched(SchedulerConfig), device="cpu", **kw)
    return build_engine(spec, cfg=cfg, params=params, store=None)


def _requests(kb, n=2, max_new=4, seed=5, cls=Request):
    rng = np.random.default_rng(seed)
    V = kb.vocab_size
    out = []
    for i in range(n):
        chunks = [kb.chunks[(2 * i) % len(kb.chunks)],
                  kb.chunks[(2 * i + 1) % len(kb.chunks)]]
        out.append(cls(
            rid=i, system_tokens=rng.integers(0, V, 8).astype(np.int32),
            chunk_tokens=[c.copy() for c in chunks],
            question_tokens=rng.integers(0, V, 10).astype(np.int32),
            max_new_tokens=max_new, arrival_time=0.0))
    return out


def _serve_all(server, reqs):
    """Submit every request, read every stream on its own thread; returns
    (streams, states) keyed by rid."""
    client = ServeClient(server.host, server.port, timeout=TIMEOUT)
    streams, states = {}, {}

    def reader(rid):
        streams[rid], states[rid] = client.stream(rid)

    threads = []
    for req in reqs:
        t = threading.Thread(target=reader, args=(client.submit(req),),
                             daemon=True)
        t.start()
        threads.append(t)
    for t in threads:
        t.join(timeout=2 * TIMEOUT)
    assert not any(t.is_alive() for t in threads)
    return client, streams, states


def test_http_server_end_to_end(world):
    kb = world[2]
    ref = _requests(kb, n=3, max_new=5)
    _engine(world).run(ref)

    server = CacheCraftServer(_engine(world)).start()
    try:
        client = ServeClient(server.host, server.port, timeout=TIMEOUT)
        assert client.health()["ok"]
        client, streams, states = _serve_all(server,
                                             _requests(kb, n=3, max_new=5))
        for rid, rr in enumerate(ref):
            assert states[rid] == State.DONE.value
            assert streams[rid] == rr.output_tokens        # bit-identical
        stats = client.stats()
        assert stats["server"]["submitted"] == 3
        assert stats["server"]["inflight"] == 0
        assert stats["pool"]["reserved_blocks"] == 0
        assert stats["server"]["engine_thread_alive"]
        assert "tenants" in stats
    finally:
        server.shutdown()
    assert not server._thread.is_alive()


def test_http_cancel_mid_decode(world):
    """Cancel one stream after its 2nd token while another decodes beside
    it: the cancelled stream is a strict prefix of its uncancelled run,
    the survivor's tokens are unchanged, and no block stays reserved."""
    kb = world[2]
    ref = _requests(kb, n=2, max_new=64)
    _engine(world).run(ref)
    server = CacheCraftServer(_engine(world)).start()
    try:
        client = ServeClient(server.host, server.port, timeout=TIMEOUT)
        reqs = _requests(kb, n=2, max_new=64)
        rid_c = client.submit(reqs[0])
        rid_s = client.submit(reqs[1])
        got = {}

        def survivor():
            got["s"] = client.stream(rid_s)

        t = threading.Thread(target=survivor, daemon=True)
        t.start()
        acc = []

        def on_token(tok):
            acc.append(tok)
            if len(acc) == 2:
                client.cancel(rid_c)

        toks, state = client.stream(rid_c, on_token=on_token)
        t.join(timeout=2 * TIMEOUT)
        assert not t.is_alive()
        assert state == State.CANCELLED.value
        assert 2 <= len(toks) < 64
        assert toks == ref[0].output_tokens[:len(toks)]
        assert got["s"] == (ref[1].output_tokens, State.DONE.value)
        stats = client.stats()
        assert stats["cancelled"] == 1
        assert stats["pool"]["reserved_blocks"] == 0
        assert stats["server"]["inflight"] == 0
    finally:
        server.shutdown()


def test_unread_streams_and_old_requests_are_garbage_collected(world):
    kb = world[2]
    server = CacheCraftServer(_engine(world), stream_ttl_s=0.0,
                              request_cap=1).start()
    try:
        client = ServeClient(server.host, server.port, timeout=TIMEOUT)
        reqs = _requests(kb, n=2, max_new=3)
        rid_a = client.submit(reqs[0])     # stream never opened
        deadline = time.monotonic() + TIMEOUT
        while time.monotonic() < deadline:
            if client.stats()["server"]["inflight"] == 0:
                break
            time.sleep(0.05)
        assert client.stats()["server"]["inflight"] == 0

        rid_b = client.submit(reqs[1])     # its dispatches drive the GC
        toks, state = client.stream(rid_b)
        assert state == State.DONE.value and len(toks) == 3
        with server._lock:
            assert rid_a not in server._streams      # TTL reap
            assert rid_a not in server._done_at
            assert rid_a not in server._requests     # cap eviction
    finally:
        server.shutdown()


def test_server_streams_match_jax_engine(world):
    """Cross-package: the port's HTTP streams against the JAX engine's
    offline run of the same requests and weights. Tokens must agree up
    to the first step where the JAX decode logits' top-2 gap is within
    the parity tolerance (a near tie either package may break its own
    way); at least one full stream must be compared."""
    _cfg, _params, kb, jcfg, jparams = world
    n, max_new = 4, 6
    jeng = j_build(JSpec(strategy="all", use_focus=False, pool_blocks=512,
                         attn_impl="dense", sched=_sched(JSched),
                         trace_decode=True),
                   cfg=jcfg, params=jparams, store=None)
    jreqs = _requests(kb, n=n, max_new=max_new, cls=JRequest)
    jeng.run(jreqs)
    per_rid = {}
    for step in jeng.decode_trace:
        for rid, lg in step.items():
            per_rid.setdefault(rid, []).append(np.asarray(lg))

    server = CacheCraftServer(_engine(world)).start()
    try:
        _client, streams, states = _serve_all(
            server, _requests(kb, n=n, max_new=max_new))
    finally:
        server.shutdown()
    full = 0
    for rid, jr in enumerate(jreqs):
        assert states[rid] == State.DONE.value
        mine, ref = streams[rid], list(jr.output_tokens)
        assert len(mine) == len(ref) == max_new
        assert mine[0] == ref[0], f"rid {rid}: first token differs"
        for i in range(1, max_new):
            if mine[i] != ref[i]:
                top2 = np.sort(per_rid[rid][i - 1])[-2:]
                assert top2[1] - top2[0] <= GAP_TOL, \
                    f"rid {rid} token {i}: diverged with top-2 gap " \
                    f"{top2[1] - top2[0]}"
                break
        else:
            full += 1
    assert full >= 1


def test_launcher_serve_flags():
    args = launcher.make_parser().parse_args(
        ["--serve", "--host", "0.0.0.0", "--port", "0", "--device", "cpu"])
    assert args.serve and args.host == "0.0.0.0" and args.port == 0
    assert args.device == "cpu"
    default = launcher.make_parser().parse_args([])
    assert not default.serve and default.device == "cuda"
    assert (default.host, default.port) == ("127.0.0.1", 8763)

