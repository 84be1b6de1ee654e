"""The port's launcher boots its HTTP server: ``python -m
repro_torch.launch.serve --serve`` in a subprocess, driven by
``ServeClient`` over a real socket, stopped by an interrupt. On the host
with ``--device cpu`` (tiny config); on the card with the default device
and the full-size config through the kernel backend (``cuda``-marked,
skips without a GPU). This file imports neither jax nor the reference
package, so it also runs on a GPU host::

    PYTHONPATH=src python -m pytest --noconftest -m cuda \\
        tests/test_torch_kernels_cuda.py tests/test_torch_launch.py"""
import os
import queue
import re
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, get_tiny
from repro_torch.serving.request import Request, State
from repro_torch.serving.server import ServeClient

SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")
BOOT_S = 180.0           # process start, weights, first kernel builds


def _serve_once(args, vocab, device_word):
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "repro_torch.launch.serve", "--serve",
         "--port", "0", *args], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=env)
    lines: "queue.Queue[str]" = queue.Queue()
    threading.Thread(target=lambda: [lines.put(ln) for ln in proc.stdout],
                     daemon=True).start()
    out = []
    try:
        deadline = time.monotonic() + BOOT_S
        url = None
        while url is None and time.monotonic() < deadline:
            try:
                ln = lines.get(timeout=1.0)
            except queue.Empty:
                assert proc.poll() is None, "".join(out)
                continue
            out.append(ln)
            m = re.search(r"on (\S+) at http://([\d.]+):(\d+)", ln)
            if m:
                url = m
        assert url is not None, "".join(out)
        assert url.group(1).startswith(device_word), ln
        client = ServeClient(url.group(2), int(url.group(3)),
                             timeout=BOOT_S)
        assert client.health()["ok"]
        rng = np.random.default_rng(0)
        req = Request(rid=0,
                      system_tokens=rng.integers(0, vocab, 8).astype(
                          np.int32),
                      chunk_tokens=[rng.integers(0, vocab, 16).astype(
                          np.int32) for _ in range(2)],
                      question_tokens=rng.integers(0, vocab, 6).astype(
                          np.int32),
                      max_new_tokens=3)
        toks, state = client.stream(client.submit(req))
        assert state == State.DONE.value and len(toks) == 3
        assert all(0 <= t < vocab for t in toks)
        stats = client.stats()
        assert stats["server"]["inflight"] == 0
        assert stats["pool"]["reserved_blocks"] == 0
    finally:
        if proc.poll() is None:
            proc.send_signal(signal.SIGINT)
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)
    while not lines.empty():
        out.append(lines.get())
    assert "shutting down" in "".join(out), "".join(out)


def test_serve_boots_on_host_when_asked():
    _serve_once(["--device", "cpu"], get_tiny("llama3-8b").vocab_size,
                "cpu")


@pytest.mark.cuda
def test_serve_boots_on_card_by_default():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the launcher's default device)")
    _serve_once(["--full", "--attn-impl", "kernel"],
                get_config("llama3-8b").vocab_size, "cuda")
