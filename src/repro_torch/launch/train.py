"""Training launcher of the port: checkpoint / auto-resume, async saves,
stall watchdog (``repro/launch/train.py``)::

    python -m repro_torch.launch.train --tiny --steps 200       # H100
    python -m repro_torch.launch.train --tiny --device cpu --steps 20
    python -m repro_torch.launch.train --tiny --steps 400 --resume

Fault-tolerance contract: the process exits non-zero on a stall (no step
completed within ``--watchdog-sec``: exit code 42) or a crash; a
supervisor restarts it and ``--resume`` picks up from the latest atomic
checkpoint in ``--ckpt-dir``. Batches are a pure function of (seed,
step), so a resumed run sees the batches the straight run would have.
Runs on the GPU unless ``--device cpu``; the weights are initialised
from ``--seed``. The checkpoints are in the reference's format and serve
through ``launch/serve.py --params <ckpt-dir>``. One process, one
device: the int8 error-feedback all-reduce (``distributed/compression.py``)
and the mesh makers (``launch/mesh.py``) are ported, training over a
multi-process mesh is not (ROADMAP A10).
"""
from __future__ import annotations

import argparse
import os
import sys
import threading
import time

import torch

from repro_torch import device as devmod
from repro_torch.configs import get_config, get_tiny
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.data import DataConfig, SyntheticLM
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.steps import (init_train_state, make_train_step,
                                        state_to_tree, tree_to_state)


class Watchdog:
    """Exits the process if no heartbeat arrives within ``timeout_s``:
    turns silent stalls (a wedged device or host) into fast restarts."""

    def __init__(self, timeout_s: float):
        self.timeout_s = timeout_s
        self.last = time.monotonic()
        self._stop = False
        self.thread = threading.Thread(target=self._loop, daemon=True)

    def start(self):
        if self.timeout_s > 0:
            self.thread.start()

    def beat(self):
        self.last = time.monotonic()

    def stop(self):
        self._stop = True

    def _loop(self):
        while not self._stop:
            time.sleep(min(5.0, self.timeout_s / 4))
            if time.monotonic() - self.last > self.timeout_s:
                print(f"WATCHDOG: no step in {self.timeout_s}s, exiting 42",
                      file=sys.stderr, flush=True)
                os._exit(42)


def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--tiny", action="store_true",
                    help="use the reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default="results/train_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--watchdog-sec", type=float, default=0.0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the initial weights")
    return ap


def main(argv=None):
    args = make_parser().parse_args(argv)
    dev = devmod.resolve(args.device)
    cfg = get_tiny(args.arch) if args.tiny else get_config(args.arch)
    data = SyntheticLM(DataConfig(seq_len=args.seq_len,
                                  global_batch=args.global_batch,
                                  vocab_size=cfg.vocab_size))
    opt_cfg = AdamWConfig(peak_lr=args.lr, warmup_steps=20,
                          total_steps=args.steps)
    step_fn = make_train_step(cfg, opt_cfg, accum=args.accum)

    start = 0
    if args.resume and ckpt.latest_step(args.ckpt_dir) is not None:
        state = tree_to_state(ckpt.restore(args.ckpt_dir), dev)
        start = int(state.step)
        print(f"resumed from step {start}", flush=True)
    else:
        gen = torch.Generator(device=dev)
        gen.manual_seed(args.seed)
        state = init_train_state(cfg, gen)

    dog = Watchdog(args.watchdog_sec)
    dog.start()
    save_thread = None
    metrics = None
    t0 = time.time()
    for i in range(start, args.steps):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in data.batch(i).items()}
        state, metrics = step_fn(state, batch)
        dog.beat()
        if (i + 1) % args.log_every == 0:
            toks = args.global_batch * args.seq_len * (i + 1 - start)
            print(f"step {i+1} loss {float(metrics['loss']):.4f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"tok/s {toks/(time.time()-t0):.0f}", flush=True)
        if (i + 1) % args.ckpt_every == 0 or i + 1 == args.steps:
            if save_thread is not None:
                save_thread.join()
            save_thread = ckpt.save(state_to_tree(state), args.ckpt_dir,
                                    i + 1, async_=True)
    if save_thread is not None:
        save_thread.join()
    dog.stop()
    final = "none" if metrics is None else f"{float(metrics['loss']):.4f}"
    print(f"done: {args.steps} steps on {dev}, final loss {final}")


if __name__ == "__main__":
    main()
