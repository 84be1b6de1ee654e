#!/usr/bin/env python3
"""Where the train step's time goes on an NVIDIA GPU.

    PYTHONPATH=src python3 scripts/train_profile.py

The train step of ``chip_smoke.py``'s phase 5 (global batch 4 x 1024
synthetic tokens, ``accum`` 2, AdamW; fp32, TF32 off) for full-width
mamba2-370m (48 layers) and full-width llama3-8b cut to 2 layers: one
warm-up step, then two steps under ``torch.profiler``. Prints, per
model, the steps' wall time, the device's busy share over that window
(kernel, copy and memset durations summed over the wall time), its
device time by class and the 15 kernels with the most device time.
Needs a card.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

_CLASSES = (
    ("matrix products", ("gemm", "gemv", "cutlass", "cublas", "matmul",
                         "dot_kernel", "sm90_xmma", "ampere_sgemm")),
    ("softmax / log-softmax", ("softmax",)),
    ("reductions", ("reduce", "scan", "cumsum")),
    ("index / embedding", ("index", "embedding", "gather", "scatter")),
    ("copies", ("memcpy", "memset", "copy")),
)


def _class(name: str) -> str:
    low = name.lower()
    for cls, keys in _CLASSES:
        if any(k in low for k in keys):
            return cls
    return "elementwise and other"


def profile(cfg, dev, steps=2):
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    import chip_smoke
    state, step, batch = chip_smoke._train_setup(cfg, dev)
    state, _ = step(state, batch(0))          # warm-up
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(1, 1 + steps):
            state, m = step(state, batch(i))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev_events = [ev for ev in prof.key_averages()
                  if ev.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(float(ev.self_device_time_total) for ev in dev_events) / 1e6
    by_class = {}
    for ev in dev_events:
        c = _class(ev.key)
        by_class[c] = by_class.get(c, 0.0) + ev.self_device_time_total / 1e3
    top = sorted(dev_events, key=lambda ev: -ev.self_device_time_total)[:15]
    out = dict(model=cfg.name, layers=cfg.num_layers, steps=steps,
               step_ms_wall=wall * 1e3 / steps,
               device_busy_share=busy / wall,
               device_ms_per_step=busy * 1e3 / steps,
               kernel_launches_per_step=sum(ev.count for ev in dev_events)
               / steps,
               device_ms_per_step_by_class={
                   k: v / steps for k, v in sorted(by_class.items(),
                                                   key=lambda kv: -kv[1])},
               top_kernels_ms_per_step=[
                   (ev.key[:90], ev.count // steps,
                    ev.self_device_time_total / 1e3 / steps) for ev in top],
               loss=float(m["loss"]))
    del state, step
    return out


def main():
    import torch

    from repro_torch import device as devmod
    from repro_torch.configs import get_config
    dev = devmod.resolve("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(f"card: {smi.stdout.strip()} ({torch.cuda.get_device_name(0)})",
          flush=True)
    for cfg in (get_config("mamba2-370m"),
                get_config("llama3-8b").replace(num_layers=2)):
        print(json.dumps(profile(cfg, dev)), flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
