#!/usr/bin/env python3
"""Where the SSD intra-chunk kernel's time goes on an NVIDIA GPU.

    PYTHONPATH=src python3 scripts/ssd_profile.py

Two measurements at mamba2-370m's prefill shape (nC 60, L 128, H 32,
P 64, N 128; ``chip_smoke.ssd_inputs``), fp32 and bf16:

1. ``mma.sync`` throughput of the two shapes the kernel issues (m16n8k8
   TF32, m16n8k16 bf16), with 1 and 8 independent accumulators per warp
   and 8 or 16 warps per SM on every SM: the ceiling of the kernel's
   per-head products on this route.
2. Clock cycles per CTA of each phase of ``ssd_intra_kernel``: a copy of
   ``kernels/ssd/csrc/ssd.cu`` with a ``__syncthreads`` and a
   ``clock64`` read (thread 0, summed over CTAs) between its phases,
   built and launched once at the wrapper's heads per CTA. The extra
   barrier between the two products makes the copy a few percent slower
   than the kernel.

Builds go to ``build/ssd_profile/`` (gitignored). Needs nvcc and a card.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

MMA_BENCH = r"""
#include <cuda_runtime.h>
#include <stdint.h>
template <int BF, int CH>
__global__ void bench(float* out, int iters) {
  float acc[CH][4] = {};
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = 0x3f800000u + threadIdx.x + i;
  b[0] = 0x3f800000u + threadIdx.x; b[1] = b[0] + 7;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      if (BF)
        asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+f"(acc[c][0]), "+f"(acc[c][1]), "+f"(acc[c][2]), "+f"(acc[c][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
      else
        asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+f"(acc[c][0]), "+f"(acc[c][1]), "+f"(acc[c][2]), "+f"(acc[c][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
    }
  }
  float s = 0.f;
  for (int c = 0; c < CH; ++c) for (int e = 0; e < 4; ++e) s += acc[c][e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int run(int bf, int chains, float* out, int iters, int blocks,
                   int threads) {
  if (bf) {
    if (chains == 1) bench<1, 1><<<blocks, threads>>>(out, iters);
    else bench<1, 8><<<blocks, threads>>>(out, iters);
  } else {
    if (chains == 1) bench<0, 1><<<blocks, threads>>>(out, iters);
    else bench<0, 8><<<blocks, threads>>>(out, iters);
  }
  return (int)cudaGetLastError();
}
"""

PHASES = ("staging and prefix sums", "scores S", "xdt waits",
          "next xdt issue", "decay factors", "y product", "state product")
# (anchor in ssd.cu, text put in its place): a barrier and a clock read
# between phases
PROBES = [
    ("namespace {\n\nconstexpr int WARPS",
     "__device__ unsigned long long g_phase[8];\nnamespace {\n\n"
     "constexpr int WARPS"),
    ("  unsigned char* sm = dyn_smem();",
     "  long long t0 = clock64(), t1;\n"
     "#define TICK(k) __syncthreads(); t1 = clock64(); if (threadIdx.x == 0)"
     " atomicAdd(&g_phase[k], (unsigned long long)(t1 - t0)); t0 = t1;\n"
     "  unsigned char* sm = dyn_smem();"),
    ("  cp_async_wait<0>();\n  __syncthreads();\n"
     "  form_scores(pl, c_s, b_s, s_s, N);\n  __syncthreads();",
     "  cp_async_wait<0>();\n  TICK(0)\n"
     "  form_scores(pl, c_s, b_s, s_s, N);\n  TICK(1)"),
    ("    cp_async_wait<0>();\n    __syncthreads();",
     "    cp_async_wait<0>();\n    TICK(2)"),
    ("    head_factors(", "    TICK(3)\n    head_factors("),
    ("    __syncthreads();   // M (and XW) of head hh\n    head_y(",
     "    TICK(4)\n    head_y("),
    ("    head_state(", "    TICK(5)\n    head_state("),
    ("               N);\n  }\n}", "               N);\n    TICK(6)\n  }\n}"),
]
READ = r"""
extern "C" int ssd_phase_read(unsigned long long* out, int reset) {
  cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase));
  if (reset) {
    unsigned long long z[8] = {0};
    cudaMemcpyToSymbol(g_phase, z, sizeof(z));
  }
  return 0;
}
"""


def _nvcc(src_text, name, out_dir):
    from repro_torch.kernels import build
    src = os.path.join(out_dir, f"{name}.cu")
    so = os.path.join(out_dir, f"lib{name}.so")
    with open(src, "w") as f:
        f.write(src_text)
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", so, src],
                   check=True, capture_output=True, text=True)
    return ctypes.CDLL(so)


def mma_throughput(lib):
    import torch
    fn = lib.run
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(sms * 512, device="cuda")
    iters = 4096
    for bf, shape in ((0, "m16n8k8 tf32"), (1, "m16n8k16 bf16")):
        for chains in (1, 8):
            for threads in (256, 512):
                fn(bf, chains, out.data_ptr(), 16, sms, threads)
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                fn(bf, chains, out.data_ptr(), iters, sms, threads)
                e1.record()
                torch.cuda.synchronize()
                ms = e0.elapsed_time(e1)
                n = sms * threads // 32 * iters * chains
                flop = n * (4096 if bf else 2048)
                print(f"mma.sync {shape}: {chains} accumulator(s) per warp, "
                      f"{threads // 32} warps per SM: {flop / ms / 1e9:.1f} "
                      f"TFLOP/s, {n / sms / ms:.0f} mma per ms per SM",
                      flush=True)


def phase_cycles(lib):
    import numpy as np
    import torch

    import chip_smoke
    from repro_torch.kernels.ssd import ops as sops
    lib = sops.bind(lib)
    lib.ssd_phase_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    si = chip_smoke.ssd_inputs(np.random.default_rng(1),
                               torch.device("cuda"))
    nC, L, H, P = si["xdt"].shape
    N = si["B"].shape[-1]
    buf = (ctypes.c_ulonglong * 8)()
    for dt_name in ("float32", "bfloat16"):
        dt = getattr(torch, dt_name)
        args = [si[k].to(dt) for k in ("xdt", "log_a", "B", "C")]
        hg = sops.heads_per_cta(nC, L, H, P, N, dt)
        y = torch.empty((nC, L, H, P), device="cuda")
        st = torch.empty((nC, H, P, N), device="cuda")

        def launch():
            err = lib.ssd_intra_fwd(
                *[a.data_ptr() for a in args], y.data_ptr(), st.data_ptr(),
                nC, L, H, P, N, int(dt == torch.bfloat16), hg,
                torch.cuda.current_stream().cuda_stream)
            assert err == 0, err
        launch()
        torch.cuda.synchronize()
        lib.ssd_phase_read(buf, 1)
        launch()
        torch.cuda.synchronize()
        lib.ssd_phase_read(buf, 1)
        ctas = nC * -(-H // hg)
        per = [buf[k] / ctas for k in range(len(PHASES))]
        print(f"ssd_intra {dt_name} heads_per_cta={hg}: cycles per CTA "
              + ", ".join(f"{n} {v:.0f}" for n, v in zip(PHASES, per))
              + f"; total {sum(per):.0f}", flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("ssd_profile: needs a CUDA card", file=sys.stderr)
        return 2
    out_dir = os.path.join(ROOT, "build", "ssd_profile")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(ROOT, "src", "repro_torch", "kernels", "ssd",
                           "csrc", "ssd.cu")) as f:
        src = f.read()
    for anchor, text in PROBES:
        if anchor not in src:
            raise RuntimeError(f"ssd_profile: probe anchor not in ssd.cu: "
                               f"{anchor!r}")
        src = src.replace(anchor, text, 1)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    mma_throughput(_nvcc(MMA_BENCH, "mma_bench", out_dir))
    phase_cycles(_nvcc(src + READ, "ssd_phases", out_dir))
    return 0


if __name__ == "__main__":
    sys.exit(main())
