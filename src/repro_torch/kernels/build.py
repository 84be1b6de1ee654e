"""Build, load and call the port's CUDA kernels.

Every kernel source ``repro_torch/kernels/<name>/csrc/<name>.cu`` is
compiled by ``nvcc`` for ``sm_90a`` into a shared library with a plain C
interface, which ``ctypes`` loads::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/kernels/lib<name>-<hash>.so <name>.cu

Libraries go to ``build/kernels/`` at the root of the checkout (listed in
``.gitignore``), named by a hash of the source, so an edited source is
rebuilt and an unchanged one is reused. ``build_all`` starts one
``nvcc`` per source at once and waits for all of them; the first call of
a kernel's wrapper builds just that kernel if ``build_all`` has not run.
Nothing is built when a module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional, Sequence

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
KERNEL_NAMES = ("chunk_attention", "decode_attention", "rope", "ssd")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# per-kernel build record: seconds and the ptxas resource report
build_log: Dict[str, dict] = {}


def source(name: str) -> Path:
    return KERNELS_DIR / name / "csrc" / f"{name}.cu"


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin or /usr/local/cuda/bin): "
        "the port's CUDA kernels are built from source on the GPU host")


def _lib_path(name: str) -> Path:
    digest = hashlib.sha256(source(name).read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def _start(name: str):
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(source(name))]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), tmp, out


def build_all(names: Sequence[str] = KERNEL_NAMES) -> Dict[str, dict]:
    """Compile every named kernel in parallel (one ``nvcc`` each) and load
    it. Returns ``build_log``: per kernel the wall seconds of its build
    (0 when the library was already built) and ``nvcc``'s report."""
    with _lock:
        t0 = time.perf_counter()
        jobs = {n: _start(n) for n in names if n not in _libs}
        for name, job in jobs.items():
            if job is None:
                build_log.setdefault(name, {"seconds": 0.0, "log": ""})
                continue
            proc, tmp, out = job
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name} "
                                   f"(exit {proc.returncode}):\n{log}")
            os.replace(tmp, out)
            build_log[name] = {"seconds": time.perf_counter() - t0,
                               "log": log}
        for name in jobs:
            _libs[name] = ctypes.CDLL(str(_lib_path(name)))
        return build_log


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    lib: Optional[ctypes.CDLL] = _libs.get(name)
    if lib is None:
        build_all([name])
        lib = _libs[name]
    return lib


def check(err: int, what: str):
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError "
                           f"{err}")


def check_no_grad(what: str, **tensors):
    """Raise if autograd would need a backward through ``what``: the
    kernels compute forward only and write into fresh outputs that carry
    no ``grad_fn``, so a gradient through them would be lost silently.
    Run the call under ``torch.no_grad()``, or train through the model's
    differentiable route (``mode="train"``)."""
    import torch
    if not torch.is_grad_enabled():
        return
    need = [n for n, t in tensors.items() if t.requires_grad]
    if need:
        raise RuntimeError(
            f"{what}: the CUDA kernel has no backward, and input(s) "
            f"{', '.join(need)} require grad; call it under "
            "torch.no_grad() (training uses the differentiable route)")


# (q and out, K and V) element types the attention kernels' sources
# instantiate, by the type code their C entry points take: fp32, bf16, and
# bf16 q over fp32 K/V (a bf16 model over fp32 caches, as the reference's
# kernels take it)
ATTN_TYPES = {("float32", "float32"): 0, ("bfloat16", "bfloat16"): 1,
              ("bfloat16", "float32"): 2}
ATTN_TYPE_NAMES = {0: "float32", 1: "bfloat16", 2: "bfloat16 q / float32 kv"}


def attn_type_code(what: str, q, k, v, codes=(0, 1, 2)) -> int:
    """The type code of an attention call's (q, K/V) dtypes, one of
    ``codes``; raise ``TypeError`` naming the pairs the kernel takes on
    anything else (K and V of two dtypes included). The CPU path checks it
    too, so that it takes what the kernel takes."""
    def name(t):
        return str(t.dtype).replace("torch.", "")
    code = ATTN_TYPES.get((name(q), name(k)))
    if k.dtype != v.dtype or code not in codes:
        pairs = "; ".join(f"q {qn} with K and V {kn}"
                          for (qn, kn), c in ATTN_TYPES.items() if c in codes)
        raise TypeError(f"{what}: q {name(q)}, k {name(k)}, v {name(v)}: "
                        f"the kernel takes {pairs}")
    return code


def check_tensor(what: str, name: str, t, shape, dtypes, device):
    """Raise unless ``t`` is what a kernel's C entry point takes: on
    ``device``, one of ``dtypes``, exactly ``shape``, contiguous."""
    if t.device != device:
        raise ValueError(f"{what}: {name} on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{what}: {name} dtype {t.dtype} not in {dtypes}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: {name} shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: {name} is not contiguous")
