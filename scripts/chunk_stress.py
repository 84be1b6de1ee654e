"""Stress the chunk-attention kernel at one small shape on the card.

The shape is the first case of ``tests/test_torch_kernels_cuda.py``'s
``CHUNK_CASES`` (A 16, S 64, H 4/4, D 32, C 8; the wrapper picks 2 key
ranges in fp32), where a card run once read 6.7e-5 from the plain
version on 7 of 2,048 outputs. Each child process launches it first
thing after CUDA starts, through the wrapper as the test does, then 64
times more, then through the C entry point with the key split forced to
1 and 2 ranges in fp32 (bf16 has one 64-key tile here, so one range) on
a NaN-poisoned workspace, output and mass, 8 times each. Every output
must be within 3e-5 (bf16 3e-2) of the plain version run on the card on
the same inputs, the first launch also of a float64 version (numpy),
and the launches of a route must give the same bytes.

Each child also records the plain version run on the host CPU against
the float64 one (``host_plain_vs_fp64``): on the card's machine that
first host product in a process came out ~1e-4 off now and then, while
the kernel matched float64 (ROADMAP C8); the count of such processes is
printed, and is not a failure of the kernel.

    PYTHONPATH=src python3 scripts/chunk_stress.py --runs 240 --jobs 8
    PYTHONPATH=src python3 scripts/chunk_stress.py --child
    PYTHONPATH=src python3 scripts/chunk_stress.py --sanitize

The parent prints one JSON line per failing child and a summary line;
``--sanitize`` runs one child under ``compute-sanitizer`` with each of
``racecheck``, ``synccheck``, ``initcheck`` and ``memcheck`` and prints
the tool's summary. Exit code 0 only when every child passed.
"""
from __future__ import annotations

import argparse
import concurrent.futures as cf
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

A, S, H, HKV, D, C = 16, 64, 4, 4, 32, 8
TOL = {"float32": 3e-5, "bfloat16": 3e-2}
REPEATS = 8          # launches of each forced route in one child
INPROC = 64          # launches of the wrapper's route after the first


def inputs(seed=A + S):
    """The test's inputs (``_chunk_inputs(A + S, ...)``) as numpy."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(A, H, D)).astype(np.float32)
    k = rng.normal(size=(S, HKV, D)).astype(np.float32)
    v = rng.normal(size=(S, HKV, D)).astype(np.float32)
    qpos = np.sort(rng.choice(S, A, replace=False)).astype(np.int32)
    kpos = np.arange(S, dtype=np.int32)
    kpos[-S // 8:] = -1
    kch = np.minimum(np.maximum(kpos, 0) * C // S, C - 1).astype(np.int32)
    return q, k, v, qpos, kpos, kch


def ref64():
    """The attention output in float64 with numpy, [A, H, D] (one query
    head per KV head here)."""
    q, k, v, qpos, kpos, _ = inputs()
    q, k, v = (x.astype(np.float64) for x in (q, k, v))
    s = np.einsum("ahd,shd->has", q, k) / np.sqrt(D)
    ok = (qpos[:, None] >= kpos[None, :]) & (kpos[None, :] >= 0)
    s = np.where(ok[None], s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("has,shd->ahd", p, v)


def _bad(x, ref, tol):
    """(max abs error, outputs outside rtol = atol = tol, the first
    indices) of tensor ``x`` against ``ref`` (a tensor or an array)."""
    x = x.detach().float().cpu().double().numpy()
    if not isinstance(ref, np.ndarray):
        ref = ref.detach().float().cpu().double().numpy()
    err = np.abs(x - ref)
    bad = ~(err <= tol + tol * np.abs(ref))
    return float(np.nan_to_num(err, nan=np.inf).max()), int(bad.sum()), \
        np.argwhere(bad)[:8].tolist()


def _bits(x):
    import torch
    return x.view(torch.int16 if x.element_size() == 2 else torch.int32)


def launch_raw(ts, nsplit):
    """One launch through the C entry point with ``nsplit`` key ranges on
    a workspace, output and mass that start as NaN."""
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels.chunk_attention import ops as cops
    q, k, v, qpos, kpos, kch, qseg, kseg = ts
    dev = q.device
    out = torch.full_like(q, float("nan"))
    work = torch.full((cops.workspace_floats(1, A, H, HKV, D, C, nsplit),),
                      float("nan"), dtype=torch.float32, device=dev)
    mass = torch.full((1, A, C), float("nan"), dtype=torch.float32,
                      device=dev)
    err = cops._lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      qpos.data_ptr(), kpos.data_ptr(), kch.data_ptr(),
                      qseg.data_ptr(), kseg.data_ptr(), out.data_ptr(),
                      work.data_ptr(), mass.data_ptr(), 1, A, S, H, HKV, D,
                      C, 0, int(q.dtype == torch.bfloat16), nsplit,
                      torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "chunk_attention")
    return out, mass


def child() -> dict:
    import torch

    from repro_torch import device as devmod
    from repro_torch.kernels.chunk_attention import ops as cops
    from repro_torch.kernels.chunk_attention.ref import chunk_attention_ref
    dev = devmod.resolve("cuda")
    np_in = inputs()
    rec = {"pid": os.getpid(), "ok": True, "routes": {}}

    def tensors(dt, device):
        out = []
        for x in np_in:
            t = torch.from_numpy(x)[None].to(device)
            out.append(t.to(dt) if t.is_floating_point() else t)
        out.append(torch.zeros_like(out[3]))       # q_seg
        out.append(torch.zeros_like(out[4]))       # k_seg
        return out

    def plain(ts):
        """The plain version on ``ts``'s device, batch row 0."""
        o, m = chunk_attention_ref(*[t[0] for t in ts[:6]], num_chunks=C)
        return o[None], m[None]

    # 1. the first launch of the process, through the wrapper, against
    # the plain version on the card and float64
    ts = tensors(torch.float32, dev)
    o, m = cops.chunk_attention(*ts[:6], num_chunks=C)
    torch.cuda.synchronize()
    o_r, m_r = plain(ts)
    o64 = ref64()[None]
    tol = TOL["float32"]
    first = {"nsplit": cops.num_splits(1, A, S, H, HKV, torch.float32),
             "out": _bad(o, o_r, tol), "mass": _bad(m, m_r, tol),
             "out_vs_fp64": _bad(o, o64, tol)}
    o_h, _ = plain(tensors(torch.float32, "cpu"))
    first["host_plain_vs_fp64"] = _bad(o_h, o64, tol)
    rec["first"] = first
    rec["ok"] &= all(first[k][1] == 0 for k in ("out", "mass", "out_vs_fp64"))
    # 2. the same call again: the same bytes
    again = [cops.chunk_attention(*ts[:6], num_chunks=C)
             for _ in range(INPROC)]
    torch.cuda.synchronize()
    rec["again_bytes_equal"] = all(
        torch.equal(_bits(o2), _bits(o)) and torch.equal(_bits(m2), _bits(m))
        for o2, m2 in again)
    rec["ok"] &= rec["again_bytes_equal"]
    # 3. forced routes on poisoned buffers, repeated
    for name in ("float32", "bfloat16"):
        dt = getattr(torch, name)
        ts = tensors(dt, dev)
        o_r, m_r = plain(ts)
        tiles = -(-S // (32 if name == "float32" else 64))
        for ns in range(1, min(2, tiles) + 1):
            outs = [launch_raw(ts, ns) for _ in range(REPEATS)]
            torch.cuda.synchronize()
            worst = [0.0, 0]
            for ox, mx in outs:
                for x, r in ((ox, o_r), (mx, m_r)):
                    e, n, _ = _bad(x, r, TOL[name])
                    worst = [max(worst[0], e), worst[1] + n]
            same = all(torch.equal(_bits(ox), _bits(outs[0][0]))
                       and torch.equal(_bits(mx), _bits(outs[0][1]))
                       for ox, mx in outs)
            rec["routes"][f"{name}/{ns}"] = {"max_err": worst[0],
                                             "bad": worst[1],
                                             "bytes_equal": bool(same)}
            rec["ok"] &= worst[1] == 0 and same
    return rec


def _run_child(env):
    t0 = time.time()
    p = subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--child"], env=env, capture_output=True, text=True,
                       timeout=300)
    lines = p.stdout.strip().splitlines()
    try:
        rec = json.loads(lines[-1])
    except (IndexError, json.JSONDecodeError):
        rec = {"ok": False, "stderr": p.stderr[-2000:]}
    rec["rc"], rec["s"] = p.returncode, round(time.time() - t0, 2)
    return rec


def stress(runs: int, jobs: int) -> dict:
    """``runs`` fresh child processes, ``jobs`` at a time."""
    from repro_torch.kernels import build
    build.build_all(["chunk_attention"])      # children load the library
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                      "src"), env.get("PYTHONPATH", "")])
    n_ok, n_fail, host_off, worst = 0, 0, 0, 0.0
    with cf.ThreadPoolExecutor(jobs) as ex:
        for rec in ex.map(lambda _: _run_child(env), range(runs)):
            if rec.get("ok") and rec["rc"] == 0:
                n_ok += 1
            else:
                n_fail += 1
                print(json.dumps(rec), flush=True)
            first = rec.get("first")
            if first:
                worst = max(worst, first["out_vs_fp64"][0])
                host_off += first["host_plain_vs_fp64"][1] > 0
    return {"runs": runs, "passed": n_ok, "failed": n_fail,
            "first_launch_max_err_vs_fp64": worst,
            "host_plain_off_processes": host_off}


def sanitize() -> dict:
    tool = shutil.which("compute-sanitizer") or \
        "/usr/local/cuda/bin/compute-sanitizer"
    if not os.path.exists(tool):
        return {"compute-sanitizer": "not found"}
    from repro_torch.kernels import build
    build.build_all(["chunk_attention"])
    res = {}
    for t in ("racecheck", "synccheck", "initcheck", "memcheck"):
        cmd = [tool, "--tool", t, sys.executable, os.path.abspath(__file__),
               "--child"]
        try:
            p = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=300)
            text = p.stdout + p.stderr
            res[t] = {"rc": p.returncode, "summary": [
                ln for ln in text.splitlines() if "SUMMARY" in ln
                or "Error" in ln or "Hazard" in ln][:20]}
        except subprocess.TimeoutExpired:
            res[t] = {"rc": None, "summary": ["timed out after 300 s"]}
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--child", action="store_true")
    ap.add_argument("--sanitize", action="store_true")
    ap.add_argument("--runs", type=int, default=240)
    ap.add_argument("--jobs", type=int, default=8)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chunk_stress: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    if args.child:
        rec = child()
        print(json.dumps(rec))
        return 0 if rec["ok"] else 1
    if args.sanitize:
        print(json.dumps(sanitize(), indent=1))
        return 0
    res = stress(args.runs, args.jobs)
    print(json.dumps(res))
    return 0 if res["failed"] == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
