"""Wrapper of the RoPE kernel (``csrc/rope.cu``).

CPU tensors go through the plain version (``ref.py``); CUDA tensors
launch the kernel or raise: there is no fallback on the card.
``rope.launches`` counts kernel launches (never the CPU path).
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.rope.ref import rope_ref
from repro_torch.models.layers import _inv_freq

_FLOATS = (torch.float32, torch.bfloat16)
# (D, theta, device) -> the D/2 fp32 frequencies, uploaded once
_FREQS: Dict[Tuple[int, float, torch.device], torch.Tensor] = {}


def _fn():
    fn = build.load("rope").rope_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _freqs(D: int, theta: float, dev: torch.device) -> torch.Tensor:
    key = (D, float(theta), dev)
    f = _FREQS.get(key)
    if f is None:
        f = torch.from_numpy(_inv_freq(D, theta).astype("float32")).to(dev)
        _FREQS[key] = f
    return f


def rope(x, pos, *, theta: float, inverse: bool = False):
    """Rotate ``x`` at ``pos`` (``inverse=True`` removes the rotation).

    ``x [T,H,D]`` with ``pos [T]``; or ``x [B,T,H,D]`` with ``pos [B,T]``
    or ``pos [T]`` (shared by every row), the batch folded into T. Returns
    a new tensor of x's shape and type."""
    what = "rope"
    if x.dim() not in (3, 4):
        raise ValueError(f"{what}: x must be [T,H,D] or [B,T,H,D], got "
                         f"{tuple(x.shape)}")
    shape = x.shape
    *lead, H, D = shape
    n_rows = 1
    for s in lead:
        n_rows *= s
    T = lead[-1]
    if tuple(pos.shape) not in (tuple(lead), (T,)):
        raise ValueError(f"{what}: pos shape {tuple(pos.shape)} does not "
                         f"match x {tuple(shape)}")
    if D % 2:
        raise ValueError(f"{what}: head dim {D} is odd")
    if x.device.type == "cpu":
        p = pos.expand(*lead).reshape(n_rows)
        return rope_ref(x.reshape(n_rows, H, D), p, theta=theta,
                        inverse=inverse).reshape(shape)
    if x.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {x.device}")
    dev = x.device
    build.check_no_grad(what, x=x)
    build.check_tensor(what, "x", x, shape, _FLOATS, dev)
    build.check_tensor(what, "pos", pos, pos.shape, (torch.int32,), dev)
    out = torch.empty_like(x)
    if n_rows == 0:
        return out
    err = _fn()(x.data_ptr(), pos.data_ptr(),
                _freqs(D, theta, dev).data_ptr(), out.data_ptr(), n_rows,
                H, D, pos.numel(), int(inverse),
                int(x.dtype == torch.bfloat16),
                torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, what)
    rope.launches += 1
    return out


rope.launches = 0
