"""Wrapper of the SSD intra-chunk kernel (``csrc/ssd.cu``).

CPU tensors go through the plain version (``ref.py``); CUDA tensors
launch the kernel or raise: there is no fallback on the card.
``ssd_intra.launches`` counts kernel launches (never the CPU path).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ssd.ref import ssd_intra_ref

_FLOATS = (torch.float32, torch.bfloat16)
# shared memory of one CTA, the kernel's plan (csrc/ssd.cu, smem_floats):
# a row block of C and of the masked decay*scores, transposed with a row
# stride of _TRP ([N][_TRP], [L][_TRP]), xdt [L][P rounded up to 4], B
# [L][N+1], log_a and the column sums of the log-decay [L]
_TRP = 68
_SMEM_MAX = 232448            # bytes a CTA may opt into on sm_90


def smem_bytes(L: int, N: int, P: int) -> int:
    p4 = (P + 3) // 4 * 4
    return 4 * (N * _TRP + L * _TRP + L * p4 + L * (N + 1) + 2 * L)


def _fn():
    fn = build.load("ssd").ssd_intra_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def ssd_intra(xdt, log_a, B_mat, C_mat):
    """Intra-chunk SSD. xdt [nC,L,H,P] (x pre-multiplied by dt), log_a
    [nC,L,H], B_mat/C_mat [nC,L,N]; or each with a leading batch axis
    ``[Bsz, nC, ...]``, folded into the chunk axis.

    Returns ``(y_intra [.., nC,L,H,P] fp32, chunk_state [.., nC,H,P,N]
    fp32)``."""
    what = "ssd_intra"
    lead = xdt.shape[:-4]
    if len(lead) > 1:
        raise ValueError(f"{what}: xdt must be 4-D or 5-D, got "
                         f"{tuple(xdt.shape)}")
    if lead:
        xdt, log_a, B_mat, C_mat = (t.flatten(0, 1) for t in
                                    (xdt, log_a, B_mat, C_mat))
    nC, L, H, P = xdt.shape
    N = B_mat.shape[-1]
    if xdt.device.type == "cpu":
        y, st = ssd_intra_ref(xdt, log_a, B_mat, C_mat)
    elif xdt.device.type == "cuda":
        dev = xdt.device
        build.check_tensor(what, "xdt", xdt, (nC, L, H, P), _FLOATS, dev)
        build.check_tensor(what, "log_a", log_a, (nC, L, H), (xdt.dtype,),
                           dev)
        for name, t in (("B_mat", B_mat), ("C_mat", C_mat)):
            build.check_tensor(what, name, t, (nC, L, N), (xdt.dtype,), dev)
        smem = smem_bytes(L, N, P)
        if smem > _SMEM_MAX:
            raise ValueError(
                f"{what}: chunk length L={L} with N={N}, P={P} needs {smem} "
                f"bytes of shared memory per CTA, more than the {_SMEM_MAX} "
                "an sm_90 CTA can hold; use a shorter chunk (ssd_chunk)")
        y = torch.empty((nC, L, H, P), dtype=torch.float32, device=dev)
        st = torch.empty((nC, H, P, N), dtype=torch.float32, device=dev)
        err = _fn()(xdt.data_ptr(), log_a.data_ptr(), B_mat.data_ptr(),
                    C_mat.data_ptr(), y.data_ptr(), st.data_ptr(),
                    nC, L, H, P, N, int(xdt.dtype == torch.bfloat16),
                    torch.cuda.current_stream(dev).cuda_stream)
        build.check(err, what)
        ssd_intra.launches += 1
    else:
        raise ValueError(f"{what}: no kernel for device {xdt.device}")
    if lead:
        y = y.unflatten(0, (lead[0], -1))
        st = st.unflatten(0, (lead[0], -1))
    return y, st


ssd_intra.launches = 0
