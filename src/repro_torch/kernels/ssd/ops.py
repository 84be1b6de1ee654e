"""Wrapper of the SSD intra-chunk kernel (``csrc/ssd.cu``).

CPU tensors go through the plain version (``ref.py``); CUDA tensors
launch the kernel or raise: there is no fallback on the card.
``ssd_intra.launches`` counts kernel launches (never the CPU path), and
``ssd_intra.launches_by_type`` the launches of each input dtype apart
(``ssd_chunked`` widens a bf16 model's inputs to fp32 before it, as the
reference does, so a bf16 model launches the fp32 instantiation).

One CTA takes one chunk and ``heads_per_cta`` of its heads: it forms the
chunk's scores C B^T once and reuses them for each of those heads.
"""
from __future__ import annotations

import collections
import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ssd.ref import ssd_intra_ref

_FLOATS = (torch.float32, torch.bfloat16)
_SMEM_MAX = 232448      # bytes a CTA may opt into on sm_90
_SMS = 132              # the H100's SMs (a design constant, not read
                        # from the device)
_HG = (8, 4, 2, 1)      # heads per CTA the rule picks from

_P, _I = ctypes.c_void_p, ctypes.c_int
_ABI = {
    # xdt, log_a, B, C, y, state; nC, L, H, P, N, is_bf16, hg; stream
    "ssd_intra_fwd": ([_P] * 6 + [_I] * 7 + [_P], _I),
    # L, N, P, hg, is_bf16
    "ssd_intra_smem_bytes": ([_I] * 5, ctypes.c_longlong),
    "ssd_intra_occupancy": ([_I] * 5, _I),   # not in emulated builds
}


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set argument and result types of every entry point ``lib`` has."""
    for name, (args, res) in _ABI.items():
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes, fn.restype = args, res
    return lib


def _r16(x: int) -> int:
    return (x + 15) // 16 * 16


def smem_bytes(L: int, N: int, P: int, hg: int,
               dtype=torch.float32) -> int:
    """Shared memory of one CTA, the kernel's plan (csrc/ssd.cu, Plan):
    fp64 prefix sums of log_a and fp32 chunk-state weights, [hg][LP]
    each; B [LP][NS]; S on the causal triangle in fragment order (nS (nS
    + 1) / 2 16 x 16 fp32 tiles); one head's exp(seg) . S in the same
    order (fp32, or three bf16 planes); bf16 only, one head's (xdt . w)^T
    as three bf16 planes [PP][LP]; C [LP][NS], whose place the ring of
    two xdt stages [2][LP][XS] takes after S is formed (the larger of the
    two). LP, PP, NP are L, P, N rounded up to 16, nS = LP / 16, NS = NP +
    8, XS = PP + 8, elements of the input type."""
    bf = dtype == torch.bfloat16
    e = 2 if bf else 4
    LP, PP, NS, XS = _r16(L), _r16(P), _r16(N) + 8, _r16(P) + 8
    nS = LP // 16
    tri = nS * (nS + 1) // 2 * 1024
    cmat = LP * NS * e
    return (12 * hg * LP + cmat + tri + (tri // 2 * 3 if bf else tri)
            + (6 * PP * LP if bf else 0) + max(cmat, 2 * LP * XS * e))


def heads_per_cta(nC: int, L: int, H: int, P: int, N: int,
                  dtype=torch.float32) -> int:
    """Heads of one chunk per CTA, from the shapes and dtype alone: the
    largest of 8, 4, 2, 1 (at most H) whose plan fits a CTA and whose grid
    of nC x ceil(H / hg) CTAs still fills the 132 SMs (one CTA of 16 warps
    per SM); else the smallest that fits. Each CTA forms the chunk's
    scores once for its hg heads."""
    fits = [hg for hg in _HG if hg <= H
            and smem_bytes(L, N, P, hg, dtype) <= _SMEM_MAX]
    for hg in fits:
        if nC * -(-H // hg) >= _SMS:
            return hg
    return fits[-1] if fits else 1


def _lib():
    lib = build.load("ssd")
    if lib.ssd_intra_fwd.argtypes is None:
        bind(lib)
    return lib.ssd_intra_fwd


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
        build.check_no_grad(what, xdt=xdt, log_a=log_a, B_mat=B_mat,
                            C_mat=C_mat)
        build.check_tensor(what, "xdt", xdt, (nC, L, H, P), _FLOATS, dev)
        build.check_tensor(what, "log_a", log_a, (nC, L, H), (xdt.dtype,),
                           dev)
        for name, t in (("B_mat", B_mat), ("C_mat", C_mat)):
            build.check_tensor(what, name, t, (nC, L, N), (xdt.dtype,), dev)
        hg = heads_per_cta(nC, L, H, P, N, xdt.dtype)
        smem = smem_bytes(L, N, P, hg, xdt.dtype)
        if smem > _SMEM_MAX:
            raise ValueError(
                f"{what}: chunk length L={L} with N={N}, P={P} needs {smem} "
                f"bytes of shared memory per CTA, more than the {_SMEM_MAX} "
                "an sm_90 CTA can hold; use a shorter chunk (ssd_chunk)")
        y = torch.empty((nC, L, H, P), dtype=torch.float32, device=dev)
        st = torch.empty((nC, H, P, N), dtype=torch.float32, device=dev)
        err = _lib()(xdt.data_ptr(), log_a.data_ptr(), B_mat.data_ptr(),
                    C_mat.data_ptr(), y.data_ptr(), st.data_ptr(),
                    nC, L, H, P, N, int(xdt.dtype == torch.bfloat16), hg,
                    torch.cuda.current_stream(dev).cuda_stream)
        build.check(err, what)
        ssd_intra.launches += 1
        ssd_intra.launches_by_type[str(xdt.dtype).replace("torch.", "")] += 1
    else:
        raise ValueError(f"{what}: no kernel for device {xdt.device}")
    if lead:
        y = y.unflatten(0, (lead[0], -1))
        st = st.unflatten(0, (lead[0], -1))
    return y, st


ssd_intra.launches = 0
ssd_intra.launches_by_type = collections.Counter()
