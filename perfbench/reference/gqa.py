"""Plain PyTorch reference of a dense GQA decoder with a SwiGLU FFN, or a
top-k MoE FFN without capacity limit (every routed token reaches its
experts, as the published models compute), in float32 with TF32 off.

It reworks the Cache-Craft computation of one served request from what
the program was handed and decided: the prompt's tokens, the stored
(position-free) KV of each reused chunk, and the rows the plan computed
in each layer (its recompute tokens, and the rows the focus tracker
dropped after a window). Everything else it computes itself: RoPE of
the reused KV at its new positions, every computed row of every layer,
the first token's logits, and the decode of the served tokens over its
own KV. It imports nothing of the program.

``mode="fp8"`` is the control: every matrix product takes its inputs
rounded to float8 e4m3 (one scale per tensor), the precision step below
the configuration's bfloat16.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


@dataclass
class Case:
    """One served request, as the reference needs it."""
    tokens: np.ndarray                  # [T] prompt tokens
    windows: List[Tuple[int, int, np.ndarray]]  # (l0, l1, computed pos)
    injected: List[Tuple[int, int, np.ndarray, np.ndarray]]  # s, e, k, v
    served: List[int]                   # the program's output tokens
    stored: List[Tuple[int, int, np.ndarray, np.ndarray]] = \
        field(default_factory=list)     # chunks the request stored


def _q8(x: torch.Tensor) -> torch.Tensor:
    s = x.abs().amax().clamp(min=1e-30) / E4M3_MAX
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


class Math:
    """The products of one precision: float32, or float8 inputs."""

    def __init__(self, mode: str):
        if mode not in ("fp32", "fp8"):
            raise ValueError(mode)
        self.q = _q8 if mode == "fp8" else (lambda t: t)

    def mm(self, a, b):
        return self.q(a) @ self.q(b)


def rms_norm(x, w, eps):
    x = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)
    return x * (1.0 + w)


def rope(x, pos, theta, inverse=False):
    """Rotate-half RoPE of x [n, H, D] at positions pos [n]."""
    d = x.shape[-1]
    inv = 1.0 / (theta ** (np.arange(0, d, 2, dtype=np.float32) / d))
    ang = pos.to(torch.float32)[:, None] * torch.from_numpy(inv).to(x.device)
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    if inverse:
        sin = -sin
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)


def _ffn(mth: Math, m: Dict, p, x):
    if not m.get("num_experts"):
        wi = p["wi"]
        a = mth.mm(x, wi[:, 0])
        b = mth.mm(x, wi[:, 1])
        return mth.mm(F.silu(a) * b, p["wo_ff"])
    k = m["experts_per_token"]
    probs = torch.softmax(mth.mm(x, p["router"]), -1)
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates = top.values[:, :k]
    gates = gates / gates.sum(-1, keepdim=True)
    idx = top.indices[:, :k]
    out = torch.zeros_like(x)
    for e in torch.unique(idx).tolist():
        rows, slot = torch.nonzero(idx == e, as_tuple=True)
        xe = x[rows]
        wi = p["wi_e"][e]
        h = F.silu(mth.mm(xe, wi[:, 0])) * mth.mm(xe, wi[:, 1])
        out.index_add_(0, rows, mth.mm(h, p["wo_e"][e])
                       * gates[rows, slot][:, None])
    return out


def _attend(mth: Math, q, k, v, qpos, kpos):
    """q [n, H, D] over k/v [S, Hkv, D], causal by position."""
    n, H, D = q.shape
    hkv = k.shape[1]
    g = H // hkv
    qh = q.reshape(n, hkv, g, D).permute(1, 2, 0, 3)        # [hkv,g,n,D]
    kh = k.permute(1, 2, 0)                                 # [hkv,D,S]
    s = mth.mm(qh, kh[:, None]) / float(np.sqrt(D))         # [hkv,g,n,S]
    mask = kpos[None, :] <= qpos[:, None]
    s = s.masked_fill(~mask, float("-inf"))
    pr = torch.softmax(s, -1)
    out = mth.mm(pr, v.permute(1, 0, 2)[:, None])           # [hkv,g,n,D]
    return out.permute(2, 0, 1, 3).reshape(n, H, D)


def run(m: Dict, cases: List[Case], layer_weights: Callable[[int], Dict],
        head: Tuple[torch.Tensor, torch.Tensor, torch.Tensor], device,
        mode: str = "fp32", keep_stored: bool = False) -> List[Dict]:
    """Run every case layer by layer (one layer's weights at a time).
    Returns per case: ``logits`` [n_served, V] (row i predicts served
    token i) and ``store_err``, per chunk the request stored, the largest
    relative error over layers and K / V of the stored (position-free)
    KV against this reference's own: ||stored - ref|| / ||ref||; with
    ``keep_stored``, also ``stored_ref``, this reference's own
    position-free KV of those chunks (as ``Case.stored``)."""
    mth = Math(mode)
    L, eps, theta = m["num_layers"], m["norm_eps"], m["rope_theta"]
    embed, unembed, final_norm = (t.to(device, torch.float32) for t in head)
    st = []
    for c in cases:
        T, n = len(c.tokens), len(c.served)
        toks = torch.as_tensor(np.concatenate(
            [c.tokens, np.asarray(c.served[:-1], np.int64)]).astype(np.int64),
            device=device)
        st.append({"h": embed[toks].clone(), "T": T, "n": n,
                   "pos": torch.arange(T + n - 1, device=device),
                   "err": [0.0] * len(c.stored),
                   "kept": [([], []) for _ in c.stored]})
    del embed
    for layer in range(L):
        p = {k: v.to(device, torch.float32)
             for k, v in layer_weights(layer).items()}
        for c, s in zip(cases, st):
            T = s["T"]
            act = next(a for l0, l1, a in c.windows if l0 <= layer < l1)
            rows = torch.as_tensor(np.concatenate(
                [np.asarray(act, np.int64),
                 np.arange(T, T + s["n"] - 1)]), device=device)
            h = s["h"]
            S = T + s["n"] - 1
            hkv, D = m["num_kv_heads"], m["head_dim"]
            K = torch.zeros((S, hkv, D), device=device)
            V = torch.zeros((S, hkv, D), device=device)
            for s0, s1, k, v in c.injected:
                pos = torch.arange(s0, s1, device=device)
                K[s0:s1] = rope(torch.as_tensor(k[layer], device=device),
                                pos, theta)
                V[s0:s1] = torch.as_tensor(v[layer], device=device)
            x = rms_norm(h[rows], p["ln1"], eps)
            qpos = s["pos"][rows]
            q = rope(mth.mm(x, p["wq"].flatten(1)).view(len(rows), -1, D),
                     qpos, theta)
            K[rows] = rope(mth.mm(x, p["wk"].flatten(1)).view(
                len(rows), hkv, D), qpos, theta)
            V[rows] = mth.mm(x, p["wv"].flatten(1)).view(len(rows), hkv, D)
            for i, (s0, s1, k_st, v_st) in enumerate(c.stored):
                pos = torch.arange(s0, s1, device=device)
                kr = rope(K[s0:s1], pos, theta, inverse=True)
                if keep_stored:
                    s["kept"][i][0].append(kr.cpu().numpy())
                    s["kept"][i][1].append(V[s0:s1].cpu().numpy())
                for ref, got in ((kr, k_st), (V[s0:s1], v_st)):
                    g = torch.as_tensor(got[layer], device=device)
                    e = float(torch.linalg.vector_norm(g - ref) /
                              torch.linalg.vector_norm(ref).clamp(
                                  min=1e-30))
                    s["err"][i] = max(s["err"][i], e)
            o = _attend(mth, q, K, V, qpos, s["pos"])
            h2 = h[rows] + mth.mm(o.flatten(1), p["wo"].flatten(0, 1))
            h2 = h2 + _ffn(mth, m, p, rms_norm(h2, p["ln2"], eps))
            h = h.clone()
            h[rows] = h2
            s["h"] = h
        del p
    out = []
    V_ = m["vocab_size"]
    for c, s in zip(cases, st):
        T = s["T"]
        rows = torch.cat([torch.tensor([T - 1], device=device),
                          torch.arange(T, T + s["n"] - 1, device=device)])
        x = rms_norm(s["h"][rows], final_norm, eps)
        logits = mth.mm(x, unembed)[:, :V_]
        r = {"logits": logits.cpu(), "store_err": s["err"]}
        if keep_stored:
            r["stored_ref"] = [(s0, s1, np.stack(ks), np.stack(vs))
                               for (s0, s1, _k, _v), (ks, vs)
                               in zip(c.stored, s["kept"])]
        out.append(r)
    return out


def served_gaps(logits: torch.Tensor, served) -> torch.Tensor:
    """The gap of every served token below the reference's best."""
    lg = logits.double()
    t = torch.as_tensor(list(served), dtype=torch.long)
    return lg.max(-1).values - lg[torch.arange(len(t)), t]

