"""Model weights made by the benchmark from ``--seed``, on the device, in
the dtype they are served in, and handed to both sides: the program gets
them in its parameter layout (``src/repro_torch/models/model.py``,
``init_params``: ``groups[0]`` leaves stacked ``[G, ...]`` over the layers,
for configs whose pattern is one ``attn`` layer), and the reference
regenerates any one layer alone from the same seed.

Each (leaf, layer) slice has a generator of its own, seeded from (seed,
leaf, layer), so one layer can be made again without the others. The
distributions: N(0, 1/fan_in) projections (fan_in the input width), an
N(0, 0.02) embedding, zero norm weights (the model scales by 1 + w).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

LEAVES = ("embed", "unembed", "final_norm")


def layer_defs(m: Dict) -> Dict[str, Tuple[tuple, int]]:
    """Leaf -> (shape of one layer, fan_in; 0 for a zero leaf), for the
    model description ``m`` (``configs/<name>.json``'s ``model``)."""
    d, h, hkv, dh, f = (m["d_model"], m["num_heads"], m["num_kv_heads"],
                        m["head_dim"], m["d_ff"])
    defs = {
        "ln1": ((d,), 0),
        "wq": ((d, h, dh), d),
        "wk": ((d, hkv, dh), d),
        "wv": ((d, hkv, dh), d),
        "wo": ((h, dh, d), h * dh),
        "ln2": ((d,), 0),
    }
    e = m.get("num_experts", 0)
    if e:
        defs["router"] = ((d, e), d)
        defs["wi_e"] = ((e, d, 2, f), d)
        defs["wo_e"] = ((e, f, d), f)
    else:
        defs["wi"] = ((d, 2, f), d)
        defs["wo_ff"] = ((f, d), f)
    return defs


def padded_vocab(m: Dict) -> int:
    return -(-m["vocab_size"] // 256) * 256


def _gen(seed: int, leaf: int, layer: int, device) -> torch.Generator:
    s = np.random.SeedSequence([int(seed) & 0xFFFFFFFFFFFF, leaf, layer])
    a, b = s.generate_state(2, np.uint32)
    g = torch.Generator(device=device)
    g.manual_seed((int(a) << 31) ^ int(b))
    return g


def _fill(out: torch.Tensor, seed: int, leaf: int, layer: int, std: float):
    g = _gen(seed, leaf, layer, out.device)
    x = torch.randn(out.shape, generator=g, dtype=torch.float32,
                    device=out.device)
    out.copy_(x.mul_(std))


def _std(fan_in: int) -> float:
    return 1.0 / float(np.sqrt(max(1, fan_in)))


def make_params(m: Dict, seed: int, device, dtype=torch.bfloat16) -> Dict:
    """All weights, in the program's layout, made on ``device``."""
    d, vp, L = m["d_model"], padded_vocab(m), m["num_layers"]
    stacked = {}
    for li, (name, (shape, fan)) in enumerate(layer_defs(m).items()):
        t = torch.zeros((L,) + shape, dtype=dtype, device=device)
        if fan:
            for layer in range(L):
                _fill(t[layer], seed, 10 + li, layer, _std(fan))
        stacked[name] = t
    embed = torch.empty((vp, d), dtype=dtype, device=device)
    _fill(embed, seed, 0, 0, 0.02)
    unembed = torch.empty((d, vp), dtype=dtype, device=device)
    _fill(unembed, seed, 1, 0, _std(d))
    return {"embed": embed, "unembed": unembed,
            "final_norm": torch.zeros((d,), dtype=dtype, device=device),
            "groups": [stacked], "tail": []}


def layer_params(m: Dict, seed: int, layer: int, device,
                 dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """One layer's weights, the same values ``make_params`` gives it."""
    out = {}
    for li, (name, (shape, fan)) in enumerate(layer_defs(m).items()):
        t = torch.zeros(shape, dtype=dtype, device=device)
        if fan:
            _fill(t, seed, 10 + li, layer, _std(fan))
        out[name] = t
    return out


def head_params(m: Dict, seed: int, device, dtype=torch.bfloat16):
    """(embed, unembed, final_norm), the same values as ``make_params``."""
    d, vp = m["d_model"], padded_vocab(m)
    embed = torch.empty((vp, d), dtype=dtype, device=device)
    _fill(embed, seed, 0, 0, 0.02)
    unembed = torch.empty((d, vp), dtype=dtype, device=device)
    _fill(unembed, seed, 1, 0, _std(d))
    return embed, unembed, torch.zeros((d,), dtype=dtype, device=device)
