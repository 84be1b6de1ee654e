"""The closed-form operations and bytes, against hand-worked tiny
shapes."""
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench import counts  # noqa: E402

DENSE = {"d_model": 4, "num_heads": 2, "num_kv_heads": 1, "head_dim": 2,
         "d_ff": 3, "vocab_size": 10}
MOE = dict(DENSE, num_experts=4, experts_per_token=2)


def test_linear_flops_dense():
    # q 2*4*4, k 2*4*2, v 2*4*2, o 2*4*4 = 96; swiglu 3 products 2*4*3
    # each = 72
    assert counts.linear_flops_per_token(DENSE) == 96 + 72


def test_linear_flops_moe():
    # router 2*4*4 = 32, two experts of 72 each
    assert counts.linear_flops_per_token(MOE) == 96 + 32 + 2 * 72


def test_attention_and_head():
    assert counts.attention_flops(DENSE, 5) == 4 * 5 * 2 * 2
    assert counts.head_flops(DENSE) == 2 * 4 * 10
    assert counts.token_flops(DENSE, 3, 7) == \
        3 * (168 + 4 * 7 * 2 * 2)


def test_chunk_call():
    # 3 live q rows, H 2, D 4, bf16 q; 5 live keys, Hkv 1, fp32 K/V;
    # 9 pairs, C 2
    f, b = counts.chunk_call((1, 4, 2, 4), (1, 8, 1, 4), torch.bfloat16,
                             torch.float32, 3, 9, 5, 2)
    assert f == 4 * 9 * 2 * 4
    assert b == 3 * 2 * 4 * 2 * 2 + 5 * 1 * 4 * 4 * 2 + 3 * 2 * 4 + 8 * 8


def test_decode_call():
    f, b = counts.decode_call((2, 2, 4), (2, 16, 1, 4), torch.bfloat16,
                              torch.float32, 2, 11)
    assert f == 4 * 11 * 2 * 4
    assert b == 2 * 2 * 4 * 2 * 2 + 11 * (1 * 4 * 4 * 2 + 4)


def test_bound_takes_the_slower_roof():
    assert counts.bound_seconds(989e12, 0, "bfloat16") == pytest.approx(1)
    assert counts.bound_seconds(0, 3.35e12, "bfloat16") == pytest.approx(1)
    assert counts.bound_seconds(1, 3.35e12, "bfloat16") == pytest.approx(1)


def test_decode_roofline_reads_positions_as_they_were():
    """The reader counts each call's live keys as the kernel saw them,
    though the cache's position row is written in place afterwards."""
    import types

    from perfbench import probes, readers

    calls = []

    def decode_attention(q, k, v, q_pos, k_pos, *, window=0):
        calls.append(1)
        return q
    decode_attention.launches = 0
    decode_attention.launches_by_type = {}
    ops = types.SimpleNamespace(decode_attention=decode_attention,
                                chunk_attention=decode_attention)
    kc = probes.KernelCalls(probes.Patches(), {"chunk_ops": ops,
                                               "decode_ops": ops})
    kc.on = True
    q = torch.zeros(1, 2, 4, dtype=torch.bfloat16)
    k = torch.zeros(1, 8, 1, 4)
    k_pos = torch.tensor([[0, 1, 2, -1, -1, -1, -1, -1]])
    ops.decode_attention(q, k, k, torch.tensor([2]), k_pos)
    k_pos[0, 3:] = torch.arange(3, 8)      # the next steps' writes
    dt = types.SimpleNamespace(
        kernel_seconds=lambda match: (1.0, 1))
    run = types.SimpleNamespace(kernels=kc, dtrace=dt)
    f, b = counts.decode_call((1, 2, 4), (1, 8, 1, 4), torch.bfloat16,
                              torch.float32, 1, 3)
    assert calls and readers.decode_roofline(run) == pytest.approx(
        100.0 * counts.bound_seconds(f, b, "bfloat16"))
