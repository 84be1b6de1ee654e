"""recurrentgemma-9b [hybrid] 38L d_model=4096 16H (GQA kv=1) d_ff=12288
vocab=256000 — RG-LRU + local attn, 1 attn : 2 recurrent
[arXiv:2402.19427; unverified]. 38 = 3*12 + 2 -> tail (rglru, rglru).
Chunk-cache INAPPLICABLE (recurrent state spans the whole prefix) —
see DESIGN.md §6."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b", family="hybrid", num_layers=38,
    d_model=4096, num_heads=16, num_kv_heads=1, head_dim=256, d_ff=12288,
    vocab_size=256000, pattern=("rglru", "rglru", "local"), window=2048,
    rope_theta=10_000.0, rnn_width=4096, supports_chunk_cache=False,
)

TINY = CONFIG.replace(
    name="recurrentgemma-9b-tiny", num_layers=6, d_model=128, num_heads=4,
    num_kv_heads=1, head_dim=32, d_ff=256, vocab_size=512, window=64,
    rnn_width=128)
