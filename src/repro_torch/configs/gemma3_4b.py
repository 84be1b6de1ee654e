"""gemma3-4b [dense] 34L d_model=2560 8H (GQA kv=4) d_ff=10240
vocab=262144 — 5:1 local:global, 128k ctx [hf:google/gemma-3-4b-pt;
unverified]. Pattern: 5 sliding-window layers then 1 global; 34 = 5*6+4
leaves a 4-layer tail (local,local,local,local)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b", family="dense", num_layers=34, d_model=2560,
    num_heads=8, num_kv_heads=4, head_dim=256, d_ff=10240,
    vocab_size=262144,
    pattern=("local", "local", "local", "local", "local", "attn"),
    window=1024, rope_theta=1_000_000.0,
)

TINY = CONFIG.replace(
    name="gemma3-4b-tiny", num_layers=8, d_model=128, num_heads=4,
    num_kv_heads=2, head_dim=32, d_ff=256, vocab_size=512, window=64,
    pattern=("local", "local", "local", "attn"))
