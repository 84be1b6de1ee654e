"""granite-moe-1b-a400m [moe] 24L d_model=1024 16H (GQA kv=8) expert
d_ff=512 vocab=49155, 32 experts top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m", family="moe", num_layers=24,
    d_model=1024, num_heads=16, num_kv_heads=8, head_dim=64, d_ff=512,
    vocab_size=49155, pattern=("attn",), rope_theta=10_000.0,
    num_experts=32, experts_per_token=8,
)

TINY = CONFIG.replace(
    name="granite-moe-1b-tiny", num_layers=4, d_model=128, num_heads=4,
    num_kv_heads=2, head_dim=32, d_ff=64, vocab_size=512,
    num_experts=4, experts_per_token=2)
