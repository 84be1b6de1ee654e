"""llama3.2-3b [dense] 28L d_model=3072 24H (GQA kv=8) d_ff=8192
vocab=128256 [hf:meta-llama/Llama-3.2-3B; unverified]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-3b", family="dense", num_layers=28, d_model=3072,
    num_heads=24, num_kv_heads=8, head_dim=128, d_ff=8192,
    vocab_size=128256, pattern=("attn",), rope_theta=500_000.0,
)

TINY = CONFIG.replace(
    name="llama3.2-3b-tiny", num_layers=4, d_model=128, num_heads=4,
    num_kv_heads=2, head_dim=32, d_ff=256, vocab_size=512)
