"""llama3-70b: the paper's large evaluation model (TP=4 in the paper)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3-70b", family="dense", num_layers=80, d_model=8192,
    num_heads=64, num_kv_heads=8, head_dim=128, d_ff=28672,
    vocab_size=128256, pattern=("attn",), rope_theta=500_000.0,
)

TINY = CONFIG.replace(
    name="llama3-70b-tiny", num_layers=4, d_model=128, num_heads=4,
    num_kv_heads=2, head_dim=32, d_ff=256, vocab_size=512)
