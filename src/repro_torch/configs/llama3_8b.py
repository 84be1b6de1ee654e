"""llama3-8b: the paper's primary evaluation model (Fig 20-29)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3-8b", family="dense", num_layers=32, d_model=4096,
    num_heads=32, num_kv_heads=8, head_dim=128, d_ff=14336,
    vocab_size=128256, pattern=("attn",), rope_theta=500_000.0,
)

TINY = CONFIG.replace(
    name="llama3-8b-tiny", num_layers=4, d_model=128, num_heads=4,
    num_kv_heads=2, head_dim=32, d_ff=256, vocab_size=512)
