"""deepseek-67b [dense] 95L d_model=8192 64H (GQA kv=8) d_ff=22016
vocab=102400 — llama-arch [arXiv:2401.02954; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b", family="dense", num_layers=95, d_model=8192,
    num_heads=64, num_kv_heads=8, head_dim=128, d_ff=22016,
    vocab_size=102400, pattern=("attn",), rope_theta=10_000.0,
)

TINY = CONFIG.replace(
    name="deepseek-67b-tiny", num_layers=5, d_model=128, num_heads=4,
    num_kv_heads=2, head_dim=32, d_ff=256, vocab_size=512)
