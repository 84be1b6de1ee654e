"""deepseek-7b [dense] 30L d_model=4096 32H (GQA kv=32 == MHA) d_ff=11008
vocab=102400 — llama-arch [arXiv:2401.02954; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b", family="dense", num_layers=30, d_model=4096,
    num_heads=32, num_kv_heads=32, head_dim=128, d_ff=11008,
    vocab_size=102400, pattern=("attn",), rope_theta=10_000.0,
)

TINY = CONFIG.replace(
    name="deepseek-7b-tiny", num_layers=4, d_model=128, num_heads=4,
    num_kv_heads=4, head_dim=32, d_ff=256, vocab_size=512)
