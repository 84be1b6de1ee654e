"""llama-3.2-vision-90b [vlm] 100L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256 — cross-attn image layers every 5th layer
[hf:meta-llama/Llama-3.2-90B-Vision; unverified]. The vision frontend is
a STUB: input_specs() provides precomputed patch embeddings."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b", family="vlm", num_layers=100,
    d_model=8192, num_heads=64, num_kv_heads=8, head_dim=128, d_ff=28672,
    vocab_size=128256,
    pattern=("attn", "attn", "attn", "attn", "xattn"),
    rope_theta=500_000.0, num_media_tokens=1600,
)

TINY = CONFIG.replace(
    name="llama-vision-tiny", num_layers=5, d_model=128, num_heads=4,
    num_kv_heads=2, head_dim=32, d_ff=256, vocab_size=512,
    num_media_tokens=16)
