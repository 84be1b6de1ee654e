"""musicgen-medium [audio] 48L d_model=1536 24H (kv=24 == MHA) d_ff=6144
vocab=2048 — decoder-only over EnCodec tokens [arXiv:2306.05284; hf].
The EnCodec frontend is a STUB: input_specs() provides precomputed frame
embeddings (input_mode="embeds")."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium", family="audio", num_layers=48, d_model=1536,
    num_heads=24, num_kv_heads=24, head_dim=64, d_ff=6144,
    vocab_size=2048, pattern=("attn",), rope_theta=10_000.0,
    input_mode="embeds",
)

TINY = CONFIG.replace(
    name="musicgen-tiny", num_layers=4, d_model=128, num_heads=4,
    num_kv_heads=4, head_dim=32, d_ff=256, vocab_size=128)
