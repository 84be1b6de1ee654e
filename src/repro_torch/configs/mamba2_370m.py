"""mamba2-370m [ssm] 48L d_model=1024 (attn-free) vocab=50280,
ssm_state=128 — SSD state-space duality [arXiv:2405.21060; unverified].
Chunk-cache INAPPLICABLE (no KV cache; running state spans the prefix) —
see DESIGN.md §6."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m", family="ssm", num_layers=48, d_model=1024,
    num_heads=16, num_kv_heads=16, head_dim=64, d_ff=0,
    vocab_size=50280, pattern=("ssd",), ssm_state=128, ssm_expand=2,
    ssm_head_dim=64, supports_chunk_cache=False,
)

TINY = CONFIG.replace(
    name="mamba2-tiny", num_layers=4, d_model=128, num_heads=4,
    num_kv_heads=4, head_dim=32, vocab_size=512, ssm_state=16,
    ssm_head_dim=32)
