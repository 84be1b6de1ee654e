"""Plain PyTorch version of the RoPE kernel: the model's own rotate-half
``apply_rope``, as ``repro/kernels/rope/ref.py`` uses it."""
from __future__ import annotations

from repro_torch.models.layers import apply_rope


def rope_ref(x, pos, *, theta: float, inverse: bool = False):
    """x [T,H,D], pos [T] -> x rotated at pos (``inverse`` removes it)."""
    return apply_rope(x[None], pos[None], theta, inverse=inverse)[0]
