"""Device selection for the port's entry points.

Entry points run on ``cuda`` unless the caller asks for ``cpu`` (as the
CPU tests do). A request for CUDA on a host without a usable GPU raises:
the port never falls back to the CPU on its own. Selecting CUDA also
pins fp32 matrix products to full IEEE fp32 (no TF32), the precision the
reference is compared at.
"""
from __future__ import annotations

import torch


def resolve(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but torch.cuda.is_available() "
                "is False; pass device='cpu' to run on the host")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev


def sync(device: torch.device):
    """Wait for the device's queued work: PyTorch returns before the card
    finishes, so every timed region ends here."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
