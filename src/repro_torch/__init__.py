"""PyTorch/CUDA port of the Cache-Craft serving system.

A second package beside the JAX reference ``repro``: the same module
paths (``repro/core/prefill.py`` <-> ``repro_torch/core/prefill.py``),
PyTorch tensors on an explicit device, and hand-written Hopper kernels
under ``kernels/``. It imports nothing of ``repro`` and nothing of JAX.
"""
