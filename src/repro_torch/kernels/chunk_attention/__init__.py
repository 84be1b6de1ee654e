"""Chunk-attention kernel: CUDA source, plain version and wrapper."""
