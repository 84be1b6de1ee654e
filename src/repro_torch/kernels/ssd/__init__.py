"""Mamba2 SSD intra-chunk kernel: CUDA source, plain version and
wrapper."""
