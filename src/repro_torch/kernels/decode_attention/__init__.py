"""Decode-attention kernels (dense arena and paged pool): CUDA source,
plain versions and wrappers."""
