"""RoPE apply / remove kernel (the chunk-cache RPE path): CUDA source,
plain version and wrapper."""
