"""Model config, layers, attention backends and the decoder stack."""
