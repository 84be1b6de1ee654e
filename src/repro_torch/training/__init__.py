"""Training of the port: data, AdamW, checkpoints and the step functions."""
