"""Training and checkpoints (the port's ``repro.training``): the
masked-diffusion loss, AdamW, the training loop and checkpoints in the
JAX package's format."""
