"""Training of the port: optimizers, the four LDM steps, checkpoints, the
loop. Its own copy of ``brepgen_tpu/train``."""
