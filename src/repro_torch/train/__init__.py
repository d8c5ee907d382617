"""Training substrate of the port: optimizers, loop, checkpointing."""
