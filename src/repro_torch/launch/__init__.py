"""Entry points of the port: ``python -m repro_torch.launch.serve`` (the
search server) and ``python -m repro_torch.launch.train`` (the training
launcher)."""
