"""Models of the port: the recsys family (see ``repro_torch.configs``)."""
