"""One config module per ported architecture: the recsys four."""
