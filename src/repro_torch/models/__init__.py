"""Models of the port: the LM family (``config``, ``layers``, ``moe``,
``transformer``, ``decoding``), DimeNet (``gnn``) and the recsys family
(``recsys``); their configurations are in ``repro_torch.configs``."""
