"""DimeNet and its neighbour sampler: the port of ``repro.models.gnn``."""

from repro_torch.models.gnn.dimenet import (
    DimeNetConfig,
    GraphBatch,
    forward,
    init_params,
    loss_fn,
    scaled_down_gnn,
)

__all__ = [
    "DimeNetConfig", "GraphBatch", "forward", "init_params", "loss_fn",
    "scaled_down_gnn",
]
