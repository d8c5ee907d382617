"""dimenet [arXiv:2003.03123; unverified tier].

n_blocks=6 d_hidden=128 n_bilinear=8 n_spherical=7 n_radial=6.
Shapes: full_graph_sm (Cora-like), minibatch_lg (Reddit-like, sampled),
ogb_products (full-batch large), molecule (batched small graphs).
The paper's IVF technique is inapplicable inside this arch (DESIGN.md §5).
"""

from repro_torch.models.gnn.dimenet import DimeNetConfig, scaled_down_gnn

ARCH_ID = "dimenet"
FAMILY = "gnn"


def config(d_feat: int = 128, d_out: int = 32, readout: str = "node"
           ) -> DimeNetConfig:
    return DimeNetConfig(
        name=ARCH_ID,
        n_blocks=6,
        d_hidden=128,
        n_bilinear=8,
        n_spherical=7,
        n_radial=6,
        d_feat=d_feat,
        d_out=d_out,
        readout=readout,
    )


def smoke_config() -> DimeNetConfig:
    return scaled_down_gnn(config())
