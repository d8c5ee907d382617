"""Shared layers of the port's models: the port of ``repro.models.layers``'
``rms_norm`` (the recsys transformer blocks' norm)."""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    """RMS norm in f32 with a ``1 + scale`` gain (``scale`` starts at 0)."""
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(x.dtype)
