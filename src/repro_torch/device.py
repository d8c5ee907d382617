"""Device resolution shared by the port's entry points."""

from __future__ import annotations

import torch


def _tracing_fake() -> bool:
    """Whether a ``FakeTensorMode`` is active: its ``cuda`` tensors hold no
    memory and need no card (``launch.dryrun`` traces one rank's step so)."""
    from torch._guards import detect_fake_mode

    return detect_fake_mode() is not None


def resolve_device(device) -> torch.device:
    """``device`` as a :class:`torch.device`; raises if CUDA is asked for
    but absent (and no ``FakeTensorMode`` is tracing), so no entry point
    quietly carries on on the CPU."""
    dev = torch.device(device)
    if (dev.type == "cuda" and not torch.cuda.is_available()
            and not _tracing_fake()):
        raise RuntimeError(
            f"device={str(device)!r} requested but CUDA is not available; "
            "pass device='cpu' to run the plain PyTorch path"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r}")
    return dev
