"""Device resolution shared by the port's entry points, and the f32
matrix-product precision of the search and build paths."""

from __future__ import annotations

import contextlib
import threading

import torch

_F32_LOCK = threading.Lock()
_F32_DEPTH = 0  # blocks of ieee_f32 open in the process
_F32_SAVED = "highest"  # the setting to give back when the last closes


@contextlib.contextmanager
def ieee_f32():
    """f32 matrix products in full f32 inside the block (the reference's
    precision; "No TF32" in ROADMAP), whatever the caller set with
    ``torch.set_float32_matmul_precision`` or ``torch.backends.cuda.matmul.
    allow_tf32``, and the caller's setting given back when the last open
    block closes.  Touches nothing where the setting is "highest".

    PyTorch's setting is process-wide, so a block reaches other threads:
    while one is open anywhere, every thread's f32 products run in full
    f32 and read "highest".  A setting that another thread makes meanwhile
    holds from then on (a product of an open block that has not started can
    take it; a block opened after takes "highest" again) and stays when the
    last block closes, unless it is "highest"."""
    global _F32_DEPTH, _F32_SAVED
    with _F32_LOCK:
        current = torch.get_float32_matmul_precision()
        if current != "highest":
            _F32_SAVED = current
            torch.set_float32_matmul_precision("highest")
        elif _F32_DEPTH == 0:
            _F32_SAVED = "highest"
        _F32_DEPTH += 1
    try:
        yield
    finally:
        with _F32_LOCK:
            _F32_DEPTH -= 1
            if (_F32_DEPTH == 0 and _F32_SAVED != "highest"
                    and torch.get_float32_matmul_precision() == "highest"):
                torch.set_float32_matmul_precision(_F32_SAVED)


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
