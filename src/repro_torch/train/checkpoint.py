"""Fault-tolerant training checkpoints: the port of
``repro.train.checkpoint``, file for file.

Same discipline as the index store (``core/storage.py``): atomic writes
(tmp + rename), a manifest written LAST (a crash mid-save never leaves a
loadable-but-partial checkpoint), monotonically numbered step directories,
and the newest complete step found on restore — the restart path after
preemption is ``state = restore(dir) or fresh_init()``.

Arrays are saved leaf by leaf in one ``arrays.npz`` keyed by their tree
paths joined with ``/`` (``params/blocks/0/w``, ``opt/m/a/w1``,
``opt/count``: dict keys, list indices and NamedTuple fields by name), in
the reference's leaf order, so either package restores the other's
checkpoints.  Restore returns host numpy arrays in the structure and
dtypes of ``like``; :func:`params_from_numpy` puts them on a device.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import tempfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.train.tree import leaves_with_paths, tree_map, unflatten_like

STEP_RE = re.compile(r"^step_(\d+)$")


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten_with_paths(tree) -> Dict[str, np.ndarray]:
    return {"/".join(path): _host(leaf)
            for path, leaf in leaves_with_paths(tree)}


def save_checkpoint(directory: str, step: int, state: Any,
                    extra: Optional[dict] = None, keep: int = 3) -> str:
    """Writes ``<dir>/step_<n>/`` atomically; prunes old steps to ``keep``."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step}")
    tmp = tempfile.mkdtemp(dir=directory, prefix=".tmp_ckpt_")
    try:
        flat = _flatten_with_paths(state)
        with open(os.path.join(tmp, "arrays.npz"), "wb") as f:
            np.savez(f, **flat)
        manifest = dict(step=step, n_arrays=len(flat), extra=extra or {})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=2)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
    finally:
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
    for old in all_steps(directory)[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{old}"),
                      ignore_errors=True)
    return final


def all_steps(directory: str):
    """The complete steps (a manifest present), ascending."""
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        m = STEP_RE.match(name)
        if m and os.path.exists(
                os.path.join(directory, name, "manifest.json")):
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(directory: str) -> Optional[int]:
    steps = all_steps(directory)
    return steps[-1] if steps else None


def restore_checkpoint(directory: str, like: Any,
                       step: Optional[int] = None
                       ) -> Optional[Tuple[int, Any, dict]]:
    """Restores into the structure of ``like`` (tensors or arrays): returns
    ``(step, state of numpy arrays, extra)``, or None if no complete
    checkpoint exists.  Raises ``ValueError`` when the keys differ."""
    step = step if step is not None else latest_step(directory)
    if step is None:
        return None
    d = os.path.join(directory, f"step_{step}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(d, "arrays.npz")) as data:
        paths = leaves_with_paths(like)
        keys = ["/".join(path) for path, _ in paths]
        if set(data.files) != set(keys):
            raise ValueError(
                f"checkpoint/state structure mismatch: "
                f"{set(data.files) ^ set(keys)}")
        new_leaves = [data[key].astype(_host_dtype(leaf))
                      for key, (_, leaf) in zip(keys, paths)]
    return step, unflatten_like(like, new_leaves), manifest.get("extra", {})


def _host_dtype(leaf) -> np.dtype:
    if isinstance(leaf, torch.Tensor):
        return torch.empty((), dtype=leaf.dtype).numpy().dtype
    return np.asarray(leaf).dtype


def params_from_numpy(tree, device="cuda"):
    """A tree of numpy arrays (a restored checkpoint, or the reference's
    parameters as ``np.asarray`` leaves) as tensors on ``device``."""
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    return tree_map(
        lambda x: torch.from_numpy(np.array(x, copy=True)).to(dev), tree)
