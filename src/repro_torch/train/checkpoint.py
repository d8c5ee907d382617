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

numpy has no bfloat16: a bf16 leaf is written as its raw 16-bit words
under the header the reference's ``ml_dtypes`` arrays get (``'<V2'``),
so the npz members are the reference's byte for byte, and it reads back
as the ``|V2`` words it is, returned as a CPU ``torch.bfloat16`` tensor.
(The reference cannot restore its own bf16 leaves: numpy has no cast
from ``V2`` to ``ml_dtypes.bfloat16``.)
"""

from __future__ import annotations

import json
import os
import re
import shutil
import tempfile
import zipfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.train.tree import leaves_with_paths, tree_map, unflatten_like

STEP_RE = re.compile(r"^step_(\d+)$")


def _is_bf16_words(a: np.ndarray) -> bool:
    """A numpy array holding bfloat16 values: ``ml_dtypes.bfloat16`` (the
    reference's leaves) or the ``V2`` words a checkpoint reads back as."""
    return a.dtype.name == "bfloat16" or (a.dtype.kind == "V"
                                          and a.dtype.itemsize == 2)


def _host(leaf) -> np.ndarray:
    """A leaf on the host: bf16 as ``V2`` words (numpy has no bfloat16)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().contiguous().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2")
        return t.numpy()
    a = np.asarray(leaf)
    return a.view(np.int16).view("V2") if _is_bf16_words(a) else a


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
        _savez(os.path.join(tmp, "arrays.npz"), flat)
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


def _savez(path: str, flat: Dict[str, np.ndarray]):
    """``np.savez`` (stored members, zip64), but a ``V2`` leaf's header
    says ``'<V2'``, as the reference's ``ml_dtypes.bfloat16`` arrays do."""
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, val in flat.items():
            with zf.open(key + ".npy", "w", force_zip64=True) as fid:
                if val.dtype.kind == "V" and val.dtype.itemsize == 2:
                    header = np.lib.format.header_data_from_array_1_0(val)
                    header["descr"] = "<V2"
                    np.lib.format.write_array_header_1_0(fid, header)
                    fid.write(np.ascontiguousarray(val).tobytes())
                else:
                    np.lib.format.write_array(fid, val, allow_pickle=False)


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
    checkpoint exists; a bf16 leaf of ``like`` comes back as a CPU
    ``torch.bfloat16`` tensor.  Raises ``ValueError`` when the keys
    differ."""
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
        new_leaves = [_restored(data[key], leaf)
                      for key, (_, leaf) in zip(keys, paths)]
    return step, unflatten_like(like, new_leaves), manifest.get("extra", {})


def _restored(arr: np.ndarray, leaf):
    """A stored array in ``leaf``'s dtype (bf16 as a CPU tensor)."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return _bf16_tensor(arr)
        return arr.astype(torch.empty((), dtype=leaf.dtype).numpy().dtype)
    like = np.asarray(leaf)
    if _is_bf16_words(like):
        return _bf16_tensor(arr)
    return arr.astype(like.dtype)


def _bf16_tensor(arr: np.ndarray) -> torch.Tensor:
    """bf16 words (``V2`` or ``ml_dtypes.bfloat16``) as a CPU tensor."""
    if not _is_bf16_words(arr):
        raise ValueError(f"expected bfloat16 words, got {arr.dtype}")
    words = np.ascontiguousarray(arr).view(np.int16)
    return torch.from_numpy(words.copy()).view(torch.bfloat16)


def params_from_numpy(tree, device="cuda"):
    """A tree of numpy arrays (a restored checkpoint, or the reference's
    parameters as ``np.asarray`` leaves, ``ml_dtypes.bfloat16`` included)
    or host tensors as tensors on ``device``."""
    from repro_torch.device import resolve_device

    dev = resolve_device(device)

    def place(x):
        if isinstance(x, torch.Tensor):
            return x.detach().to(dev, copy=True)
        a = np.asarray(x)
        if _is_bf16_words(a):
            return _bf16_tensor(a).to(dev)
        return torch.from_numpy(np.array(a, copy=True)).to(dev)

    return tree_map(place, tree)
