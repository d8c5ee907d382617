"""Disk persistence: the port of ``repro.core.storage`` (layouts 1-4).

The files are the reference's, byte for byte, so a checkpoint written by
either package loads in the other:

    <dir>/manifest.json            — schema, shapes, metric, field table,
                                     record stride, shard map, SQ8 flag
    <dir>/centroids.npy            — [K, D] f32   (always resident)
    <dir>/counts.npy               — [K]    int32 (always resident)
    <dir>/summaries_*.npy          — per-cluster attribute summaries
    <dir>/bounds_{radius,slack}.npy — per-cluster score bounds
    <dir>/gens.npy                 — [K] int64 generations (layout 3;
                                     [K + P] with P sub-partitions, layout 4)
    <dir>/shard_<i>_of_<n>.bin     — fixed-stride cluster records for a
                                     contiguous cluster range; cluster ``c``
                                     of shard ``s`` lives at byte
                                     ``(c - lo_s) · record_stride``
    <dir>/partition_*.npy          — layout 4: the partition catalog, the
                                     per-sub row capacities and byte offsets
    <dir>/partitions.bin           — layout 4: the sub-partition records,
                                     each at its own stride

A record packs ``(vectors [Vpad, D], attrs [Vpad, M], ids [Vpad],
norms [Vpad]?, scales [Vpad]?, gen [1]?)`` at 64-byte-aligned offsets, its
stride rounded up to 512 bytes.  Layout 2 has no ``gen``; layout 1 is one
``.npz`` of stacked arrays per shard.  Layout 4 is layout 3 plus the
filter-specialized sub-partitions (``core/partitions.py``).

numpy has no bfloat16, so bf16 fields travel as their raw 16-bit words:
written from ``tensor.view(torch.int16)`` and read back with
``.view(torch.bfloat16)`` (in a v1 ``.npz`` they are ``V2`` words, as the
reference writes them).  Writes are atomic (tmp + rename), and
``check_complete`` verifies a checkpoint before any array is loaded.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.hybrid import HybridSpec
from repro_torch.core.ivf import IVFFlatIndex
from repro_torch.core.summaries import (
    ClusterBounds,
    ClusterSummaries,
    build_bounds,
    pad_clusters,
)
from repro_torch.device import resolve_device

MANIFEST = "manifest.json"
GENS_FILE = "gens.npy"  # layout 3: resident per-cluster generation vector


class GenerationMismatchError(ValueError):
    """The checkpoint's generation vector disagrees with its manifest (or a
    fetch was served a block older than the generation it demanded)."""


SUMMARY_FILES = dict(
    amin="summaries_amin.npy",
    amax="summaries_amax.npy",
    hist="summaries_hist.npy",
    edges_lo="summaries_edges_lo.npy",
    edges_hi="summaries_edges_hi.npy",
)
BOUNDS_FILES = dict(
    radius="bounds_radius.npy",
    slack="bounds_slack.npy",
)
# Layout 4: the resident catalog arrays (one .npy per PartitionCatalog
# field) and the variable-stride record region addressed by byte offsets.
PARTITION_FILES = dict(
    pred_lo="partition_pred_lo.npy",
    pred_hi="partition_pred_hi.npy",
    members="partition_members.npy",
    entry_rows="partition_entry_rows.npy",
    parent="partition_parent.npy",
    sub_lo="partition_sub_lo.npy",
    sub_hi="partition_sub_hi.npy",
    sub_counts="partition_sub_counts.npy",
    sub_amin="partition_sub_amin.npy",
    sub_amax="partition_sub_amax.npy",
)
PARTITION_VPADS = "partition_vpads.npy"      # [P] int32 per-sub row capacity
PARTITION_OFFSETS = "partition_offsets.npy"  # [P+1] int64 byte offsets
PARTITION_DATA = "partitions.bin"
_FIELD_ALIGN = 64     # per-field offset alignment inside a record
_RECORD_ALIGN = 512   # record stride alignment (mmap-friendly)
# Bytes of records assembled on the host per write: the writer copies the
# index to the host a slice of clusters at a time.
_WRITE_CHUNK_BYTES = 256 << 20

# manifest dtype name -> torch dtype
_TORCH_DTYPES = {
    "bfloat16": torch.bfloat16, "float16": torch.float16,
    "float32": torch.float32, "float64": torch.float64, "int8": torch.int8,
    "int16": torch.int16, "int32": torch.int32, "int64": torch.int64,
    "uint8": torch.uint8,
}
_NAMES = {v: k for k, v in _TORCH_DTYPES.items()}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a manifest dtype name."""
    return _TORCH_DTYPES[name]


def np_dtype(name: str) -> np.dtype:
    """The numpy dtype a field of manifest dtype ``name`` is read as: the
    dtype itself, or int16 words for bfloat16."""
    return np.dtype(np.int16) if name == "bfloat16" else np.dtype(name)


def _dtype_name(dtype: torch.dtype) -> str:
    return _NAMES[dtype]


def to_tensor(words: np.ndarray, name: str) -> torch.Tensor:
    """A numpy field (raw words for bfloat16) as a CPU tensor of dtype
    ``name``."""
    t = torch.from_numpy(np.ascontiguousarray(words))
    return t.view(torch.bfloat16) if name == "bfloat16" else t


def host_words(t: torch.Tensor) -> np.ndarray:
    """A tensor's contents on the host as numpy (bfloat16 as int16 words)."""
    t = t.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


def _align(off: int, a: int) -> int:
    return ((off + a - 1) // a) * a


def record_layout(
    *, vpad: int, dim: int, n_attrs: int, store_dtype: str,
    has_norms: bool, quantized: bool, with_gen: bool = False,
) -> Tuple[List[dict], int]:
    """The v2/v3 per-cluster record: ordered field table + fixed stride.

    Returns ``(fields, stride)``: each field is ``{name, dtype, shape,
    offset}`` (shape per cluster, e.g. ``[Vpad, D]``); ``stride`` is the
    record size in bytes.  ``with_gen`` (layout 3) appends the record's
    generation stamp.
    """
    specs = [("vectors", store_dtype, (vpad, dim)),
             ("attrs", "int16", (vpad, n_attrs)),
             ("ids", "int32", (vpad,))]
    if has_norms:
        specs.append(("norms", "float32", (vpad,)))
    if quantized:
        specs.append(("scales", "float32", (vpad,)))
    if with_gen:
        specs.append(("gen", "int64", (1,)))
    fields, off = [], 0
    for name, dt, shape in specs:
        off = _align(off, _FIELD_ALIGN)
        fields.append(dict(name=name, dtype=dt, shape=list(shape), offset=off))
        off += int(np.prod(shape)) * np_dtype(dt).itemsize
    return fields, _align(off, _RECORD_ALIGN)


def _atomic_save(path: str, save_fn):
    d = os.path.dirname(path)
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    os.close(fd)
    try:
        save_fn(tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _np_save(path: str, arr: np.ndarray):
    with open(path, "wb") as f:  # file handle: np.save must not append .npy
        np.save(f, arr, allow_pickle=False)


def pad_k(index: IVFFlatIndex, k_new: int) -> IVFFlatIndex:
    """Pads the cluster axis to ``k_new`` with empty, unprobeable clusters
    (``counts == 0``, zero centroids, ids -1, SQ8 scales 1, void summary
    rows)."""
    k = index.n_clusters
    if k_new < k:
        raise ValueError(f"cannot shrink K: {k} -> {k_new}")
    return _pad_clusters(index, k_new, k_new)


def _pad_clusters(index: IVFFlatIndex, k_new: int, rows_new: int
                  ) -> IVFFlatIndex:
    """:func:`pad_k`'s padding: the centroids and summaries to ``k_new``
    clusters, the per-cluster leaves (all of them, or one shard's) to
    ``rows_new``."""
    if k_new == index.n_clusters and rows_new == index.vectors.shape[0]:
        return index

    def pad(a, n, fill):
        if a is None or n == a.shape[0]:
            return a
        return torch.cat([a, torch.full((n - a.shape[0],) + tuple(a.shape[1:]),
                                        fill, dtype=a.dtype, device=a.device)])

    return dataclasses.replace(
        index,
        centroids=pad(index.centroids, k_new, 0.0),
        vectors=pad(index.vectors, rows_new, 0),
        attrs=pad(index.attrs, rows_new, 0),
        ids=pad(index.ids, rows_new, -1),
        counts=pad(index.counts, rows_new, 0),
        norms=pad(index.norms, rows_new, 0),
        scales=pad(index.scales, rows_new, 1.0),
        summaries=(None if index.summaries is None
                   else pad_clusters(index.summaries, k_new)),
    )


def _index_arrays(index: IVFFlatIndex) -> Dict[str, torch.Tensor]:
    arrays = dict(vectors=index.vectors, attrs=index.attrs, ids=index.ids)
    if index.norms is not None:
        arrays["norms"] = index.norms.float()
    if index.scales is not None:
        arrays["scales"] = index.scales.float()
    return arrays


def _base_manifest(index: IVFFlatIndex, *, n_shards: int, version: int
                   ) -> dict:
    return dict(
        version=version,
        n_clusters=index.n_clusters,
        n_shards=n_shards,
        vpad=index.vpad,
        dim=index.spec.dim,
        n_attrs=index.spec.n_attrs,
        metric=index.spec.metric,
        core_dtype=_dtype_name(index.spec.core_dtype),
        store_dtype=_dtype_name(index.vectors.dtype),
        has_norms=index.norms is not None,
        quantized=index.quantized,
        has_summaries=index.summaries is not None,
        summary_bins=(
            index.summaries.n_bins if index.summaries is not None else 0
        ),
        n_live=int(index.counts.sum()),
    )


def _v1_words(t: torch.Tensor) -> np.ndarray:
    """A field as the reference's v1 ``.npz`` holds it (bf16 as ``V2``)."""
    a = host_words(t)
    return a.view("V2") if t.dtype == torch.bfloat16 else a


def _write_records(path: str, fields: List[dict], stride: int,
                   arrays: Dict[str, torch.Tensor], lo: int, hi: int):
    """Writes clusters ``[lo, hi)`` as fixed-stride records, copying the
    fields to the host a slice of clusters at a time."""
    chunk = max(1, _WRITE_CHUNK_BYTES // stride)
    with open(path, "wb") as f:
        for c0 in range(lo, hi, chunk):
            c1 = min(c0 + chunk, hi)
            buf = np.zeros((c1 - c0, stride), np.uint8)
            for fld in fields:
                raw = host_words(arrays[fld["name"]][c0:c1])
                raw = raw.reshape(c1 - c0, -1).view(np.uint8)
                o = fld["offset"]
                buf[:, o:o + raw.shape[1]] = raw
            f.write(memoryview(buf).cast("B"))


def partition_record_layout(man: dict, vpad: int) -> Tuple[List[dict], int]:
    """The field table and stride of one sub-partition record (layout 4):
    the base records' field order at the sub's own row capacity."""
    return record_layout(
        vpad=int(vpad), dim=man["dim"], n_attrs=man["n_attrs"],
        store_dtype=man["store_dtype"], has_norms=man["has_norms"],
        quantized=man["quantized"], with_gen=True)


def write_partition_region(directory: str, man: dict, build,
                           sub_gens: np.ndarray) -> None:
    """Writes the layout-4 partition plane: the variable-stride record
    region (``partitions.bin`` and its byte offsets), the per-sub
    capacities and the resident catalog files.  ``save_index`` and
    ``compact_deltas`` share it, so a republish writes the build's
    format."""
    cat = build.catalog
    p = build.n_subs
    sub_gens = np.asarray(sub_gens, np.int64)
    offsets = np.zeros(p + 1, np.int64)

    def _bin_save(path):
        with open(path, "wb") as f:
            off = 0
            for j, rec in enumerate(build.records):
                fields, stride = partition_record_layout(
                    man, int(build.vpads[j]))
                buf = np.zeros(stride, np.uint8)
                for fld in fields:
                    if fld["name"] == "gen":
                        raw = np.asarray([sub_gens[j]], np.int64)
                    else:
                        raw = host_words(rec[fld["name"]])
                    raw = raw.reshape(-1).view(np.uint8)
                    o = fld["offset"]
                    buf[o:o + raw.size] = raw
                f.write(buf.tobytes())
                offsets[j] = off
                off += stride
            offsets[p] = off

    _atomic_save(os.path.join(directory, PARTITION_DATA), _bin_save)
    _atomic_save(os.path.join(directory, PARTITION_OFFSETS),
                 lambda path: _np_save(path, offsets))
    _atomic_save(os.path.join(directory, PARTITION_VPADS),
                 lambda path: _np_save(path, np.asarray(build.vpads,
                                                         np.int32)))
    for field, fname in PARTITION_FILES.items():
        _atomic_save(os.path.join(directory, fname),
                     lambda path, f=field: _np_save(
                         path, np.asarray(getattr(cat, f))))


def save_index(index: IVFFlatIndex, directory: str, *, n_shards: int = 1,
               version: int = 0, layout: int = 3,
               gens: Optional[np.ndarray] = None,
               partitions=None) -> None:
    """Writes the index as ``n_shards`` contiguous cluster-range files.

    ``layout=3`` (default) writes the fixed-stride record format with
    per-cluster generation stamps (``gens``, default all-zero) plus the
    resident ``gens.npy``; ``layout=2`` is the same record format without
    generations; ``layout=1`` writes one ``.npz`` per shard.  ``layout=4``
    also writes the sub-partitions of ``partitions`` (a
    :class:`~repro_torch.core.partitions.PartitionBuild` of this index);
    its ``gens`` may cover the base clusters (``[K]``: each sub inherits
    its parent's generation) or every id (``[K + n_subs]``).  The index
    may live on the card: the records are copied to the host a slice of
    clusters at a time.
    """
    k = index.n_clusters
    if k % n_shards:
        raise ValueError(f"K={k} not divisible by n_shards={n_shards}; pad_k first")
    if layout not in (1, 2, 3, 4):
        raise ValueError(f"unknown layout {layout}")
    if layout == 4 and partitions is None:
        raise ValueError("layout=4 needs partitions= (a PartitionBuild)")
    if layout != 4 and partitions is not None:
        raise ValueError("partitions= needs layout=4")
    n_subs = partitions.n_subs if partitions is not None else 0
    if gens is None:
        gens = np.zeros(k + n_subs, np.int64)
    gens = np.asarray(gens, np.int64)
    if layout == 4 and gens.shape == (k,):
        # a base-only vector: sub-partitions inherit their parent's gen
        sub = gens[np.asarray(partitions.catalog.parent, np.int64)]
        gens = np.concatenate([gens, sub])
    expect = (k + n_subs,) if layout == 4 else (k,)
    if gens.shape != expect:
        raise GenerationMismatchError(
            f"gens shape {gens.shape} != {expect} clusters")
    os.makedirs(directory, exist_ok=True)
    kl = k // n_shards
    manifest = _base_manifest(index, n_shards=n_shards, version=version)
    arrays = _index_arrays(index)
    if layout >= 3:
        arrays["gen"] = torch.from_numpy(gens[:k, None])

    _atomic_save(os.path.join(directory, "centroids.npy"),
                 lambda p: _np_save(p, host_words(index.centroids.float())))
    if index.summaries is not None:
        for field, fname in SUMMARY_FILES.items():
            _atomic_save(
                os.path.join(directory, fname),
                lambda p, f=field: _np_save(
                    p, host_words(getattr(index.summaries, f))),
            )
    # resident score bounds, from the flat lists the writer holds anyway
    bounds = build_bounds(index.centroids, index.vectors, index.ids,
                          index.norms, index.scales)
    for field, fname in BOUNDS_FILES.items():
        _atomic_save(os.path.join(directory, fname),
                     lambda p, f=field: _np_save(
                         p, host_words(getattr(bounds, f))))
    manifest["has_bounds"] = True

    if layout == 1:
        for s in range(n_shards):
            lo, hi = s * kl, (s + 1) * kl
            payload = {name: _v1_words(a[lo:hi]) for name, a in arrays.items()}
            payload["counts"] = host_words(index.counts[lo:hi].int())

            def _npz_save(p, pl):
                with open(p, "wb") as f:
                    np.savez(f, **pl)

            _atomic_save(
                os.path.join(directory, f"shard_{s}_of_{n_shards}.npz"),
                lambda p, pl=payload: _npz_save(p, pl),
            )
        manifest["layout"] = 1
    else:
        fields, stride = record_layout(
            vpad=index.vpad, dim=index.spec.dim, n_attrs=index.spec.n_attrs,
            store_dtype=manifest["store_dtype"],
            has_norms=manifest["has_norms"], quantized=index.quantized,
            with_gen=layout >= 3,
        )
        _atomic_save(os.path.join(directory, "counts.npy"),
                     lambda p: _np_save(p, host_words(index.counts.int())))
        if layout >= 3:
            _atomic_save(os.path.join(directory, GENS_FILE),
                         lambda p: _np_save(p, gens))
        for s in range(n_shards):
            _atomic_save(
                os.path.join(directory, f"shard_{s}_of_{n_shards}.bin"),
                lambda p, lo=s * kl, hi=(s + 1) * kl: _write_records(
                    p, fields, stride, arrays, lo, hi),
            )
        manifest.update(layout=layout, layout_minor=1, record_stride=stride,
                        fields=fields)
        if layout == 4:
            write_partition_region(directory, manifest, partitions, gens[k:])
            manifest["has_partitions"] = True
            manifest["partitions"] = dict(
                n_subs=n_subs, n_entries=partitions.catalog.n_entries)

    def _write_manifest(p):
        with open(p, "w") as f:
            f.write(json.dumps(manifest, indent=2))

    _atomic_save(os.path.join(directory, MANIFEST), _write_manifest)


def load_manifest(directory: str) -> dict:
    with open(os.path.join(directory, MANIFEST)) as f:
        man = json.load(f)
    man.setdefault("layout", 1)        # pre-v2 checkpoints
    man.setdefault("quantized", False)  # pre-SQ8-fix checkpoints
    man.setdefault("has_summaries", False)  # pre-v2.1: no pruning, sound
    man.setdefault("has_bounds", False)
    man.setdefault("has_partitions", False)
    return man


def load_summaries(directory: str, man: dict, *, device="cuda"
                   ) -> Optional[ClusterSummaries]:
    """The resident summary arrays on ``device``, or None for checkpoints
    without them (missing summaries simply disable probe pruning)."""
    if not man.get("has_summaries"):
        return None
    dev = resolve_device(device)
    return ClusterSummaries(**{
        f: torch.from_numpy(np.load(os.path.join(directory, fname))).to(dev)
        for f, fname in SUMMARY_FILES.items()
    })


def load_bounds(directory: str, man: dict, *, device="cuda"
                ) -> Optional[ClusterBounds]:
    """The resident per-cluster score bounds on ``device``, or None for
    checkpoints written before they existed."""
    if not man.get("has_bounds"):
        return None
    dev = resolve_device(device)
    return ClusterBounds(**{
        f: torch.from_numpy(np.load(os.path.join(directory, fname))).to(dev)
        for f, fname in BOUNDS_FILES.items()
    })


def load_gens(directory: str, man: dict) -> np.ndarray:
    """Resident per-cluster generation vector ``[K] int64`` (``[K + P]`` on
    layout 4: the sub-partitions' generations follow the base ones): zeros
    before layout 3; from layout 3 the file must exist and match the
    manifest's cluster count."""
    k = man["n_clusters"]
    if man.get("layout", 1) >= 4:
        k += int(man.get("partitions", {}).get("n_subs", 0))
    if man.get("layout", 1) < 3:
        return np.zeros(k, np.int64)
    path = os.path.join(directory, GENS_FILE)
    if not os.path.exists(path):
        raise GenerationMismatchError(
            f"layout-3 checkpoint missing {GENS_FILE}: {directory}")
    gens = np.asarray(np.load(path), np.int64)
    if gens.shape != (k,):
        raise GenerationMismatchError(
            f"{GENS_FILE} has {gens.shape} entries, manifest says "
            f"{k} clusters: {directory}")
    return gens


def load_partitions(directory: str, man: dict):
    """The resident partition catalog, or None before layout 4 (every
    query then takes the flat path)."""
    if not man.get("has_partitions"):
        return None
    from repro_torch.core.partitions import PartitionCatalog

    return PartitionCatalog(n_base=man["n_clusters"], **{
        f: np.load(os.path.join(directory, fname))
        for f, fname in PARTITION_FILES.items()})


def load_partition_vpads(directory: str) -> np.ndarray:
    return np.asarray(np.load(os.path.join(directory, PARTITION_VPADS)),
                      np.int32)


def load_partition_records(directory: str, man: dict
                           ) -> List[Dict[str, torch.Tensor]]:
    """Every sub-partition record of the variable-stride region, as CPU
    tensors (offline use: the RAM load and the republish; serving reads
    single records through ``ShardReader.read``)."""
    vpads = load_partition_vpads(directory)
    offsets = np.asarray(np.load(os.path.join(directory, PARTITION_OFFSETS)),
                         np.int64)
    raw = np.fromfile(os.path.join(directory, PARTITION_DATA), np.uint8)
    out = []
    for j, vp in enumerate(vpads):
        fields, stride = partition_record_layout(man, int(vp))
        chunk = raw[offsets[j]:offsets[j] + stride]
        rec = {}
        for fld in fields:
            dt = np_dtype(fld["dtype"])
            nb = int(np.prod(fld["shape"])) * dt.itemsize
            o = fld["offset"]
            rec[fld["name"]] = to_tensor(
                chunk[o:o + nb].view(dt).reshape(tuple(fld["shape"])),
                fld["dtype"])
        out.append(rec)
    return out


def shard_paths(directory: str, man: dict) -> List[str]:
    ext = "bin" if man["layout"] >= 2 else "npz"
    n = man["n_shards"]
    return [os.path.join(directory, f"shard_{s}_of_{n}.{ext}")
            for s in range(n)]


def check_complete(directory: str, man: dict) -> List[str]:
    """The shard paths, once every file the manifest names exists (and,
    from layout 3, the generation vector agrees with it)."""
    paths = shard_paths(directory, man)
    required = list(paths)
    if man.get("has_summaries"):
        required += [os.path.join(directory, f) for f in SUMMARY_FILES.values()]
    if man.get("has_bounds"):
        required += [os.path.join(directory, f) for f in BOUNDS_FILES.values()]
    if man.get("layout", 1) >= 3:
        required.append(os.path.join(directory, GENS_FILE))
    if man.get("has_partitions"):
        required += [os.path.join(directory, f)
                     for f in (*PARTITION_FILES.values(), PARTITION_VPADS,
                               PARTITION_OFFSETS, PARTITION_DATA)]
    missing = [p for p in required if not os.path.exists(p)]
    if missing:
        raise FileNotFoundError(f"incomplete checkpoint, missing: {missing}")
    if man.get("layout", 1) >= 3:
        load_gens(directory, man)  # raises GenerationMismatchError on skew
    return paths


def spec_from_manifest(man: dict) -> HybridSpec:
    return HybridSpec(dim=man["dim"], n_attrs=man["n_attrs"],
                      core_dtype=torch_dtype(man["core_dtype"]),
                      metric=man["metric"])


def _load_v1(directory: str, man: dict, paths: List[str], dev
             ) -> IVFFlatIndex:
    parts = [np.load(p) for p in paths]

    def cat(key):
        a = np.concatenate([p[key] for p in parts], 0)
        if a.dtype.kind == "V":  # bfloat16 words
            return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        return torch.from_numpy(a)

    spec = spec_from_manifest(man)
    stored_int8 = parts[0]["vectors"].dtype == np.int8
    if man["quantized"] or stored_int8:
        # int8 codes without scales were written by a writer that dropped
        # them; scoring the raw codes would be silently wrong
        if "scales" not in parts[0].files:
            raise ValueError(
                "quantized checkpoint has no 'scales' payload (written by a "
                "pre-fix save_index); rebuild and re-save the index")
        vectors = cat("vectors")
        scales = cat("scales").to(dev)
    else:
        vectors = cat("vectors").to(spec.core_dtype)
        scales = None
    return IVFFlatIndex(
        spec=spec,
        centroids=torch.from_numpy(
            np.load(os.path.join(directory, "centroids.npy"))).to(dev),
        vectors=vectors.to(dev),
        attrs=cat("attrs").to(dev),
        ids=cat("ids").to(dev),
        counts=cat("counts").to(dev),
        norms=cat("norms").to(dev) if man["has_norms"] else None,
        scales=scales,
        summaries=load_summaries(directory, man, device=dev),
    )


def read_shard_fields(path: str, man: dict, start: int = 0,
                      count: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """Reads records ``[start, start + count)`` (default: every record) of
    one v2/v3 shard file into per-field CPU tensors ``[count,
    *field_shape]``.  The records have a fixed stride, so only that range is
    read, one field at a time (no copy of the whole records)."""
    stride = man["record_stride"]
    size = os.path.getsize(path)
    if size % stride:
        raise ValueError(f"{path}: size {size} not a stride multiple")
    n = size // stride
    count = n - start if count is None else count
    if not 0 <= start <= start + count <= n:
        raise ValueError(f"{path}: records [{start}, {start + count}) out of "
                         f"[0, {n})")
    raw = (np.memmap(path, np.uint8, mode="r", offset=start * stride,
                     shape=(count, stride)) if count
           else np.empty((0, stride), np.uint8))
    out = {}
    for fld in man["fields"]:
        dt = np_dtype(fld["dtype"])
        nb = int(np.prod(fld["shape"])) * dt.itemsize
        o = fld["offset"]
        flat = np.array(raw[:, o:o + nb]).view(dt)  # a copy, off the map
        out[fld["name"]] = to_tensor(
            flat.reshape((count,) + tuple(fld["shape"])), fld["dtype"])
    del raw
    return out


def _load_v2(directory: str, man: dict, paths: List[str], dev,
             lo: int = 0, hi: Optional[int] = None) -> IVFFlatIndex:
    """Clusters ``[lo, hi)`` (default: all) of a fixed-stride checkpoint,
    read from only the records they span; centroids and summaries whole."""
    k = man["n_clusters"]
    hi = k if hi is None else hi
    kf = k // man["n_shards"]  # clusters a shard file holds
    parts = []
    for f, path in enumerate(paths):
        a, b = max(lo, f * kf), min(hi, (f + 1) * kf)
        if a < b:
            parts.append(read_shard_fields(path, man, a - f * kf, b - a))
    if not parts:
        parts = [read_shard_fields(paths[0], man, 0, 0)]

    def cat(key):
        return torch.cat([p[key] for p in parts], 0).to(dev)

    counts = np.load(os.path.join(directory, "counts.npy"), mmap_mode="r")
    return IVFFlatIndex(
        spec=spec_from_manifest(man),
        centroids=torch.from_numpy(
            np.load(os.path.join(directory, "centroids.npy"))).to(dev),
        vectors=cat("vectors"),
        attrs=cat("attrs"),
        ids=cat("ids"),
        counts=torch.from_numpy(np.array(counts[lo:hi])).to(dev),
        norms=cat("norms") if man["has_norms"] else None,
        scales=cat("scales") if man["quantized"] else None,
        summaries=load_summaries(directory, man, device=dev),
    )


def _target_k(k: int, target_shards: Optional[int]) -> int:
    """K padded to a multiple of ``target_shards``, as :func:`load_index`
    pads it."""
    if target_shards and k % target_shards:
        return ((k + target_shards - 1) // target_shards) * target_shards
    return k


def load_index(directory: str, *, target_shards: Optional[int] = None,
               device="cuda") -> IVFFlatIndex:
    """Restores an index onto ``device``; ``target_shards`` pads K for a new
    shard count.  Reads layouts 2-4 (fixed-stride records) and 1 (npz); a
    layout-4 index comes back with its sub-partitions attached
    (``partitions.attach``), so the RAM engine routes as the disk tier does.

    Every file is verified to exist before anything loads.  For an index
    larger than memory, open it with
    :class:`repro_torch.core.disk.DiskIVFIndex` instead.
    """
    dev = resolve_device(device)
    man = load_manifest(directory)
    paths = check_complete(directory, man)
    index = (_load_v2(directory, man, paths, dev) if man["layout"] >= 2
             else _load_v1(directory, man, paths, dev))
    if man.get("has_partitions"):
        from repro_torch.core import partitions as partitions_lib

        if target_shards and index.n_clusters % target_shards:
            raise ValueError(
                "target_shards re-padding is unsupported for a partitioned "
                "(layout 4) checkpoint: re-save the base index first")
        build = partitions_lib.PartitionBuild(
            catalog=load_partitions(directory, man),
            records=[{f: t for f, t in rec.items() if f != "gen"}
                     for rec in load_partition_records(directory, man)],
            vpads=load_partition_vpads(directory))
        return partitions_lib.attach(index, build)
    return pad_k(index, _target_k(index.n_clusters, target_shards))


def load_index_shard(directory: str, shard_id: int, n_shards: int, *,
                     target_shards: Optional[int] = None, device="cuda"
                     ) -> IVFFlatIndex:
    """Shard ``shard_id`` of ``n_shards`` of a layout-2/3 checkpoint, read
    from only the records of its cluster range: byte for byte
    ``distributed.local_shard(load_index(directory, target_shards=
    target_shards), shard_id, n_shards)``, without loading the rest (each
    rank of a sharded search holds ``[K/S, Vpad, D]``).  ``target_shards``
    pads K as :func:`load_index` does; the padded K must divide over
    ``n_shards``."""
    dev = resolve_device(device)
    man = load_manifest(directory)
    paths = check_complete(directory, man)
    if man["layout"] < 2 or man.get("has_partitions"):
        raise ValueError(
            f"load_index_shard reads layouts 2 and 3, not layout "
            f"{man['layout']}: use load_index and distributed.local_shard")
    k = man["n_clusters"]
    k_new = _target_k(k, target_shards)
    if k_new % n_shards:
        raise ValueError(f"K={k_new} must divide over {n_shards} shards; "
                         "pass target_shards")
    if not 0 <= shard_id < n_shards:
        raise ValueError(f"shard_id {shard_id} out of [0, {n_shards})")
    kl = k_new // n_shards
    lo, hi = shard_id * kl, (shard_id + 1) * kl
    index = _load_v2(directory, man, paths, dev, min(lo, k), min(hi, k))
    return _pad_clusters(index, k_new, kl)
