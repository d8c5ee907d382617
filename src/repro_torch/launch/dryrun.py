"""Ahead-of-time dry-run: the port of ``repro.launch.dryrun``.

For every assigned (architecture × input-shape) cell and the paper's own
search step, on both production meshes (single-pod 16×16 and multi-pod
2×16×16), one rank's step is traced under ``FakeTensorMode`` over the fake
process group (``torch.distributed``'s ``"fake"`` backend, a world of 256
or 512 ranks): every tensor is a shape and a dtype with no memory, so the
trace needs no card and no cluster.  Where the reference lowers and
compiles over 512 fake XLA devices and reads the compiled module, the
trace reads what one rank runs, op by op:

  * ``flops``: ``torch.utils.flop_counter.FlopCounterMode`` over the
    rank's local tensors (a replicated product counts in full on every
    rank, a product split n ways 1/n);
  * ``bytes_accessed``: the sum, over the rank's aten ops that move data
    (not views, aliases, metadata queries or bare allocations), of the
    bytes of their tensor operands and results (the reference's
    ``cost_analysis`` counts operand and output bytes of each HLO op); the
    kernels' custom ops count theirs the same way;
  * ``collectives``: the per-rank link bytes of each c10d and functional
    collective, by the reference's ring model: all-gather, all-to-all and
    collective-permute count the result's bytes, all-reduce twice the
    result's, reduce-scatter the result's times the group size (the
    pre-scatter input);
  * ``memory``: ``argument_bytes`` (the local shards of the arguments),
    ``output_bytes`` (the distinct storages of the outputs),
    ``alias_bytes`` (outputs that are argument storages: the donated
    parameters and state the step updates in place) and ``temp_bytes``
    (the peak of live storage during the step beyond the arguments,
    tracked storage by storage with weak-reference finalizers).

Eager tracing sees every layer, so ``in_loop_bytes`` is 0 and
``loop_corrected_bytes`` equals ``total_bytes``; ``compile_s`` is the
trace's seconds.  Records are cached as JSON per (cell × mesh × variant)
under ``results/dryrun_torch/``.

The fake tensors are ``cuda`` tensors (``--device cuda``, the default) or
``cpu`` ones (``--device cpu``).  The kernels' wrappers call their custom
ops on either device, and under ``FakeTensorMode`` an op runs its fake
implementation whatever the device, so both traces follow the kernels'
route and give the same record.  A torch built without CUDA cannot trace
fake ``cuda`` tensors through Python indexing or autograd (both ask the
CUDA device guard, which such a build lacks; autograd aborts the process),
so there every step is traced on fake ``cpu`` tensors and the record says
so (``trace_device``); ``chip_smoke.py``'s phase 3k holds the ``cuda``
trace on a CUDA build to the same records.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun                # everything
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-12b
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch paper-ivf --mesh both
    PYTHONPATH=src python -m repro_torch.launch.dryrun --list
    PYTHONPATH=src python -m repro_torch.launch.dryrun --table  # the records
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback
import weakref
from typing import Optional

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

RESULTS_DIR = os.path.abspath(os.path.join(
    os.path.dirname(__file__), "..", "..", "..", "results", "dryrun_torch"))

# collective ops → the reference's kinds
_KINDS = {
    "allreduce_": "all-reduce",
    "all_reduce": "all-reduce",
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter",
    "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "all_to_all_single": "all-to-all",
    "send": "collective-permute",
    "broadcast_": "broadcast",
}
# aten ops that move no bytes: views and aliases, metadata queries, and
# allocations whose bytes nothing reads
_FREE = {"detach", "alias", "_unsafe_view", "lift_fresh", "empty",
         "empty_strided", "empty_like", "sym_size", "sym_stride",
         "sym_numel", "sym_storage_offset", "is_same_size",
         "_local_scalar_dense"}


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(x)
               if isinstance(t, torch.Tensor))


class _Tracer(TorchDispatchMode):
    """Counts bytes accessed, collective link bytes and live storage of the
    ops dispatched under it."""

    def __init__(self):
        super().__init__()
        self.bytes_accessed = 0
        self.per_kind = {}
        self.n_collectives = 0
        self._live = {}  # storage key -> bytes (non-argument storages)
        self._args = set()
        self.live_bytes = 0
        self.peak_bytes = 0

    # ---- storage tracking ----
    @staticmethod
    def _key(t: torch.Tensor):
        return id(t.untyped_storage())

    def register_args(self, tensors):
        for t in tensors:
            self._args.add(self._key(t))

    def _track(self, t: torch.Tensor):
        s = t.untyped_storage()
        key = id(s)
        if key in self._args or key in self._live:
            return
        n = s.nbytes()
        self._live[key] = n
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(s, self._free, key)

    def _free(self, key):
        self.live_bytes -= self._live.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ns = func.namespace
        name = func.__name__.split(".")[0]
        if ns in ("c10d", "_c10d_functional"):
            kind = _KINDS.get(name)
            if kind is not None:
                self._collective(kind, ns, args, out)
        elif (ns in ("aten", "repro_torch") and not func.is_view
              and name not in _FREE):
            self.bytes_accessed += _nbytes((args, kwargs)) + _nbytes(out)
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self._track(t)
        return out

    def _collective(self, kind, ns, args, out):
        if kind == "broadcast":
            return
        result = args[0] if ns == "c10d" else out
        nbytes = _nbytes(result)
        if kind == "all-reduce":
            nbytes *= 2
        elif kind == "reduce-scatter":  # the pre-scatter input
            nbytes = _nbytes(args[1] if ns == "c10d" else args[0])
        self.per_kind[kind] = self.per_kind.get(kind, 0) + nbytes
        self.n_collectives += 1


def tensors(x) -> list:
    """The tensors of a step's argument or output tree (dicts, lists,
    tuples, NamedTuples and dataclasses such as ``GraphBatch``)."""
    from repro_torch.train.tree import leaves

    return [t for t in leaves(x) if isinstance(t, torch.Tensor)]


def _storages(x) -> dict:
    return {id(t.untyped_storage()): t.untyped_storage().nbytes()
            for t in tensors(x)}


def _materialize(args, device):
    """Each ``ArgSpec`` as an empty tensor of its local shape (fake under
    an active ``FakeTensorMode``)."""
    from repro_torch.launch.specs import ArgSpec
    from repro_torch.train.tree import tree_map

    return tree_map(
        lambda a: torch.empty(a.local_shape(), dtype=a.dtype, device=device)
        if isinstance(a, ArgSpec) else a, args)


def measure_step(cell, args) -> dict:
    """Runs ``cell.fn`` on ``args`` (this rank's shards, real or fake)
    under the counters; returns the record's numbers and the outputs."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch.specs import argument_bytes

    tracer = _Tracer()
    arg_storages = _storages(args)
    tracer.register_args(tensors(args))
    t0 = time.time()
    with tracer, FlopCounterMode(display=False) as flops:
        out = cell.fn(*args)
    trace_s = time.time() - t0
    out_st = _storages(out)
    coll_total = sum(tracer.per_kind.values())
    res = dict(
        compile_s=round(trace_s, 2),
        memory=dict(
            argument_bytes=argument_bytes(cell.args),
            output_bytes=sum(out_st.values()),
            temp_bytes=tracer.peak_bytes,
            alias_bytes=sum(n for k, n in out_st.items()
                            if k in arg_storages),
        ),
        flops=float(flops.get_total_flops()),
        bytes_accessed=float(tracer.bytes_accessed),
        collectives=dict(per_kind=dict(tracer.per_kind),
                         total_bytes=coll_total, in_loop_bytes=0,
                         loop_corrected_bytes=coll_total),
        n_collectives=tracer.n_collectives,
    )
    return res, out


@contextlib.contextmanager
def fake_world(world_size: int):
    """The fake process group of ``world_size`` ranks (this process is rank
    0), torn down after."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already running: the dry-run "
                           "starts its own fake one")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def trace_device(device: str) -> str:
    """Where the steps are traced: ``device``, but ``cpu`` where this torch
    has no CUDA build (module note: the record is the same)."""
    if device == "cuda" and not torch.backends.cuda.is_built():
        return "cpu"
    return device


def trace_cell(arch: str, shape: str, multi_pod: bool, variant: str,
               device: str = "cuda", layers=None) -> dict:
    """One rank's step of the cell traced over the fake group: the
    record's numbers plus ``meta`` and ``trace_device``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.specs import build_cell

    n = 512 if multi_pod else 256
    dev = trace_device(device)
    with fake_world(n):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type=dev)
        t0 = time.time()
        cell = build_cell(arch, shape, mesh, variant, layers=layers)
        build_s = time.time() - t0
        with FakeTensorMode():
            args = _materialize(cell.args, torch.device(dev))
            res, _ = measure_step(cell, args)
    res.update(chips=n, build_s=round(build_s, 2), trace_device=dev,
               meta={k: v for k, v in cell.meta.items()
                     if isinstance(v, (int, float, str, dict, list, tuple))})
    return res


def run_cell(arch: str, shape: str, multi_pod: bool, variant: str,
             force: bool = False, device: str = "cuda",
             results_dir: Optional[str] = None, layers=None):
    """Traces one record (or reads it back) and writes it as JSON.
    ``layers``: an LM cell at reduced depth (``specs._lm_override``)."""
    results_dir = results_dir or RESULTS_DIR
    mesh_tag = "multipod512" if multi_pod else "pod256"
    depth = "" if layers is None else "__L" + "-".join(map(str, layers))
    out_path = os.path.join(
        results_dir, f"{arch}__{shape}__{mesh_tag}__{variant}{depth}.json")
    if os.path.exists(out_path) and not force:
        with open(out_path) as f:
            return json.load(f)

    t0 = time.time()
    record = dict(arch=arch, shape=shape, mesh=mesh_tag, variant=variant,
                  device=device, torch=torch.__version__)
    if layers is not None:
        record["layers"] = list(layers)
    try:
        record.update(ok=True, **trace_cell(arch, shape, multi_pod, variant,
                                            device, layers=layers))
    except Exception as e:  # a failing cell is a bug — record it loudly
        record.update(ok=False, error=f"{type(e).__name__}: {e}",
                      traceback=traceback.format_exc()[-4000:])
    os.makedirs(results_dir, exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(record, f, indent=2, default=str)
    status = "OK " if record.get("ok") else "FAIL"
    print(f"[{status}] {arch} × {shape} × {mesh_tag} × {variant} "
          f"({time.time()-t0:.0f}s)", flush=True)
    return record


HBM_BYTES = 80e9  # an H100's 80 GB a rank
_KIND_TAGS = {"all-gather": "AG", "all-reduce": "AR", "reduce-scatter": "RS",
              "all-to-all": "A2A", "collective-permute": "CP"}


def table(results_dir: Optional[str] = None) -> str:
    """The cached records as one markdown row a cell: per mesh (pod256 /
    multipod512), the exec variant's per-rank GiB of arguments, temporaries
    and their sum (the peak, ``fits`` against 80 GB), and the cost
    variant's FLOPs, bytes accessed and collective GB by kind."""
    from repro_torch.launch.specs import list_cells

    results_dir = results_dir or RESULTS_DIR
    gib = float(1 << 30)

    def rec(a, s, mesh, v):
        path = os.path.join(results_dir, f"{a}__{s}__{mesh}__{v}.json")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            r = json.load(f)
        return r if r.get("ok") else None

    lines = ["| cell | args GiB | temp GiB | peak GiB (80 GB) | TFLOP | "
             "bytes TB | collective GB |",
             "|---|---|---|---|---|---|---|"]
    for a, s, skip in list_cells():
        if skip:
            continue
        ex = [rec(a, s, m, "exec") for m in ("pod256", "multipod512")]
        co = [rec(a, s, m, "cost") for m in ("pod256", "multipod512")]
        if None in ex + co:
            lines.append(f"| {a} × {s} | missing or failed | | | | | |")
            continue
        mem = [r["memory"] for r in ex]
        peak = [m["argument_bytes"] + m["temp_bytes"] for m in mem]
        fits = ["" if p <= HBM_BYTES else " over" for p in peak]
        kinds = sorted({k for r in co for k in r["collectives"]["per_kind"]})
        coll = ", ".join(
            f"{_KIND_TAGS.get(k, k)} " + " / ".join(
                f"{r['collectives']['per_kind'].get(k, 0) / 1e9:.3g}"
                for r in co) for k in kinds) or "none"
        lines.append(
            f"| {a} × {s} | "
            + " / ".join(f"{m['argument_bytes'] / gib:.3f}" for m in mem)
            + " | " + " / ".join(f"{m['temp_bytes'] / gib:.2f}" for m in mem)
            + " | " + " / ".join(f"{p / gib:.2f}{f}"
                                 for p, f in zip(peak, fits))
            + " | " + " / ".join(f"{r['flops'] / 1e12:.4g}" for r in co)
            + " | " + " / ".join(f"{r['bytes_accessed'] / 1e12:.4g}"
                                 for r in co)
            + f" | {coll} |")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["pod256", "multipod512", "both"],
                    default="both")
    ap.add_argument("--variant", choices=["exec", "cost", "both"],
                    default="both")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="the fake tensors' device (no card is used)")
    ap.add_argument("--results-dir", default=None)
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--table", action="store_true",
                    help="print the cached records as a markdown table")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)
    if args.table:
        print(table(args.results_dir))
        return []

    from repro_torch.launch.specs import list_cells

    cells = list_cells()
    if args.list:
        for a, s, skip in cells:
            print(f"{a:20s} {s:15s} {'SKIP: ' + skip if skip else ''}")
        return []

    meshes = {"pod256": [False], "multipod512": [True],
              "both": [False, True]}[args.mesh]
    variants = {"exec": ["exec"], "cost": ["cost"],
                "both": ["exec", "cost"]}[args.variant]

    n_ok = n_fail = n_skip = 0
    records = []
    for arch, shape, skip in cells:
        if args.arch and arch != args.arch:
            continue
        if args.shape and shape != args.shape:
            continue
        if skip:
            n_skip += 1
            print(f"[SKIP] {arch} × {shape}: {skip}")
            continue
        for mp in meshes:
            for v in variants:
                rec = run_cell(arch, shape, mp, v, force=args.force,
                               device=args.device,
                               results_dir=args.results_dir)
                records.append(rec)
                if rec.get("ok"):
                    n_ok += 1
                else:
                    n_fail += 1
    print(f"\ndry-run complete: {n_ok} ok, {n_fail} failed, "
          f"{n_skip} cells skipped (documented)")
    if n_fail:
        raise SystemExit(1)
    return records


if __name__ == "__main__":
    main()
