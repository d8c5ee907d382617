"""The port's dry-run (``repro_torch.launch.dryrun``) on the CPU over the
fake process group: its counters on hand-made steps, one cell of each
family end to end through ``run_cell``, the reference's linear probe
synthesis against the full-depth trace, the three kernels' custom ops
(fake implementations and ``opcheck``), and the production layouts' math
on two gloo ranks against one device.
"""

from __future__ import annotations

import dataclasses
import json
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

TIMEOUT_S = 300


def _cell(fn, args):
    from repro_torch.launch.specs import Cell

    return Cell("test", "test", "test", fn, tuple(args), meta={})


def _fake_run(world, mesh_shape, names, fn, arg_specs):
    """``fn`` traced as one rank's step of a ``world``-rank fake group."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh

    with dryrun.fake_world(world):
        mesh = make_mesh(mesh_shape, names, device_type="cpu")
        cell = _cell(lambda *a: fn(mesh, *a), arg_specs)
        with FakeTensorMode():
            args = dryrun._materialize(cell.args, torch.device("cpu"))
            res, _ = dryrun.measure_step(cell, args)
    return res


def _spec(shape, dtype=torch.float32, mesh_shape=(2, 4), placements=None):
    from torch.distributed.tensor import Replicate

    from repro_torch.launch.specs import ArgSpec

    return ArgSpec(shape, dtype, placements or (Replicate(),) * len(
        mesh_shape), mesh_shape)


# ------------------------------------------------------------ counters ---
def test_collective_bytes_follow_the_ring_model():
    """all-gather: the result's bytes; all-reduce: twice the result's;
    reduce-scatter: the result's times the group (the pre-scatter
    input)."""
    from repro_torch.launch.mesh import (
        all_gather_dim, all_reduce_sum, reduce_scatter_dim,
    )

    def step(mesh, x):
        g = mesh.get_group("model")  # 4 ranks
        a = all_gather_dim(x, g, 0)  # [256, 32] f32 = 32 KiB
        b = all_reduce_sum(x, mesh.get_group("data"))  # [64, 32]: 8 KiB
        c = reduce_scatter_dim(x, g, 0)  # result [16, 32]: 2 KiB
        return a, b, c

    res = _fake_run(8, (2, 4), ("data", "model"), step, [_spec((64, 32))])
    kinds = res["collectives"]["per_kind"]
    assert kinds == {"all-gather": 256 * 32 * 4,
                     "all-reduce": 2 * 64 * 32 * 4,
                     "reduce-scatter": 16 * 32 * 4 * 4}
    c = res["collectives"]
    assert c["total_bytes"] == sum(kinds.values())
    assert c["loop_corrected_bytes"] == c["total_bytes"]
    assert c["in_loop_bytes"] == 0
    assert res["n_collectives"] == 3


def test_per_rank_flops_of_replicated_and_split_products():
    """A replicated product counts in full on every rank, one split n ways
    (its rows a shard each) 1/n."""
    from torch.distributed.tensor import Replicate, Shard

    m, k, n = 64, 128, 256
    full = 2 * m * k * n

    def step(mesh, x, w):
        return x @ w

    rep = _fake_run(8, (2, 4), ("data", "model"), step,
                    [_spec((m, k)), _spec((k, n))])
    assert rep["flops"] == full
    split = _fake_run(8, (2, 4), ("data", "model"), step, [
        _spec((m, k), placements=(Replicate(), Shard(0))),
        _spec((k, n))])
    assert split["flops"] == full // 4
    # bytes: operands and result of the one product
    assert split["bytes_accessed"] == 4 * (m // 4 * k + k * n + m // 4 * n)
    assert split["memory"]["argument_bytes"] == 4 * (m // 4 * k + k * n)


def test_memory_counts_temporaries_outputs_and_aliases():
    """temp: the peak of live storage beyond the arguments; alias: outputs
    that are argument storages (an in-place update, as a donated buffer)."""
    def step(mesh, x):
        t = x * 2.0  # 4 KiB, freed after
        u = t + 1.0  # 4 KiB: peak 8 KiB
        del t
        x.copy_(u)
        return x, u.sum()

    res = _fake_run(8, (2, 4), ("data", "model"), step, [_spec((32, 32))])
    mem = res["memory"]
    assert mem["argument_bytes"] == 4096
    assert mem["temp_bytes"] == 8192
    assert mem["alias_bytes"] == 4096
    assert mem["output_bytes"] == 4096 + 4


# ---------------------------------------------------- one cell a family ---
def _ivf_flops(rec):
    """The paper's search: every rank scores the [Q, K] centroids (the
    reference's replicated plan) and scans its P_cap slots of Vpad rows."""
    from repro_torch.launch.specs import IVF_SHAPE as sh

    return (2 * sh["q"] * sh["k_clusters"] * sh["d"]
            + 2 * rec["meta"]["p_cap"] * sh["vpad"] * sh["d"])


def _wide_deep_flops(rec):
    """wide-deep's train step: the deep tower's products, forward and the
    two of the backward, over the rank's 65536 / 16 rows (the dense tower
    is replicated over ``model``, as the reference's ``P()`` weights are;
    the reference's formula takes the tower's input as 4·D + n_dense, the
    config's is 40·D + n_dense)."""
    dims = (40 * 32 + 13, 1024, 512, 256, 1)
    return 6 * (65536 // 16) * sum(a * b for a, b in zip(dims, dims[1:]))


# (arch, shape, layers, exact per-rank FLOPs, or bounds on the per-rank
# FLOPs over the rank's share of model_flops)
FAMILY_CELLS = [
    ("paper-ivf", "search_1b", None, _ivf_flops),
    ("wide-deep", "train_batch", None, _wide_deep_flops),
    ("dimenet", "molecule", None, (0.5, 3.0)),
    ("deepseek-moe-16b", "train_4k", (1, 1), (0.5, 2.0)),
    ("gemma3-12b", "decode_32k", None, (0.5, 2.0)),
]


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("arch,shape,layers,bounds", FAMILY_CELLS,
                         ids=[f"{a}-{s}" for a, s, _, _ in FAMILY_CELLS])
def test_run_cell_one_of_each_family(tmp_path, arch, shape, layers, bounds,
                                     device):
    """``run_cell`` writes an ``ok`` record with the reference's keys, and
    the rank's FLOPs are exact where a formula counts every product of the
    rank (the paper's search, wide-deep), else within a stated factor of
    its share of ``model_flops``: the LM and DimeNet formulas count the
    matmuls a token or node needs (attention and the readout partly), the
    trace every product the rank runs, Megatron's split of the LM over
    ``model`` included."""
    from repro_torch.launch import dryrun

    rec = dryrun.run_cell(arch, shape, False, "exec", device=device,
                          results_dir=str(tmp_path), layers=layers)
    assert rec["ok"], rec.get("traceback")
    files = list(tmp_path.glob("*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        assert json.load(f)["ok"]
    for key in ("chips", "compile_s", "memory", "flops", "bytes_accessed",
                "collectives", "meta"):
        assert key in rec
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes",
                                  "temp_bytes", "alias_bytes"}
    assert set(rec["collectives"]) == {"per_kind", "total_bytes",
                                       "in_loop_bytes",
                                       "loop_corrected_bytes"}
    assert rec["chips"] == 256
    want_dev = ("cpu" if device == "cuda"
                and not torch.backends.cuda.is_built() else device)
    assert rec["trace_device"] == want_dev
    share = rec["meta"]["model_flops"] / rec["chips"]
    if callable(bounds):
        assert rec["flops"] == bounds(rec)
    else:
        lo, hi = bounds
        assert lo <= rec["flops"] / share <= hi, rec["flops"] / share
    assert rec["collectives"]["total_bytes"] > 0
    # a second call reads the record back
    assert dryrun.run_cell(arch, shape, False, "exec", device=device,
                           results_dir=str(tmp_path),
                           layers=layers)["compile_s"] == rec["compile_s"]


def test_a_failing_cell_is_recorded_loudly(tmp_path, monkeypatch):
    """A cell that raises is recorded with its traceback, and ``main``
    ends non-zero."""
    from repro_torch.launch import dryrun, specs

    rec = dryrun.run_cell("no-such-arch", "train_4k", False, "exec",
                          device="cpu", results_dir=str(tmp_path))
    assert rec["ok"] is False
    assert "ValueError" in rec["error"] and "Traceback" in rec["traceback"]
    monkeypatch.setattr(specs, "list_cells",
                        lambda: [("no-such-arch", "train_4k", None)])
    with pytest.raises(SystemExit) as exc:
        dryrun.main(["--mesh", "pod256", "--variant", "exec", "--device",
                     "cpu", "--results-dir", str(tmp_path), "--force"])
    assert exc.value.code == 1


def test_the_sandbox_paper_ivf_records_are_current(tmp_path):
    """``tests/data/dryrun_paper_ivf.json`` (what ``chip_smoke.py``'s phase
    3k holds the card's dry-run against) equals a fresh trace of the
    paper-ivf cells on fake cpu tensors, key for key."""
    from pathlib import Path

    from repro_torch.launch import dryrun

    with open(Path(__file__).parent / "data" / "dryrun_paper_ivf.json") as f:
        want = {(r["shape"], r["mesh"], r["variant"]): r for r in json.load(f)}
    recs = dryrun.main(["--arch", "paper-ivf", "--mesh", "both", "--device",
                        "cpu", "--results-dir", str(tmp_path)])
    assert len(recs) == len(want) == 12
    for r in recs:
        w = want[(r["shape"], r["mesh"], r["variant"])]
        for k, v in w.items():
            assert json.loads(json.dumps(r[k])) == v, (r["shape"], k)


def test_list_prints_the_reference_rows(capsys):
    from repro_torch.launch import dryrun

    dryrun.main(["--list"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 46
    assert sum("SKIP: " in line for line in lines) == 3


# ------------------------------------------------------- probe synthesis ---
@pytest.mark.parametrize("arch", ["chatglm3-6b", "deepseek-moe-16b"])
def test_probe_synthesis_equals_the_full_depth_trace(arch):
    """The reference's linear synthesis from reduced-depth probes equals
    the full-depth trace: every layer of a stack costs the same."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.specs import lm_probe_plan

    shape = "decode_32k"
    probes, solve = lm_probe_plan(arch, shape)
    runs = [dryrun.trace_cell(arch, shape, False, "exec", "cpu", layers=p)
            for p in probes]
    full = dryrun.trace_cell(arch, shape, False, "exec", "cpu")
    for key in ("flops", "bytes_accessed"):
        assert solve(*[r[key] for r in runs]) == pytest.approx(
            full[key], rel=1e-9), key
    tot = [r["collectives"]["total_bytes"] for r in runs]
    assert solve(*tot) == pytest.approx(
        full["collectives"]["total_bytes"], rel=1e-9)


# ----------------------------------------------------------- kernel ops ---
def _kernel_inputs(seed, k=7, vpad=19, d=24, m=3, f=2, q=10, p=13):
    rng = np.random.default_rng(seed)
    t = torch.from_numpy
    return dict(
        queries=t(rng.standard_normal((q, d), dtype=np.float32)),
        centroids=t(rng.standard_normal((k, d), dtype=np.float32)),
        vectors=t(rng.standard_normal((k, vpad, d), dtype=np.float32)),
        attrs=t(rng.integers(0, 6, (k, vpad, m)).astype(np.int16)),
        ids=t(np.arange(k * vpad, dtype=np.int32).reshape(k, vpad)),
        lo=t(np.zeros((q, f, m), np.int16)),
        hi=t(rng.integers(2, 6, (q, f, m)).astype(np.int16)),
        slot_cluster=t(rng.integers(0, k, p).astype(np.int32)),
        slot_query=t(rng.integers(0, q, p).astype(np.int32)),
    )


def _op_calls(x):
    """(op, args, plain version) of the three kernels."""
    from repro_torch.kernels.centroid_topk.ref import centroid_topk_ref
    from repro_torch.kernels.filtered_scan.ref import (
        filtered_scan_ref, filtered_scan_tiled_ref,
    )

    qb = 8
    qpad = torch.cat([x["queries"], x["queries"][:6]])  # 16 rows, 2 tiles
    lo = torch.cat([x["lo"], x["lo"][:6]])
    hi = torch.cat([x["hi"], x["hi"][:6]])
    s = x["slot_cluster"].shape[0]
    tile = (torch.arange(s, dtype=torch.int32) % 2).int()
    ops = torch.ops.repro_torch
    return [
        (ops.centroid_topk.default, (x["queries"], x["centroids"], 5, "dot"),
         lambda: centroid_topk_ref(x["queries"], x["centroids"], t=5)),
        (ops.filtered_scan.default,
         (x["slot_cluster"], x["slot_query"], x["queries"], x["lo"],
          x["hi"], x["vectors"], x["attrs"], x["ids"], None, None, "dot"),
         lambda: filtered_scan_ref(x["slot_cluster"], x["slot_query"],
                                   x["queries"], x["lo"], x["hi"],
                                   x["vectors"], x["attrs"], x["ids"])),
        (ops.filtered_scan_tiled.default,
         (x["slot_cluster"], tile, None, qpad, lo, hi, x["vectors"],
          x["attrs"], x["ids"], None, None, "dot", 23, qb),
         lambda: filtered_scan_tiled_ref(x["slot_cluster"], tile, None, qpad,
                                         lo, hi, x["vectors"], x["attrs"],
                                         x["ids"], k=23, q_block=qb)),
    ]


@pytest.mark.parametrize("which", [0, 1, 2],
                         ids=["centroid_topk", "filtered_scan",
                              "filtered_scan_tiled"])
def test_kernel_op_fake_matches_the_plain_version(which):
    """At ragged shapes (K, Vpad, D, Q and P no multiples of anything; k
    past Vpad for the tiled scan), the fake implementation's outputs have
    the plain version's shapes and dtypes, on fake CPU and CUDA tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    import repro_torch.kernels.centroid_topk.centroid_topk  # noqa: F401
    import repro_torch.kernels.filtered_scan.filtered_scan  # noqa: F401

    x = _kernel_inputs(which)
    op, args, plain = _op_calls(x)[which]
    want = plain()
    want = want if isinstance(want, tuple) else (want,)
    for device in ("cpu", "cuda"):
        with FakeTensorMode() as mode:
            fargs = [mode.from_tensor(a) if isinstance(a, torch.Tensor)
                     else a for a in args]
            if device == "cuda":
                fargs = [torch.empty(a.shape, dtype=a.dtype, device="cuda")
                         if isinstance(a, torch.Tensor) else a for a in fargs]
            got = op(*fargs)
        got = got if isinstance(got, tuple) else (got,)
        assert [(tuple(g.shape), g.dtype) for g in got] == [
            (tuple(w.shape), w.dtype) for w in want]
        assert all(g.device.type == device for g in got)


@pytest.mark.parametrize("which", [0, 1, 2],
                         ids=["centroid_topk", "filtered_scan",
                              "filtered_scan_tiled"])
def test_kernel_op_opcheck_and_cpu_values(which):
    """``torch.library.opcheck`` passes on the CPU (schema, fake and
    autograd registration), and the op's CPU implementation is the plain
    version, value for value."""
    import repro_torch.kernels.centroid_topk.centroid_topk  # noqa: F401
    import repro_torch.kernels.filtered_scan.filtered_scan  # noqa: F401

    x = _kernel_inputs(10 + which)
    op, args, plain = _op_calls(x)[which]
    torch.library.opcheck(op, args)
    got = op(*args)
    want = plain()
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert torch.equal(g, w)


def _wrapper_call(which, args):
    """The kernel's wrapper on the op's arguments (``_op_calls``)."""
    from repro_torch.kernels.centroid_topk import centroid_topk as ct
    from repro_torch.kernels.filtered_scan import filtered_scan as fs

    if which == 0:
        return ct.centroid_topk(args[0], args[1], t=args[2], metric=args[3])
    if which == 1:
        return fs.filtered_scan(*args[:10], metric=args[10])
    return fs.filtered_scan_tiled(*args[:11], metric=args[11], k=args[12],
                                  q_block=args[13])


@pytest.mark.parametrize("which", [0, 1, 2],
                         ids=["centroid_topk", "filtered_scan",
                              "filtered_scan_tiled"])
def test_wrappers_call_their_op_on_the_cpu_too(which):
    """A wrapper dispatches its op and nothing else on CPU tensors, as on
    CUDA ones: a real call (the op's CPU implementation is the plain
    version, value for value), and a trace on fake CPU tensors, which so
    follows the kernels' route (the op's fake implementation) as the
    trace on fake CUDA tensors does."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils._python_dispatch import TorchDispatchMode

    class Seen(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(func)
            return func(*args, **(kwargs or {}))

    x = _kernel_inputs(20 + which)
    op, args, plain = _op_calls(x)[which]
    with Seen() as seen:
        got = _wrapper_call(which, args)
    assert seen.ops == [op]
    want = plain()
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert torch.equal(g, w)
    with FakeTensorMode() as mode:
        fargs = [mode.from_tensor(a) if isinstance(a, torch.Tensor) else a
                 for a in args]
        with Seen() as seen:
            _wrapper_call(which, fargs)
    assert seen.ops == [op]


def test_kernel_ops_count_no_launch_when_traced():
    """A fake trace passes through the ops' fake implementations: no build,
    no launch counted."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels.centroid_topk import centroid_topk as ct
    from repro_torch.kernels.filtered_scan import filtered_scan as fs

    before = (ct.LAUNCHES, fs.LAUNCHES, fs.PER_PROBE_LAUNCHES)
    with FakeTensorMode():
        q = torch.empty(9, 16, device="cuda")
        c = torch.empty(21, 16, device="cuda")
        vals, ids = ct.centroid_topk(q, c, t=4)
    assert vals.shape == (9, 4) and ids.dtype == torch.int32
    assert (ct.LAUNCHES, fs.LAUNCHES, fs.PER_PROBE_LAUNCHES) == before


# --------------------------------------------- the layouts on two ranks ---
def _local(x, spec, coord):
    from torch.distributed.tensor import Shard

    for i, p in enumerate(spec.placements):
        if isinstance(p, Shard):
            x = torch.chunk(x, spec.mesh_shape[i], dim=p.dim)[coord[i]]
    return x.contiguous()


def _leaf_grads(loss, tree):
    from repro_torch.train.tree import leaves

    xs = [x for x in leaves(tree) if x.requires_grad]
    gs = torch.autograd.grad(loss, xs, allow_unused=True)
    return [torch.zeros_like(x) if g is None else g for x, g in zip(xs, gs)]


def _lm_check(mesh, arch):
    """The LM's loss, gradients and one decode step under the layout
    (FSDP over data, Megatron TP over model, experts over model; the
    decode cache split by sequence) against one device."""
    from repro_torch.launch import layouts, specs
    from repro_torch.models import transformer as tr
    from repro_torch.models.decoding import (
        decode_layout, decode_step, prefill,
    )
    from repro_torch.train.tree import leaves, tree_map

    names = ("data", "model")
    coord = mesh.get_coordinate()
    cfg = specs.LM_ARCHS[arch].smoke_config()
    params = tr.init_params(torch.Generator("cpu").manual_seed(0), cfg,
                            device="cpu")
    g = torch.Generator().manual_seed(1)
    params = tree_map(lambda x: x + 0.02 * torch.randn(x.shape, generator=g)
                      if x.is_floating_point() else x, params)
    abs_ = specs._arg_tree(params, tr.param_pspecs(cfg, names), mesh)
    toks = torch.randint(0, cfg.vocab_size, (2, 16), generator=g)
    labels = torch.randint(0, cfg.vocab_size, (2, 16), generator=g)

    ref = tree_map(lambda x: x.detach().requires_grad_(), params)
    ref_loss, _ = tr.lm_loss(ref, cfg, toks, labels)
    ref_g = _leaf_grads(ref_loss, ref)
    live = tree_map(lambda x, s: _local(x, s, coord).requires_grad_(),
                    params, abs_)
    view = layouts.lm_view(live, abs_, mesh, ("data",))
    loss, _ = tr.lm_loss(view, cfg, toks, labels, mesh=mesh,
                         dp_axes=("data",), tp=tr.TensorParallel(mesh))
    got_g = _leaf_grads(loss, live)
    grad_err = max(
        float((_local(w, s, coord) - got).abs().max()
              / (w.abs().max() + 1e-3))
        for w, got, s in zip(ref_g, got_g, leaves(abs_)))

    dcfg = dataclasses.replace(cfg, fsdp_axis=None)
    dparams = decode_layout(params, dcfg)
    dspecs = tr.param_pspecs(dcfg, names)
    if dcfg.sub_quadratic:
        blk = dspecs.pop("blocks")
        for k in ("blocks_local", "blocks_global", "blocks_tail"):
            if k in dparams:
                dspecs[k] = blk
    dabs = specs._arg_tree(dparams, dspecs, mesh)
    with torch.no_grad():
        _, cache = prefill(params, dcfg, toks[:, :8], 16)
        want, _ = decode_step(dparams, dcfg,
                              tree_map(lambda x: x.clone(), cache),
                              toks[:, 8], 8)
        local_cache = tree_map(lambda x: torch.chunk(
            x, mesh.shape[1], dim=2)[coord[1]].clone(), cache)
        dlocal = tree_map(lambda x, s: _local(x, s, coord), dparams, dabs)
        got, _ = decode_step(
            layouts.lm_view(dlocal, dabs, mesh, ()), dcfg, local_cache,
            toks[:, 8], 8, mesh=mesh, dp_axes=(),
            kv_group=mesh.get_group("model"), tp=tr.TensorParallel(mesh))
    return dict(loss=(float(ref_loss), float(loss.detach())),
                grad_err=grad_err,
                decode_err=float((want - got).abs().max()))


def _lm_train_check(mesh, arch, opt_name):
    """One ``layouts.lm_train_step`` with FSDP over two data ranks (the
    gathers' reduce-scatter backward, ``dp_mean``, ``sync_grads``, the
    sharded clip and optimizer update) against ``train.optimizer``'s
    clip and update on one device, from the same nonzero optimizer state:
    the loss, the gradient norm, and every updated parameter and state
    leaf."""
    from repro_torch.launch import layouts, specs
    from repro_torch.models import transformer as tr
    from repro_torch.train import optimizer as opt
    from repro_torch.train.tree import leaves, tree_map

    names = ("data", "model")
    coord = mesh.get_coordinate()
    # factored_min_dim 16: the smoke widths' matrices take the factored
    # row and column statistics, as the production widths do
    cfg = dataclasses.replace(specs.LM_ARCHS[arch].smoke_config(),
                              fsdp_axis="data")
    ocfg = opt.OptimizerConfig(name=opt_name, weight_decay=0.01,
                               factored_min_dim=16)
    params = tr.init_params(torch.Generator("cpu").manual_seed(0), cfg,
                            device="cpu")
    g = torch.Generator().manual_seed(2)
    params = tree_map(lambda x: x + 0.02 * torch.randn(x.shape, generator=g)
                      if x.is_floating_point() else x, params)
    pspecs = tr.param_pspecs(cfg, names)
    if opt_name == "adafactor":
        state = opt.adafactor_init(params, ocfg)
        ospecs = opt.adafactor_state_pspecs(pspecs, params, ocfg)
    else:
        state = opt.adamw_init(params)
        ospecs = opt.adamw_state_pspecs(pspecs)
    # a later step's state: nonzero statistics and count 3
    state = tree_map(lambda x: 1e-4 * torch.rand(x.shape, generator=g)
                     if x.is_floating_point() else x + 3, state)
    p_abs = specs._arg_tree(params, pspecs, mesh)
    o_abs = specs._arg_tree(state, ospecs, mesh)
    toks = torch.randint(0, cfg.vocab_size, (4, 16), generator=g)
    labels = torch.randint(0, cfg.vocab_size, (4, 16), generator=g)

    # the data-parallel loss (``layouts`` module note): the mean of the
    # ranks' local means, each share's loss here on one device (the MoE
    # routes, drops and balances each rank's tokens alone)
    n_dp = mesh.shape[0]
    ref = tree_map(lambda x: x.detach().requires_grad_(
        x.is_floating_point()), params)
    ref_loss = sum(tr.lm_loss(ref, cfg, t, y)[0] for t, y in zip(
        torch.chunk(toks, n_dp), torch.chunk(labels, n_dp))) / n_dp
    grads = tree_map(lambda x, d: torch.zeros_like(x) if d is None else d,
                     params, _leaf_grads_tree(ref_loss, ref))
    grads, ref_norm = opt.clip_by_global_norm(grads, 1.0)
    lr = torch.tensor(1e-4, dtype=torch.float32)
    update = (opt.adafactor_update if opt_name == "adafactor"
              else opt.adamw_update)
    want_p, want_s = update(grads, state, params, lr, ocfg)

    # copies: the step writes its result into its arguments
    local_p = tree_map(lambda x, s: _local(x, s, coord).clone(), params,
                       p_abs)
    local_s = tree_map(lambda x, s: _local(x, s, coord).clone(), state,
                       o_abs)
    rows = torch.chunk(toks, n_dp)[coord[0]]
    rlab = torch.chunk(labels, n_dp)[coord[0]]
    got_p, got_s, loss, gnorm = layouts.lm_train_step(
        local_p, local_s, rows, rlab, cfg=cfg, opt_cfg=ocfg,
        params_abs=p_abs, opt_abs=o_abs, mesh=mesh, dp=("data",))

    def err(want, got, abs_):
        return max(float((_local(w, s, coord).float() - h.float()).abs().max()
                         / (w.float().abs().max() + 1e-6))
                   for w, h, s in zip(leaves(want), leaves(got),
                                      leaves(abs_)))

    return dict(loss=(float(ref_loss.detach()), float(loss)),
                norm=(float(ref_norm), float(gnorm)),
                param_err=err(want_p, got_p, p_abs),
                state_err=err(want_s, got_s, o_abs),
                moved=float(max((w - p).abs().max() for w, p in zip(
                    leaves(want_p), leaves(params))
                    if w.is_floating_point())))


def _leaf_grads_tree(loss, tree):
    """The gradient of every leaf of ``tree`` (None where it has none)."""
    from repro_torch.train.tree import leaves, unflatten_like

    xs = leaves(tree)
    need = [x for x in xs if x.requires_grad]
    got = iter(torch.autograd.grad(loss, need, allow_unused=True))
    return unflatten_like(tree, [next(got) if x.requires_grad else None
                                 for x in xs])


def _dimenet_check(world):
    """DimeNet with edges and triplets split over the ranks against one
    device: the loss and every gradient."""
    from repro_torch.configs import dimenet
    from repro_torch.models.gnn import GraphBatch, init_params, loss_fn
    from repro_torch.train.tree import leaves, tree_map

    rank = dist.get_rank()
    cfg = dimenet.smoke_config()
    rng = np.random.default_rng(0)
    n, e, t = 24, 32, 64
    t_ = torch.from_numpy
    arrays = dict(
        node_feat=t_(rng.standard_normal((n, cfg.d_feat), dtype=np.float32)),
        positions=t_(rng.standard_normal((n, 3), dtype=np.float32)),
        edge_src=t_(rng.integers(0, n, e).astype(np.int32)),
        edge_dst=t_(rng.integers(0, n, e).astype(np.int32)),
        edge_mask=t_(rng.random(e) < 0.9),
        trip_in=t_(rng.integers(0, e, t).astype(np.int32)),
        trip_out=t_(rng.integers(0, e, t).astype(np.int32)),
        trip_mask=t_(rng.random(t) < 0.9),
        graph_id=t_(np.zeros(n, np.int32)))
    labels = t_(rng.integers(0, cfg.d_out, n).astype(np.int32))
    params = init_params(torch.Generator("cpu").manual_seed(0), cfg,
                         device="cpu")
    ref = tree_map(lambda x: x.detach().requires_grad_(), params)
    ref_loss, _ = loss_fn(ref, cfg, GraphBatch(**arrays), labels)
    ref_g = _leaf_grads(ref_loss, ref)
    split = {k: (torch.chunk(v, world)[rank] if k in (
        "edge_src", "edge_dst", "edge_mask", "trip_in", "trip_out",
        "trip_mask") else v) for k, v in arrays.items()}
    live = tree_map(lambda x: x.detach().requires_grad_(), params)
    loss, _ = loss_fn(live, cfg, GraphBatch(**split), labels,
                      edge_group=dist.group.WORLD)
    got_g = _leaf_grads(loss, live)
    err = max(float((w - g).abs().max() / (w.abs().max() + 1e-6))
              for w, g in zip(ref_g, got_g))
    return dict(loss=(float(ref_loss), float(loss.detach())), grad_err=err)


def _recsys_check(mesh):
    """A recsys train step's loss and gradients with the tables split by
    row over every rank and the batch over data, against one device."""
    from repro_torch.launch import layouts, specs
    from repro_torch.models.recsys import RecsysBatch, init_params, loss_fn
    from repro_torch.train.tree import leaves, tree_map

    cfg = dataclasses.replace(specs.RECSYS_ARCHS["din"].smoke_config(),
                              vocab_items=1000)
    params = init_params(torch.Generator("cpu").manual_seed(0), cfg,
                         device="cpu")
    rng = np.random.default_rng(0)
    b, L = 8, 5
    t_ = torch.from_numpy
    hist = rng.integers(-1, cfg.vocab_items, (b, L)).astype(np.int32)
    batch = RecsysBatch(
        dense=t_(rng.standard_normal((b, cfg.n_dense), dtype=np.float32)),
        sparse=t_(np.zeros((b, 1), np.int32)), hist=t_(hist),
        target=t_(rng.integers(0, cfg.vocab_items, b).astype(np.int32)),
        label=t_((rng.random(b) < 0.5).astype(np.float32)))
    names = tuple(mesh.mesh_dim_names)
    abs_ = specs._arg_tree(params, tree_map(
        lambda x: specs.to_placements(
            (names, None) if x.dim() == 2 and x.shape[0] >= 1000 else (),
            names), params), mesh)
    ref = tree_map(lambda x: x.detach().requires_grad_(), params)
    ref_loss, _ = loss_fn(ref, cfg, batch)
    ref_g = _leaf_grads(ref_loss, ref)
    coord = mesh.get_coordinate()
    dp = ("data",)
    local_batch = RecsysBatch(*(torch.chunk(v, mesh.shape[0])[coord[0]]
                                for v in dataclasses.astuple(batch)))
    live = tree_map(lambda x, s: _local(x, s, coord).requires_grad_(),
                    params, abs_)
    bags = layouts.ShardedBags(live, abs_, mesh, dp)
    loss, _ = loss_fn(live, cfg, local_batch, bag=bags)
    loss = layouts.dp_mean(loss, mesh, dp)
    got = layouts.sync_grads(_leaf_grads(loss, live), leaves(abs_), mesh, dp)
    err = max(float((_local(w, s, coord) - g).abs().max()
                    / (w.abs().max() + 1e-6))
              for w, g, s in zip(ref_g, got, leaves(abs_)))
    return dict(loss=(float(ref_loss), float(loss.detach())), grad_err=err)


def _rank_main(rank, work):
    from repro_torch.launch import mesh as tmesh

    tmesh.init_process_group(rank, 2, init_method=f"file://{work}/store",
                             device="cpu", timeout_s=TIMEOUT_S)
    try:
        tp = tmesh.make_mesh((1, 2), ("data", "model"), device_type="cpu")
        dp = tmesh.make_mesh((2, 1), ("data", "model"), device_type="cpu")
        out = {arch: _lm_check(tp, arch)
               for arch in ("chatglm3-6b", "gemma3-12b", "deepseek-moe-16b",
                            "deepseek-v3-671b")}
        for arch, opt_name in LM_TRAIN_CASES:
            out[f"train/{arch}/{opt_name}"] = _lm_train_check(dp, arch,
                                                              opt_name)
        out["dimenet"] = _dimenet_check(2)
        out["din"] = _recsys_check(dp)
        with open(f"{work}/rank{rank}.json", "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    import torch.multiprocessing as mp

    work = tmp_path_factory.mktemp("layouts")
    ctx = mp.start_processes(_rank_main, args=(str(work),), nprocs=2,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + TIMEOUT_S
    try:
        while not ctx.join(timeout=5):  # re-raises a rank's exception
            if time.monotonic() > deadline:
                raise AssertionError(f"the ranks ran past {TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    return [json.load(open(work / f"rank{r}.json")) for r in range(2)]


@pytest.mark.parametrize("arch", ["chatglm3-6b", "gemma3-12b",
                                  "deepseek-moe-16b", "deepseek-v3-671b"])
def test_lm_layout_matches_one_device(two_ranks, arch):
    """Two model ranks (chatglm3's one KV head of two split inside a head,
    gemma3's qk-norm, the MoE's expert parallelism and vocab-parallel
    loss): the loss within 1e-5, every gradient within 1e-4 of its leaf's
    scale (f32 sums in another order), one decode step's logits over the
    sequence-split cache within 1e-5."""
    for res in two_ranks:
        r = res[arch]
        assert r["loss"][1] == pytest.approx(r["loss"][0], rel=1e-5)
        assert r["grad_err"] < 1e-4
        assert r["decode_err"] < 1e-5


LM_TRAIN_CASES = [(arch, o) for arch in ("chatglm3-6b", "deepseek-moe-16b")
                  for o in ("adamw", "adafactor")]


@pytest.mark.parametrize("arch,opt_name", LM_TRAIN_CASES)
def test_lm_train_step_over_data_ranks_matches_one_device(two_ranks, arch,
                                                          opt_name):
    """``lm_train_step`` on a (data=2, model=1) mesh with FSDP over data:
    the loss and the clipped gradient's norm within 1e-5, every updated
    parameter and optimizer-state leaf within 1e-5 of its leaf's scale
    (f32 sums in another order) of one device's step, which moved the
    parameters."""
    for res in two_ranks:
        r = res[f"train/{arch}/{opt_name}"]
        assert r["loss"][1] == pytest.approx(r["loss"][0], rel=1e-5)
        assert r["norm"][1] == pytest.approx(r["norm"][0], rel=1e-5)
        assert r["param_err"] < 1e-5
        assert r["state_err"] < 1e-5
        assert r["moved"] > 1e-6


@pytest.mark.parametrize("family", ["dimenet", "din"])
def test_gnn_and_recsys_layouts_match_one_device(two_ranks, family):
    """DimeNet's edge split and the row-split recsys tables: the loss
    within 1e-5 and every gradient within 1e-4 of its leaf's scale."""
    for res in two_ranks:
        r = res[family]
        assert r["loss"][1] == pytest.approx(r["loss"][0], rel=1e-5)
        assert r["grad_err"] < 1e-4
