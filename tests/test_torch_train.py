"""The port's training substrate against the reference on the same numpy
inputs: optimizer steps, the schedule, clipping, the state shardings,
checkpoints (each package restores the other's), the ``Trainer`` (the
two-tower example's model with carried parameters, bit-for-bit restart,
preemption, the divergence guard) and the feeder.

Tolerances: optimizer steps rtol 1e-6, atol 1e-7; the schedule rtol 1e-6;
the trainer's per-step loss rtol 1e-4; checkpoints and restarts bit for
bit.
"""

import importlib.util
import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.data import ShardedFeeder as JFeeder
from repro.train import checkpoint as jckpt
from repro.train import optimizer as jopt
from repro.train.train_loop import Trainer as JTrainer
from repro.train.train_loop import TrainLoopConfig as JConfig
from repro_torch.data import ShardedFeeder
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import optimizer as topt
from repro_torch.train.train_loop import Trainer, TrainLoopConfig
from repro_torch.train.tree import leaves_with_paths

ROOT = Path(__file__).resolve().parent.parent
STEP = dict(rtol=1e-6, atol=1e-7)


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


J_EMB = _load(ROOT / "examples" / "train_embedder.py", "ref_train_embedder")
T_EMB = _load(ROOT / "examples" / "torch" / "train_embedder.py",
              "port_train_embedder")


def _flat(tree) -> dict:
    """``{path: numpy}`` of a reference (jax) or port (torch) tree."""
    if any(isinstance(x, jax.Array) for x in jax.tree.leaves(tree)):
        tree = jax.tree.map(np.asarray, tree)
    return {"/".join(p): (x.detach().numpy() if isinstance(x, torch.Tensor)
                          else np.asarray(x))
            for p, x in leaves_with_paths(tree)}


def _assert_trees_close(got, want, exact=False, **tol):
    g, w = _flat(got), _flat(want)
    assert sorted(g) == sorted(w)
    for key in g:
        if exact:
            assert g[key].dtype == w[key].dtype, key
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)
        else:
            np.testing.assert_allclose(g[key], w[key], err_msg=key, **tol)


def _params_grads(seed=0):
    """A nested tree: factored 2-D and 3-D leaves (at factored_min_dim 8),
    a 2-D leaf below it and 1-D leaves (full second moments)."""
    rng = np.random.default_rng(seed)

    def f(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    params = {"w": f(16, 12), "x": f(12), "blocks": [
        {"k": f(3, 9, 10), "small": f(4, 5)}, {"b": f(7)}]}
    grads = jax.tree.map(lambda p: f(*p.shape), params)
    return params, grads


def _torch(tree):
    return tckpt.params_from_numpy(tree, "cpu")


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_steps_match_reference(name):
    """Three steps from the same params and grads: parameters and state
    leaf by leaf (AdamW's m/v; Adafactor's factored row/col stats and the
    full v of the other leaves)."""
    params, grads = _params_grads()
    cfg_kw = dict(name=name, weight_decay=0.01, factored_min_dim=8)
    jinit, jupd = jopt.make_optimizer(jopt.OptimizerConfig(**cfg_kw))
    tinit, tupd = topt.make_optimizer(topt.OptimizerConfig(**cfg_kw))
    jp, tp = jax.tree.map(jnp.asarray, params), _torch(params)
    js, ts = jinit(jp), tinit(tp)
    if name == "adafactor":
        assert tuple(ts.v_row["w"].shape) == (16,)
        assert tuple(ts.v_col["blocks"][0]["k"].shape) == (3, 10)
        assert tuple(ts.v_row["blocks"][0]["small"].shape) == (4, 5)
    for i, lr in enumerate((0.01, 0.05, 0.002)):
        g = jax.tree.map(lambda x: x * (1 + i), grads)
        jp, js = jupd(jax.tree.map(jnp.asarray, g), js, jp, jnp.float32(lr))
        tp, ts = tupd(_torch(g), ts, tp, torch.tensor(lr))
        _assert_trees_close(tp, jp, **STEP)
        _assert_trees_close(ts, js, **STEP)
    assert int(ts.count) == 3 and ts.count.dtype == torch.int32


def test_cosine_schedule_matches_reference_at_every_step():
    """rtol 1e-6, plus one f32 ulp of the cosine term (base · 2^-24) as
    atol: near the end ``1 + cos(pi·t)`` cancels, and the two libraries'
    ``cos`` may differ in the last bit."""
    for base, warm, total in ((3e-4, 10, 110), (1.0, 0, 37), (3e-3, 20, 300)):
        jlr = jopt.cosine_schedule(base, warm, total)
        tlr = topt.cosine_schedule(base, warm, total)
        steps = np.arange(total + 1, dtype=np.int32)
        want = np.asarray(jax.vmap(jlr)(jnp.asarray(steps)))
        got = tlr(torch.from_numpy(steps)).numpy()
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=base * 2.0**-24)


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches_reference(max_norm):
    _, grads = _params_grads(1)
    jc, jg = jopt.clip_by_global_norm(jax.tree.map(jnp.asarray, grads),
                                      max_norm)
    tc, tg = topt.clip_by_global_norm(_torch(grads), max_norm)
    np.testing.assert_allclose(float(tg), float(jg), rtol=1e-6)
    _assert_trees_close(tc, jc, **STEP)


def _spec_leaves(tree):
    """Placement tuples (port) or PartitionSpecs (reference), by path."""
    out = {}

    def walk(x, path):
        if isinstance(x, P) or (isinstance(x, tuple) and not hasattr(
                x, "_fields") and all(isinstance(
                    p, (topt.Shard, topt.Replicate)) for p in x)):
            out["/".join(path)] = x
        elif isinstance(x, dict):
            for k in x:
                walk(x[k], path + (str(k),))
        elif hasattr(x, "_fields"):
            for f in x._fields:
                walk(getattr(x, f), path + (f,))
        else:
            for i, v in enumerate(x):
                walk(v, path + (str(i),))

    walk(tree, ())
    return out


def test_state_pspecs_match_reference_structure():
    axes = ("data", "model")
    jspecs = {"emb": P("model", None), "proj": P(None, "model"),
              "experts": P("data", None, "model"), "b": P(None),
              "both": P(("data", "model"), None), "tiny": P("model", None)}
    shapes = {"emb": (1024, 256), "proj": (256, 256),
              "experts": (8, 256, 512), "b": (256,), "both": (512, 128),
              "tiny": (64, 16)}
    tspecs = {k: topt.to_placements(v, axes) for k, v in jspecs.items()}
    assert tspecs["experts"] == (topt.Shard(0), topt.Shard(2))
    assert tspecs["both"] == (topt.Shard(0), topt.Shard(0))
    cfg = topt.OptimizerConfig(name="adafactor")
    jshape = {k: jax.ShapeDtypeStruct(v, jnp.float32)
              for k, v in shapes.items()}
    for jstate, tstate in (
            (jopt.adamw_state_pspecs(jspecs), topt.adamw_state_pspecs(tspecs)),
            (jopt.adafactor_state_pspecs(jspecs, jshape,
                                         jopt.OptimizerConfig(
                                             name="adafactor")),
             topt.adafactor_state_pspecs(tspecs, shapes, cfg))):
        assert type(tstate).__name__ == type(jstate).__name__
        want = {k: topt.to_placements(v, axes)
                for k, v in _spec_leaves(jstate).items()}
        assert _spec_leaves(tstate) == want


# ---- checkpoints ----

def _states(seed=2):
    params, grads = _params_grads(seed)
    jp = jax.tree.map(jnp.asarray, params)
    js = jopt.adamw_init(jp)
    jp, js = jopt.adamw_update(jax.tree.map(jnp.asarray, grads), js, jp,
                               jnp.float32(0.1), jopt.OptimizerConfig())
    jstate = {"params": jp, "opt": js}
    tstate = {"params": _torch(jax.tree.map(np.asarray, jp)),
              "opt": topt.AdamWState(
                  *_torch(list(jax.tree.map(np.asarray, tuple(js)))))}
    return jstate, tstate


def test_checkpoint_keys_are_the_reference_keys(tmp_path):
    jstate, tstate = _states()
    jckpt.save_checkpoint(str(tmp_path / "ref"), 3, jstate)
    tckpt.save_checkpoint(str(tmp_path / "port"), 3, tstate)
    with np.load(tmp_path / "ref" / "step_3" / "arrays.npz") as a, \
            np.load(tmp_path / "port" / "step_3" / "arrays.npz") as b:
        assert b.files == a.files
        assert "opt/m/blocks/0/k" in b.files and "opt/count" in b.files
        for key in a.files:
            assert b[key].dtype == a[key].dtype, key
            assert b[key].tobytes() == a[key].tobytes(), key
    for d in ("ref", "port"):
        man = json.loads((tmp_path / d / "step_3" / "manifest.json")
                         .read_text())
        assert man == {"step": 3, "n_arrays": len(a.files), "extra": {}}


def test_each_package_restores_the_others_checkpoint(tmp_path):
    jstate, tstate = _states(3)
    jckpt.save_checkpoint(str(tmp_path / "ref"), 5, jstate,
                          extra={"lr_scale": 0.5})
    step, got, extra = tckpt.restore_checkpoint(str(tmp_path / "ref"),
                                                tstate)
    assert (step, extra) == (5, {"lr_scale": 0.5})
    assert isinstance(got["opt"], topt.AdamWState)
    _assert_trees_close(got, jstate, exact=True)
    placed = tckpt.params_from_numpy(got, "cpu")
    assert placed["opt"].count.dtype == torch.int32

    tckpt.save_checkpoint(str(tmp_path / "port"), 6, tstate)
    step, back, _ = jckpt.restore_checkpoint(str(tmp_path / "port"), jstate)
    assert step == 6
    _assert_trees_close(tstate, back, exact=True)


def test_checkpoint_prunes_to_keep_and_skips_incomplete(tmp_path):
    state = {"a": torch.zeros(2)}
    for s in (1, 2, 3, 4, 5):
        tckpt.save_checkpoint(str(tmp_path), s, state, keep=2)
    assert tckpt.all_steps(str(tmp_path)) == [4, 5]
    os.makedirs(tmp_path / "step_9")  # no manifest: not a checkpoint
    assert tckpt.latest_step(str(tmp_path)) == 5
    assert tckpt.restore_checkpoint(str(tmp_path / "none"), state) is None
    with pytest.raises(ValueError, match="mismatch"):
        tckpt.restore_checkpoint(str(tmp_path), {"b": torch.zeros(2)})


# ---- the trainer ----

def _tower_params():
    """The reference example's initial parameters, and the port's copy."""
    jp = {"a": J_EMB.init_tower(jax.random.key(0), 48),
          "b": J_EMB.init_tower(jax.random.key(1), 48)}
    return jp, _torch(jax.tree.map(np.asarray, jp))


def _gen(batch=64):
    return lambda s, i: T_EMB.gen(s, i, batch=batch)


def test_example_batches_are_the_references():
    for step in (0, 7):
        a, b = T_EMB.gen(0, step), J_EMB.gen(0, step)
        for key in ("x", "y"):
            assert a[key].tobytes() == b[key].tobytes()


def test_trainer_losses_match_reference_two_tower():
    """The two-tower example's model through both Trainers from the same
    parameters and batches: each step's loss within rtol 1e-4."""
    jp, tp = _tower_params()
    kw = dict(total_steps=10, ckpt_every=100, log_every=100, lr=3e-3,
              warmup=2)
    jt = JTrainer(J_EMB.loss_fn, jp, JConfig(**kw))
    tt = Trainer(T_EMB.loss_fn, tp, TrainLoopConfig(**kw), device="cpu")
    feeds = [JFeeder(_gen(), seed=0), ShardedFeeder(_gen(), seed=0)]
    try:
        jh = jt.run(feeds[0])
        th = tt.run(feeds[1])
    finally:
        for f in feeds:
            f.close()
    assert th["step"] == jh["step"] == list(range(1, 11))
    np.testing.assert_allclose(th["loss"], jh["loss"], rtol=1e-4)
    assert th["loss"][-1] < th["loss"][0]
    _assert_trees_close(tt.params, jt.params, rtol=1e-3, atol=1e-5)


def _run(trainer, max_steps=None, batch=64):
    feeder = ShardedFeeder(_gen(batch), seed=0)
    try:
        return trainer.run(feeder, max_steps=max_steps)
    finally:
        feeder.close()


def test_trainer_restart_continues_bit_for_bit(tmp_path):
    """6 steps straight against 3 steps, a checkpoint, a fresh Trainer
    from the initial parameters and 3 more: identical parameters and
    optimizer state."""
    _, tp = _tower_params()

    def cfg(d):
        return TrainLoopConfig(total_steps=6, ckpt_every=3,
                               ckpt_dir=str(tmp_path / d), log_every=100,
                               lr=3e-3, warmup=2)

    straight = Trainer(T_EMB.loss_fn, tp, cfg("a"), device="cpu")
    h = _run(straight)
    first = Trainer(T_EMB.loss_fn, tp, cfg("b"), device="cpu")
    h1 = _run(first, max_steps=3)
    assert first.step == 3 and tckpt.latest_step(str(tmp_path / "b")) == 3
    second = Trainer(T_EMB.loss_fn, tp, cfg("b"), device="cpu")
    h2 = _run(second)
    assert second.step == 6 and h2["step"] == [4, 5, 6]
    assert h1["loss"] + h2["loss"] == h["loss"]
    _assert_trees_close(second.params, straight.params, exact=True)
    _assert_trees_close(second.opt_state, straight.opt_state, exact=True)


def test_request_stop_finishes_the_step_and_checkpoints(tmp_path):
    _, tp = _tower_params()
    trainer = Trainer(T_EMB.loss_fn, tp, TrainLoopConfig(
        total_steps=50, ckpt_every=100, ckpt_dir=str(tmp_path),
        log_every=100), device="cpu")
    feeder = ShardedFeeder(_gen(16), seed=0)

    class Preempt:
        def __next__(self):
            item = next(feeder)
            if item[0] == 1:  # SIGTERM arrives during step 2
                trainer.request_stop()
            return item

    try:
        hist = trainer.run(Preempt())
    finally:
        feeder.close()
    assert trainer.step == 2 and hist["step"] == [1, 2]
    assert tckpt.latest_step(str(tmp_path)) == 2


def _poisoned(bad_step, batch=64):
    """The example's batches with a NaN in data step ``bad_step`` (a NaN
    loss in both packages: the reference's loss runs inside ``jax.jit``,
    so it is poisoned through its data)."""
    def generator(seed, step):
        out = T_EMB.gen(seed, step, batch=batch)
        if step == bad_step:
            out["x"][0, 0] = np.nan
        return out
    return generator


def test_divergence_guard_restores_and_decays_lr(tmp_path):
    """A NaN loss at the 5th step: both packages restore step 4, halve the
    LR scale and go on to the end with the same steps and losses."""
    jp, tp = _tower_params()
    kw = dict(total_steps=7, ckpt_every=2, log_every=100, lr=3e-3, warmup=2)
    jt = JTrainer(J_EMB.loss_fn, jp,
                  JConfig(ckpt_dir=str(tmp_path / "ref"), **kw))
    tt = Trainer(T_EMB.loss_fn, tp,
                 TrainLoopConfig(ckpt_dir=str(tmp_path / "port"), **kw),
                 device="cpu")
    hists = []
    for trainer, feeder_cls in ((jt, JFeeder), (tt, ShardedFeeder)):
        feeder = feeder_cls(_poisoned(4), seed=0)
        try:
            hists.append(trainer.run(feeder))
        finally:
            feeder.close()
    jh, th = hists
    assert th["step"] == jh["step"] == list(range(1, 8))
    assert tt._lr_scale == jt._lr_scale == 0.5
    assert all(np.isfinite(th["loss"]))
    np.testing.assert_allclose(th["loss"], jh["loss"], rtol=1e-4)
    _, _, extra = tckpt.restore_checkpoint(
        str(tmp_path / "port"), {"params": tt.params, "opt": tt.opt_state})
    assert extra == {"lr_scale": 0.5}

    fresh = Trainer(T_EMB.loss_fn, tp, TrainLoopConfig(**kw), device="cpu")
    feeder = ShardedFeeder(_poisoned(0), seed=0)
    try:
        with pytest.raises(FloatingPointError, match="no checkpoint"):
            fresh.run(feeder)
    finally:
        feeder.close()


def test_trainer_needs_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tp = _tower_params()
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(T_EMB.loss_fn, tp, TrainLoopConfig())


# ---- the feeder ----

def test_feeder_order_start_step_and_close():
    calls = []

    def generator(seed, step):
        calls.append(step)
        return {"x": np.full(3, seed * 100 + step)}

    feeder = ShardedFeeder(generator, seed=4, start_step=7, prefetch=2)
    got = [next(feeder) for _ in range(5)]
    assert [s for s, _ in got] == [7, 8, 9, 10, 11]
    assert [int(b["x"][0]) for _, b in got] == [407, 408, 409, 410, 411]
    feeder.close()
    feeder._thread.join(timeout=5)
    assert not feeder._thread.is_alive()
    assert calls == sorted(calls) and calls[0] == 7


# ---- bfloat16 state (the LM configs' dtype) ----

def _bf16_params():
    rng = np.random.default_rng(11)
    return {"w": torch.from_numpy(rng.standard_normal((12, 6)).astype(
                np.float32)).to(torch.bfloat16),
            "b": torch.zeros(6, dtype=torch.bfloat16),
            "scale": torch.ones(3)}


def _bf16_loss(p, batch):
    y = batch["x"].to(torch.bfloat16) @ p["w"] + p["b"]
    loss = torch.mean(torch.square(y.float() - 0.5)) + torch.sum(
        torch.square(p["scale"] - 2.0))
    return loss, {}


def _bf16_gen(seed, step):
    rng = np.random.default_rng((seed, step))
    return {"x": rng.standard_normal((16, 12)).astype(np.float32)}


def test_bf16_trainer_state_restarts_bit_for_bit(tmp_path):
    """A bf16 state checkpoints (as the reference's ``V2`` words), restores
    as bf16, and 2 + checkpoint + 2 steps equal 4 straight bit for bit."""
    def cfg(d):
        return TrainLoopConfig(total_steps=4, ckpt_every=2,
                               ckpt_dir=str(tmp_path / d), log_every=100,
                               lr=3e-2, warmup=1)

    def run(trainer, max_steps=None):
        feeder = ShardedFeeder(_bf16_gen, seed=0)
        try:
            return trainer.run(feeder, max_steps=max_steps)
        finally:
            feeder.close()

    straight = Trainer(_bf16_loss, _bf16_params(), cfg("a"), device="cpu")
    h = run(straight)
    first = Trainer(_bf16_loss, _bf16_params(), cfg("b"), device="cpu")
    h1 = run(first, max_steps=2)
    with np.load(tmp_path / "b" / "step_2" / "arrays.npz") as data:
        assert data["params/w"].dtype == np.dtype("V2")
        assert data["opt/m/w"].dtype == np.float32
    second = Trainer(_bf16_loss, _bf16_params(), cfg("b"), device="cpu")
    h2 = run(second)
    assert second.step == 4 and h1["loss"] + h2["loss"] == h["loss"]
    assert second.params["w"].dtype == torch.bfloat16
    want = dict(leaves_with_paths({"p": straight.params,
                                   "o": straight.opt_state}))
    for path, got in leaves_with_paths({"p": second.params,
                                        "o": second.opt_state}):
        assert got.dtype == want[path].dtype, path
        assert torch.equal(got, want[path]), path


def test_bf16_checkpoints_cross_between_the_packages(tmp_path):
    """The reference's bf16 leaves (``ml_dtypes.bfloat16``) carry across
    through ``params_from_numpy``; the port's npz members are the
    reference's byte for byte; the port restores the reference's bf16
    checkpoint.  The reference cannot restore its own bf16 checkpoint
    (numpy has no cast from ``V2`` to ``bfloat16``): recorded here as a
    fact of the reference, not repaired."""
    import zipfile

    jstate = {"w": jnp.asarray(np.linspace(-3, 3, 24, dtype=np.float32)
                               .reshape(4, 6), dtype=jnp.bfloat16),
              "n": jnp.arange(3, dtype=jnp.int32),
              "f": jnp.ones(2, jnp.float32)}
    host = jax.tree.map(np.asarray, jstate)
    tstate = tckpt.params_from_numpy(host, "cpu")
    assert tstate["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tstate["w"].float().numpy(),
                                  host["w"].astype(np.float32))
    jckpt.save_checkpoint(str(tmp_path / "ref"), 1, jstate)
    tckpt.save_checkpoint(str(tmp_path / "port"), 1, tstate)
    with zipfile.ZipFile(tmp_path / "ref" / "step_1" / "arrays.npz") as a, \
            zipfile.ZipFile(tmp_path / "port" / "step_1" / "arrays.npz") as b:
        assert b.namelist() == a.namelist()
        for name in a.namelist():
            assert b.read(name) == a.read(name), name
    step, got, _ = tckpt.restore_checkpoint(str(tmp_path / "ref"), tstate)
    assert step == 1 and got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"], tstate["w"])
    assert torch.equal(tckpt.params_from_numpy(got, "cpu")["w"], tstate["w"])
    np.testing.assert_array_equal(got["n"], host["n"])
    # restoring into the reference's own numpy leaves gives bf16 tensors too
    _, got_np, _ = tckpt.restore_checkpoint(str(tmp_path / "ref"), host)
    assert torch.equal(got_np["w"], tstate["w"])
    with pytest.raises(ValueError, match="cast"):
        jckpt.restore_checkpoint(str(tmp_path / "ref"), jstate)
