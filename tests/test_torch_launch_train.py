"""The port's training launcher (``repro_torch.launch.train``) against the
reference's runners: each of the ten archs for 3 steps on the CPU from the
reference's initial parameters (drawn as its runner draws them and carried
across), every step's loss within rtol 1e-4 of the reference's; unknown
archs exit as the reference's; the launcher needs CUDA unless the CPU is
asked for.
"""

import argparse
import sys

import jax
import numpy as np
import pytest
import torch

from repro.launch import train as jtrain
from repro_torch.launch import train as ttrain

ARCHS = sorted(ttrain.LM_ARCHS) + ["dimenet"] + sorted(ttrain.RECSYS_ARCHS)
STEPS, BATCH, SEQ = 3, 4, 16


def _args(arch, device=None):
    ns = argparse.Namespace(arch=arch, steps=STEPS, batch=BATCH, seq=SEQ,
                            lr=1e-3, seed=0, ckpt_dir=None, ckpt_every=1000,
                            smoke=True)
    if device is not None:
        ns.device = device
    return ns


def _reference_init(arch):
    """The reference runner's own initial parameters, as numpy."""
    from repro.launch.specs import LM_ARCHS, RECSYS_ARCHS

    key = jax.random.key(0)
    if arch in LM_ARCHS:
        from repro.models.transformer import init_params
        cfg = LM_ARCHS[arch].smoke_config()
    elif arch == "dimenet":
        from repro.configs import dimenet
        from repro.models.gnn import init_params
        cfg = dimenet.smoke_config()
    else:
        from repro.models.recsys import init_params
        cfg = RECSYS_ARCHS[arch].smoke_config()
    params = jax.jit(init_params, static_argnums=1)(key, cfg)
    return jax.tree.map(np.asarray, params)


def test_arch_table_is_the_references():
    from repro.launch.specs import LM_ARCHS, RECSYS_ARCHS

    assert sorted(ttrain.LM_ARCHS) == sorted(LM_ARCHS)
    assert sorted(ttrain.RECSYS_ARCHS) == sorted(RECSYS_ARCHS)
    assert len(ARCHS) == 10


@pytest.mark.parametrize("arch", ARCHS)
def test_runner_losses_match_reference(arch, capsys):
    runner = ("lm_runner" if arch in ttrain.LM_ARCHS else "gnn_runner"
              if arch == "dimenet" else "recsys_runner")
    host = _reference_init(arch)
    want = getattr(jtrain, runner)(arch, _args(arch))
    got = getattr(ttrain, runner)(arch, _args(arch, "cpu"), params=host)
    assert got["step"] == want["step"] == [1, 2, 3]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4,
                               err_msg=arch)
    assert all(np.isfinite(got["loss"]))


def test_main_prints_the_references_line(capsys):
    host = _reference_init("din")
    hist = ttrain.main(["--arch", "din", "--steps", "2", "--batch", "4",
                        "--device", "cpu"], params=host)
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-1] == (f"final loss {hist['loss'][-1]:.4f} after 2 steps")


def test_unknown_arch_exits_as_the_reference(monkeypatch):
    monkeypatch.setattr(sys, "argv", ["train", "--arch", "nope"])
    with pytest.raises(SystemExit) as want:
        jtrain.main()
    with pytest.raises(SystemExit) as got:
        ttrain.main(["--arch", "nope", "--device", "cpu"])
    assert str(got.value) == str(want.value) == "unknown arch nope"


def test_launcher_needs_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrain.main(["--arch", "din", "--steps", "1"])
