"""The comparison separates the program from its control and its faults.

The control is the reference one precision below the configuration's
(fp8 for bf16 rows, int4 for SQ8 rows) put in the program's place; each
fault breaks the timed path underneath a whole run on the CPU.  Every one
must come out not correct under the cell's own limits, and the program
itself correct.
"""

import pytest
import torch

import repro_torch.core.engine as engine_mod
from bench import judge, spec
from bench.tests import tiny


@pytest.mark.parametrize("store", ["bf16", "sq8"])
def test_control_fails_and_program_passes(store):
    run, r = tiny.run(tiny.config(store), tiny.traffic(k=10), control=True)
    lim = tiny.limits(store)
    assert judge.correct(r["program"], lim), r["program"]
    assert not judge.correct(r["control"], lim), r["control"]
    assert r["control"]["score_err"] > 10 * lim["score_err"]


def test_control_fails_and_program_passes_under_a_filter():
    run, r = tiny.run(tiny.config(), tiny.traffic(k=100, terms=True),
                      control=True)
    lim = spec.limits("clip768-bf16-10m.filtered-k100")
    assert judge.correct(r["program"], lim), r["program"]
    assert not judge.correct(r["control"], lim), r["control"]


def _broken_scan(alter):
    real = engine_mod.filtered_scan_tiled

    def scan(*args, **kw):
        vals, ids, npass = real(*args, **kw)
        return alter(vals.clone(), ids.clone(), npass.clone(), kw["q_block"])
    return scan


def _altered_answer(vals, ids, npass, qb):
    """One id changed where the kernel produces it."""
    ids[0, 0, 0] = ids[0, 0, 0] + 1
    return vals, ids, npass


def _half_batch_left_out(vals, ids, npass, qb):
    """The second half of every query tile is never scanned."""
    vals[:, qb // 2:] = float("-inf")
    ids[:, qb // 2:] = -1
    npass[:, qb // 2:] = 0
    return vals, ids, npass


def _scores_rounded(vals, ids, npass, qb):
    """Scores rounded to bf16 where the kernel writes them."""
    return vals.bfloat16().float(), ids, npass


@pytest.mark.parametrize("fault", [_altered_answer, _half_batch_left_out,
                                   _scores_rounded])
def test_faults_come_out_not_correct(fault, monkeypatch):
    monkeypatch.setattr(engine_mod, "filtered_scan_tiled", _broken_scan(fault))
    _, r = tiny.run(tiny.config(), tiny.traffic(k=10))
    assert not judge.correct(r, tiny.limits()), r


def test_a_plan_that_probes_elsewhere_is_caught(monkeypatch):
    real = engine_mod.plan_fused_tiled

    def plan(centroids, *args, **kw):  # probes the farthest centres
        return real(-centroids, *args, **kw)
    monkeypatch.setattr(engine_mod, "plan_fused_tiled", plan)
    _, r = tiny.run(tiny.config(), tiny.traffic(k=10))
    assert r["bad_ids"] > 0 and not judge.correct(r, tiny.limits())


def _filter_ignored(scan):
    """The scan's filter bounds widened to the whole range: every row of a
    probed cluster passes."""
    def wide(sc, st, nu, q, lo, hi, *args, **kw):
        return scan(sc, st, nu, q, torch.full_like(lo, -32768),
                    torch.full_like(hi, 32767), *args, **kw)
    return wide


@pytest.mark.parametrize("fault", [_altered_answer, _half_batch_left_out,
                                   _scores_rounded, None])
def test_faults_under_a_filter_come_out_not_correct(fault, monkeypatch):
    real = engine_mod.filtered_scan_tiled
    scan = _filter_ignored(real) if fault is None else _broken_scan(fault)
    monkeypatch.setattr(engine_mod, "filtered_scan_tiled", scan)
    _, r = tiny.run(tiny.config(), tiny.traffic(k=100, terms=True))
    lim = spec.limits("clip768-bf16-10m.filtered-k100")
    assert not judge.correct(r, lim), r
    if fault is None:
        assert r["bad_ids"] > 0 and r["count_err"] > 0
