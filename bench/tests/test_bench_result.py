"""The result line's keys, and BENCHMARK.json against its contract."""

import json
import re

import pytest

from bench import run as bench_run
from bench import spec
from bench.tests import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = spec.benchmark()
DEVICE = {"platform": "gpu", "kind": "test", "count": 1}


@pytest.mark.parametrize("traced", [False, True])
def test_last_line_keys(traced):
    cell = spec.cell(BENCH, "clip768-bf16-10m.uniform-k100")
    run, readings = tiny.run(tiny.config(), tiny.traffic(k=100),
                             traced=traced)
    out = bench_run.result_line(cell, BENCH, run, readings,
                                spec.limits(cell["name"]), traced, DEVICE)
    json.loads(json.dumps(out))
    keys = list(out)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "checks"
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] == run.queries > 0
    dev = out["device"]
    assert set(DEVICE) <= set(dev) and "memory_peak_bytes" in dev
    want = {m["name"]: m["unit"] for m in spec.metrics(BENCH, cell["name"],
                                                       traced)}
    got = {n: v["unit"] for n, v in out["metrics"].items()}
    if traced:
        # no device on the CPU: the profiler-based readers return nothing
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        assert got == {n: u for n, u in want.items()
                       if n not in ("tiled_scan_roofline_pct",
                                    "device_idle_pct")}
    else:
        # nor is memory measured there
        assert got == {n: u for n, u in want.items() if n != "serve_peak_gib"}
    assert set(out["checks"]) == set(spec.limits(cell["name"]))


def test_benchmark_json_keeps_its_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]]
    for c in BENCH["configs"]:
        assert NAME.match(c["name"]) and c["file"].startswith("bench/")
        cfg = spec.config(BENCH, c["name"])
        assert all(NAME.match(k) and k in cfg for k in c["reduced"])
    cells = set()
    for w in BENCH["workloads"]:
        assert NAME.match(w["name"]) and w["config"] in names
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in cells
        cells.add((w["config"], w["traffic"]))
        spec.traffic(w["traffic"])
        assert set(spec.limits(w["name"])) == {
            "bad_ids", "count_err", "order_gap", "score_err", "kth_gap"}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert callable(spec.reader(m["name"]))
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", [])) <= {w["name"] for w in
                                               BENCH["workloads"]}


def test_no_card_no_result(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: this holds the no-card exit")
    assert bench_run.main(["--workload", "clip768-bf16-10m.uniform-k100",
                           "--seed", "1", "--seconds", "1"]) == 1
    assert capsys.readouterr().out == ""
