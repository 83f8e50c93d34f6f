"""BENCHMARK.json keeps its schema (names, units, bounds, cells and the
metrics each reports), and a run's last line has the result's keys in
their form."""
import math
import re

from port_bench import harness
from port_bench.tests.helpers import run_cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_benchmark_json_keeps_its_schema():
    spec = harness.load_json(harness.BENCH_DIR.parent / "BENCHMARK.json")
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert spec["paths"] == ["port_bench"] and 1 <= spec["run_seconds"] <= 51
    # a full check with 24 cells fits: 2 + 14 x cells runs, each run_seconds + 60, 180 s a cell, 1200 spare
    assert (2 + 14 * 24) * (spec["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    configs = {c["name"]: c for c in spec["configs"]}
    cells = {w["name"]: w for w in spec["workloads"]}
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= set(cells)
    for m in spec["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in spec["per_layer"]:
        assert m["moves"] in e2e and "workloads" in m and len(m["layer"]) <= 200
        assert all(w in e2e[m["moves"]].get("workloads", [w]) for w in m["workloads"])
    for c in configs.values():
        assert c["file"].startswith("port_bench/") and harness.load_json(harness.BENCH_DIR.parent / c["file"])
        assert any(w["config"] == c["name"] for w in cells.values())
    pairs = {(w["config"], w["traffic"]) for w in cells.values()}
    assert len(pairs) == len(cells)
    for name, w in cells.items():
        assert NAME.match(name) and w["chips"] == 1 and len(w["why"]) <= 200
        reported = [m for m in spec["end_to_end"] if name in m.get("workloads", [name])]
        assert "setup_s" in [m["name"] for m in reported] and len(reported) >= 2
        assert any(name in m["workloads"] for m in spec["per_layer"])


def test_last_line_has_the_result_keys(tiny_bench):
    rc, res, lines, err = run_cell(tiny_bench, "tiny_bulk")
    assert rc == 0, err
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-1] == "checks"
    assert res["correct"] is True and res["attempted"] >= 2 and res["failed"] == 0
    assert set(res["metrics"]) == {"inpaints_per_hour", "setup_s"}
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and math.isfinite(m["value"]) and m["value"] > 0
    assert set(res["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(res["checks"]) == {"camera_rel_l2", "lidar_rel_l2"}
    assert all(set(c) == {"value", "limit"} for c in res["checks"].values())
    assert [ln["line"] for ln in lines] == ["window", "check_sample"]
    # the compared numbers beside their limits close standard error
    assert err.strip().splitlines()[-2:][0].startswith("check camera_rel_l2")


def test_no_card_no_result(tiny_bench, monkeypatch, capsys):
    import torch

    from port_bench import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "flagship_ddim50_b8", "--seed", "1", "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""
