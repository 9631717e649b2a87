"""BENCHMARK.json against the benchmark's contract, and every configuration,
traffic mix, entry and metric reader it names found by name."""

import json
import re

import pytest

from zkbench import harness

BENCH = harness.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [c["name"] for c in BENCH["workloads"]]


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["zkbench"] and BENCH["command"][1].startswith("zkbench/")
    assert 1 <= BENCH["run_seconds"] <= 51
    assert 2 + 14 * 24 * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(BENCH)) < 64 * 1024
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in BENCH[group]]
        assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)


def test_metrics_follow_the_contract():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_finds_its_parts(cell):
    c, config, traffic = harness.cell_parts(BENCH, cell)
    assert c["chips"] == 1 and len(c["why"]) <= 200
    assert hasattr(harness.entry_class(traffic), "prove")
    assert {"pool", "check", "trace_proofs", "entry"} <= set(traffic)
    assert config["reduced"] == next(x for x in BENCH["configs"] if x["name"] == c["config"])["reduced"]
    e2e = harness.metrics_for(BENCH, cell, trace=False)
    layers = harness.metrics_for(BENCH, cell, trace=True)
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2 and layers
    for m in e2e + layers:
        assert callable(harness.reader(m["name"]).read)


def test_per_layer_metrics_by_cell():
    names = {cell: {m["name"] for m in harness.metrics_for(BENCH, cell, trace=True)} for cell in CELLS}
    assert "msm_device_ms_per_proof" in names["succinct_gkr.bn254_d24"]
    assert "msm_device_ms_per_proof" not in names["gkr.bn254_d24_public"] | names["fri.bn254_2p18"]
    assert "gkr_layers_ms_per_proof" not in names["fri.bn254_2p18"]
    assert {"device_idle_pct", "launches_per_proof", "host_syncs_per_proof"} <= set.intersection(*names.values())
    assert {m["name"] for m in harness.metrics_for(BENCH, "fri.bn254_2p18", trace=False)} >= {"prove_p95_ms"}


def test_unknown_workload_is_refused():
    with pytest.raises(KeyError):
        harness.cell_parts(BENCH, "no.such_cell")


def test_the_gkr_entry_refuses_a_circuit_it_does_not_prove():
    _, config, traffic = harness.cell_parts(BENCH, "gkr.bn254_d24_public")
    with pytest.raises(ValueError, match="ADD gates"):
        harness.entry_class(traffic)(dict(config, gate="mul"), traffic, 1, "cpu")
