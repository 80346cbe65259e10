"""BENCHMARK.json, the configurations, traffic mixes, limits and metric
files: found by name, and within the contract's limits."""
import json
import re

import pytest

from port_bench import bounds, harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")


def test_benchmark_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "port_bench/run.py"]
    assert BENCH["paths"] == ["port_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    for name in names + metrics:
        assert NAME.match(name), name
    assert len(set(metrics)) == len(metrics)
    assert len(set(names)) == len(names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("port_bench/configs/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_metrics_entries():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span", "program_counter",
                               "host_clock")
        assert set(m.get("workloads", cells)) <= cells
        assert (harness.BENCH / "metrics" / f"{m['name']}.py").exists()
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%" and harness.metric_patterns(m["name"])


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_cell_loads_by_name(name):
    cell = harness.load_cell(name)
    assert cell.config["name"] == cell.workload["config"]
    stateful = cell.config["optimizer"]["name"] != "sgd"
    assert set(cell.limits) == {"loss_gap", "change_gap"} | ({"state_gap"} if stateful else set())
    leaves = cell.family.leaves(cell.config, cell.traffic)
    assert all(len(shape) >= 1 for shape, _ in leaves.values())
    assert callable(cell.reference.loss)
    for c in BENCH["configs"]:
        cfg = harness.load_json(harness.ROOT / c["file"])
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"] and "assumed" in cfg
        # train_mfu's peak is a published one, of the precision the configuration states
        assert cfg["peak_flops"] == {"bfloat16": bounds.PEAK_BF16_FLOPS,
                                     "float32": bounds.PEAK_F32_FLOPS}[cfg["tower_dtype"]]


def test_unknown_workload_is_refused():
    with pytest.raises(SystemExit):
        harness.load_cell("no.such.cell")
