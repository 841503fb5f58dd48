"""BENCHMARK.json and the files it names: every name resolves, and the
manifest keeps to the benchmark's contract."""

import json
import re

import pytest
import torch

from portbench import harness
from portbench.tests.helpers import ROOT, small

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in MANIFEST["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_manifest_has_the_contract_keys():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["command"] == ["python3", "portbench/run.py"]
    assert MANIFEST["paths"] == ["portbench"]
    assert isinstance(MANIFEST["run_seconds"], int)
    assert 1 <= MANIFEST["run_seconds"] <= 51
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    fours = sum(w["chips"] == 4 for w in MANIFEST["workloads"])
    assert fours <= max(1, len(MANIFEST["workloads"]) // 4)
    for m in MANIFEST["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MANIFEST["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_names_units_and_uniqueness():
    groups = [MANIFEST["configs"], MANIFEST["workloads"],
              MANIFEST["end_to_end"] + MANIFEST["per_layer"]]
    for group in groups:
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert len(json.dumps(MANIFEST)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_load_and_their_names_resolve(cell):
    spec = harness.cell_spec(cell)
    workload, config = spec["workload"], spec["config"]
    assert workload["name"] == cell
    assert config["name"] == spec["cell"]["config"]
    assert workload["reader"] == {"loop": "closed", "readers": 1}
    if "exec" in workload:
        assert_exec_files_resolve(workload, config)
        return
    assert callable(harness.resolve(workload["entry"]))
    warm = workload["warm"]
    assert warm == "entry" or callable(harness.resolve(warm["factory"]))
    assert callable(harness.resolve(workload["check"]["body"]))
    label = workload["label"]
    assert callable(harness.resolve(label["timer"]))
    assert callable(harness.resolve(label["work"]))
    assert set(label["limits"]) == {"label_recompute_gap", "timer_gap"}
    checker = harness.check_module(workload["check"]["module"])
    assert callable(checker.run) and callable(checker.control)
    # The window drives the deployment's probe at the deployment's sizes.
    assert config["probes"][workload["probe"]] == workload["kwargs"]
    assert workload["peak"] in harness.card_peaks(config["card"])


def assert_exec_files_resolve(workload, config):
    """An exec cell's files: the CLI's health command, the labels of the
    deployment's probes at its sizes, each with its peak and work, and
    every output check's module and body."""
    assert workload["exec"][0] == "health"
    assert callable(harness.resolve(workload["warm"]["build"]))
    assert callable(harness.resolve(workload["label"]["timer"]))
    assert set(workload["label"]["limits"]) == {"label_recompute_gap",
                                                "timer_gap"}
    assert set(workload["labels"]) == set(config["probes"])
    for name, label in workload["labels"].items():
        assert config["probes"][name] == label["kwargs"]
        assert label["peak"] in harness.card_peaks(config["card"])
        assert callable(harness.resolve(label["work"]))
    assert config["exec_timeout_s"] > 0
    for check in workload["checks"]:
        checker = harness.check_module(check["module"])
        assert callable(checker.run) and callable(checker.control)
        assert callable(harness.resolve(check["body"]))


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_setup_another_end_to_end_and_a_layer(cell):
    spec = harness.cell_spec(cell)
    names = [m["name"] for m in spec["end_to_end"]]
    assert "setup_s" in names and len(names) >= 2
    assert spec["per_layer"]
    moved = {m["moves"] for m in spec["per_layer"]}
    assert moved <= set(names)


@pytest.mark.parametrize("metric", [m["name"] for m in
                                    MANIFEST["end_to_end"]
                                    + MANIFEST["per_layer"]])
def test_metric_files_load(metric):
    module = harness.metric_module(metric)
    assert callable(module.read)
    for target, describe in getattr(module, "SPANS", {}).items():
        assert callable(harness.resolve(target)) and callable(describe)


def test_config_files_lie_under_paths_and_are_distinct():
    files = [c["file"] for c in MANIFEST["configs"]]
    assert len(files) == len(set(files))
    for c in MANIFEST["configs"]:
        assert c["file"].startswith("portbench/")
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["name"] == c["name"] and data["reduced"] == c["reduced"]
        assert data["source"] == c["source"]


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_result_line_has_exactly_the_allowed_keys(cell, trace):
    result, readings, _ = harness.run_cell(
        cell, 2**31 + 17, 0.2, trace, torch.device("cpu"),
        overrides=small(cell),
        peaks={"bf16_dense_tflops": 1e6, "hbm_gbps": 1e6}, process_start=0.0)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    if trace:
        keys.append("breakdown")
    assert list(result) == keys + ["checks"]
    assert result["correct"] is True
    assert result["attempted"] == len(readings) >= 1
    assert set(result["device"]) >= {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    if trace:
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"busy_s", "window_s"} <= set(result["device"])
    else:
        assert set(result["metrics"]) == {
            m["name"] for m in harness.cell_spec(cell)["end_to_end"]}
    json.dumps(result)
