"""The metrics that read the program's own spans (tpufd_torch.spans):
their values on canned spans, their silence where the spans cannot be
the window's readings, and the idle time outside the timer's runs on a
synthetic trace."""

import json
import sys

import pytest
import torch

from portbench import harness
from portbench.tests.helpers import ROOT, small
import tpufd_torch
from tpufd_torch import spans

NEW = {
    "timer_useful_pct": ("higher", "program_counter", "reading_s"),
    "timer_ladder_pct": ("lower", "program_span", "reading_s"),
    "timer_pair_spread_pct": ("lower", "program_span", "label_peak_pct"),
    "idle_outside_runs_pct": ("lower", "program_span", "reading_s"),
}
OFFSET_NS = 5_000_000  # the canned recorder's perf_counter -> profiler clock


def add(recorder, name, start, end, parent, **attrs):
    """A finished span with the given times, as the probes record it."""
    s = spans.Span(recorder, name, attrs)
    s.id = next(recorder._ids)
    s.parent = parent.id if parent else None
    s.request = parent.request if parent else s.id
    s.start_ns, s.end_ns = start, end
    return s


def canned_reading(recorder, base, accepted_differences):
    """One reading at `base` ns: probe [0, 1000], timer [100, 900], a warm
    run of 2 at [100, 140], step n=1 [150, 390] with six 30 ns runs 40 ns
    apart, then the accepted step n=4 [400, 900] with six 70 ns runs 80
    ns apart. Returns the n of its runs."""
    probe = add(recorder, "probe", base, base + 1000, None, probe="p")
    timer = add(recorder, "timer", base + 100, base + 900, probe,
                iterations_run=2 + 3 * (2 + 1) + 3 * (8 + 4),
                iterations_label=4)
    closed = [add(recorder, "timer.run", base + 100, base + 140, timer,
                  n=2, salt=0.125, role="warm")]
    steps = [(1, base + 150, base + 390, 40, 30, [0.1, 0.1, 0.1], False),
             (4, base + 400, base + 900, 80, 70, accepted_differences,
              True)]
    for n, start, end, pitch, length, differences, accepted in steps:
        step = add(recorder, "timer.step", start, end, timer, n=n,
                   differences=differences, accepted=accepted)
        for k, (m, role) in enumerate([(2 * n, "2n"), (n, "n")] * 3):
            t = start + k * pitch
            closed.append(add(recorder, "timer.run", t, t + length, step,
                              n=m, salt=0.25, role=role))
        closed.append(step)
    closed += [timer, probe]
    recorder.spans.extend(closed)
    return [s.attrs["n"] for s in closed if s.name == "timer.run"]


@pytest.fixture
def canned(monkeypatch):
    """Two canned readings at 0 and 2000 ns in a fresh process recorder,
    and the harness's record of their timer runs."""
    recorder = spans.Recorder()
    recorder.offset_ns = OFFSET_NS
    monkeypatch.setattr(spans, "_DEFAULT", recorder)
    runs = [canned_reading(recorder, 0, [0.30, 0.33, 0.27]),
            canned_reading(recorder, 2000, [0.30, 0.31, 0.30])]
    record = {"readings": [{"timer": [{"runs": [[n, 0.0] for n in ns]}]}
                           for ns in runs],
              "trace": None}
    return recorder, record


def read(name, record):
    return harness.metric_module(name).read(record)


def test_the_manifest_has_the_four_entries_as_specified():
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in manifest["per_layer"]}
    for name, (better, source, moves) in NEW.items():
        assert entries[name] == {
            "name": name, "unit": "%", "better": better, "source": source,
            "layer": "differential timer", "moves": moves,
            "workloads": ["health.matmul", "extended.dma_copy", "health.hbm"]}


def test_timer_useful_pct_is_label_over_run_iterations(canned):
    assert read("timer_useful_pct", canned[1]) == pytest.approx(
        100 * (4 + 4) / (47 + 47))


def test_timer_ladder_pct_is_the_timer_time_outside_the_accepted_step(
        canned):
    # Each timer lasts 800 ns, of which its accepted step 500.
    assert read("timer_ladder_pct", canned[1]) == pytest.approx(
        100 * (1600 - 1000) / 1600)


def test_timer_pair_spread_pct_is_the_widest_accepted_step(canned):
    # (0.33 - 0.27) / 0.30 against (0.31 - 0.30) / 0.30.
    assert read("timer_pair_spread_pct", canned[1]) == pytest.approx(20.0)


def brute_force_outside(runs, device_ops, lo, hi):
    """Nanoseconds of [lo, hi) covered by neither a run nor a device
    operation, counted one by one."""
    covered = set()
    for s, e in runs + device_ops:
        covered.update(range(max(s, lo), min(e, hi)))
    return (hi - lo) - len(covered)


def test_idle_outside_runs_pct_on_a_synthetic_trace(canned):
    recorder, record = canned
    runs = [(s.start_ns + OFFSET_NS, s.end_ns + OFFSET_NS)
            for s in recorder.spans if s.name == "timer.run"]
    # Device operations in the profiler's clock: one inside a run, one
    # across a run's end (covering a gap between runs), the probe's
    # buffer fill before its first run, one between the readings, and
    # one past the last reading.
    at = OFFSET_NS
    ops = [(at + 160, at + 175), (at + 370, at + 385), (at + 50, at + 90),
           (at + 1500, at + 1600), (at + 2950, at + 3200)]
    record["trace"] = {
        "window_s": 3100e-9, "busy_s": 0.0,
        "device_ops": [("k", s, e, "aten::x") for s, e in ops]}
    outside = brute_force_outside(runs, ops, at, at + 3000)
    # Each reading: 1000 ns less its runs (40 + 6 * 30 + 6 * 70); the
    # first less the fill (40) and the gap the op across a run's end
    # covers (5), the second less the op in [2950, 3000] (50); then the
    # 1000 ns between the readings less the op in it (100).
    assert outside == ((1000 - 640 - 40 - 5) + (1000 - 640 - 50)
                       + (1000 - 100))
    assert read("idle_outside_runs_pct", record) == pytest.approx(
        100 * outside / 3100)


def test_idle_outside_runs_pct_is_silent_without_device_operations(canned):
    record = dict(canned[1], trace={"window_s": 1.0, "busy_s": 0.0,
                                    "device_ops": []})
    assert read("idle_outside_runs_pct", record) is None


@pytest.mark.parametrize("name", sorted(NEW))
def test_silent_when_the_readings_outnumber_the_probe_spans(canned, name):
    record = canned[1]
    record["readings"].insert(0, record["readings"][0])
    record["trace"] = {"window_s": 1.0, "busy_s": 0.0,
                       "device_ops": [("k", 0, 1, "x")]}
    assert read(name, record) is None


@pytest.mark.parametrize("name", sorted(NEW))
def test_silent_when_the_runs_differ_from_the_harness_record(canned, name):
    record = canned[1]
    record["readings"][1]["timer"][0]["runs"].pop()
    record["trace"] = {"window_s": 1.0, "busy_s": 0.0,
                       "device_ops": [("k", 0, 1, "x")]}
    assert read(name, record) is None


@pytest.mark.parametrize("name", sorted(NEW))
def test_silent_once_spans_were_dropped(canned, name):
    recorder, record = canned
    recorder.dropped = 1
    record["trace"] = {"window_s": 1.0, "busy_s": 0.0,
                       "device_ops": [("k", 0, 1, "x")]}
    assert read(name, record) is None


@pytest.mark.parametrize("name", sorted(NEW))
def test_silent_on_a_program_without_spans(canned, monkeypatch, name):
    """The parent commit's program has no tpufd_torch.spans: each metric
    reads nothing and raises nothing."""
    record = canned[1]
    record["trace"] = {"window_s": 1.0, "busy_s": 0.0,
                       "device_ops": [("k", 0, 1, "x")]}
    monkeypatch.setitem(sys.modules, "tpufd_torch.spans", None)
    monkeypatch.delattr(tpufd_torch, "spans")
    assert read(name, record) is None


@pytest.mark.parametrize("cell", ["health.matmul", "extended.dma_copy"])
def test_a_traced_cpu_window_reports_the_span_metrics(monkeypatch, cell):
    """On the CPU the three host-side metrics read the window's spans;
    the idle share, without device operations, stays silent."""
    monkeypatch.setattr(spans, "_DEFAULT", spans.Recorder())
    result, readings, _ = harness.run_cell(
        cell, 2**31 + 29, 0.2, True, torch.device("cpu"),
        overrides=small(cell),
        peaks={"bf16_dense_tflops": 1e6, "hbm_gbps": 1e6}, process_start=0.0)
    got = result["metrics"]
    assert {"timer_useful_pct", "timer_ladder_pct",
            "timer_pair_spread_pct"} <= set(got)
    assert "idle_outside_runs_pct" not in got
    assert 0 < got["timer_useful_pct"]["value"] < 100 / 9 + 1e-9
    assert 0 < got["timer_ladder_pct"]["value"] < 100
    timers = [t for t in spans.default_recorder().spans if t.name == "timer"]
    assert len(timers) == len(readings)
