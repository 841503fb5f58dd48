"""timer_overshoot_pct, which reads the ``settle_s`` of the program's
``timer`` spans: its entry, its value on a window the program's own timer
recorded, and its silence where the spans hold no ``settle_s`` or the
program has no spans."""

import json
import sys
import time

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.tests.helpers import ROOT, small
import tpufd_torch
from tpufd_torch import health, spans


class FakeClock:
    """perf_counter stand-in: a probe call advances it by 0.5 s plus
    `per_iter` seconds per loop iteration, `first` per iteration in runs
    of at most 720 (the first step's and the pilot's, at 8 iters)."""

    def __init__(self, per_iter, first):
        self.now = 0.0
        self.per_iter, self.first = per_iter, first

    def __call__(self):
        return self.now

    def probe(self, n, salt):
        self.now += 0.5 + n * (self.first if n <= 720 else self.per_iter)
        return np.array([float(salt)])


@pytest.fixture
def recorded(monkeypatch):
    """Two readings of the program's timer (8 iters, settle_s 0.15) in a
    fresh process recorder, and the harness's record of their runs. The
    first costs 1e-4 s an iteration throughout: it aims at 1728, whose
    median reads 0.1728 s. The second's first step and pilot are 20%
    dearer than its later runs: it aims at 1440 (0.144 s), climbs to 2048
    and accepts 0.2048 s there."""
    recorder = spans.Recorder()
    monkeypatch.setattr(spans, "_DEFAULT", recorder)
    runs = []
    for first in (1e-4, 1.2e-4):
        clock = FakeClock(1e-4, first)
        with monkeypatch.context() as patched:
            patched.setattr(time, "perf_counter", clock)
            with recorder.span("probe", probe="matmul-tflops"):
                health._time_iters(clock.probe, 8, settle_s=0.15)
        probe = [s for s in recorder.spans if s.name == "probe"][-1]
        runs.append([s.attrs["n"] for s in recorder.spans
                     if s.name == "timer.run" and s.request == probe.id])
    record = {"readings": [{"timer": [{"runs": [[n, 0.0] for n in ns]}]}
                           for ns in runs],
              "trace": None}
    return recorder, record


def read(record):
    return harness.metric_module("timer_overshoot_pct").read(record)


def test_the_manifest_entry_as_specified():
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    (entry,) = [m for m in manifest["per_layer"]
                if m["name"] == "timer_overshoot_pct"]
    assert entry == {
        "name": "timer_overshoot_pct", "unit": "%", "better": "lower",
        "source": "program_span", "layer": "differential timer",
        "moves": "reading_s",
        "workloads": ["health.matmul", "extended.dma_copy", "health.hbm"]}
    assert manifest["per_layer"][-1] is entry


def test_the_mean_overshoot_of_the_accepted_steps(recorded):
    recorder, record = recorded
    accepted = [s.attrs["n"] for s in recorder.spans
                if s.name == "timer.step" and s.attrs["accepted"]]
    assert accepted == [1728, 2048]
    assert read(record) == pytest.approx(
        100 * ((0.1728 / 0.15 - 1) + (0.2048 / 0.15 - 1)) / 2)


def test_silent_where_the_timer_spans_hold_no_settle_s(recorded):
    recorder, record = recorded
    for s in recorder.spans:
        if s.name == "timer":
            del s.attrs["settle_s"]
    assert read(record) is None


def test_silent_where_no_label_was_accepted(recorded):
    recorder, record = recorded
    for s in recorder.spans:
        if s.name == "timer.step":
            s.attrs["accepted"] = False
    assert read(record) is None


def test_silent_when_the_runs_differ_from_the_harness_record(recorded):
    record = recorded[1]
    record["readings"][1]["timer"][0]["runs"].pop()
    assert read(record) is None


def test_silent_on_a_program_without_spans(recorded, monkeypatch):
    monkeypatch.setitem(sys.modules, "tpufd_torch.spans", None)
    monkeypatch.delattr(tpufd_torch, "spans")
    assert read(recorded[1]) is None


def test_a_traced_cpu_window_reports_it(monkeypatch):
    """On the CPU the harness's traced line carries the metric, read from
    the window's own timer spans."""
    monkeypatch.setattr(spans, "_DEFAULT", spans.Recorder())
    result, readings, _ = harness.run_cell(
        "health.matmul", 2**31 + 31, 0.2, True, torch.device("cpu"),
        overrides=small("health.matmul"),
        peaks={"bf16_dense_tflops": 1e6, "hbm_gbps": 1e6}, process_start=0.0)
    timers = [t for t in spans.default_recorder().spans if t.name == "timer"]
    assert len(timers) == len(readings)
    assert {t.attrs["settle_s"] for t in timers} == {0.02}
    assert result["metrics"]["timer_overshoot_pct"]["unit"] == "%"
    assert result["metrics"]["timer_overshoot_pct"]["value"] > -50
