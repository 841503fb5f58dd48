"""The port's span recorder (``tpufd_torch.spans``): the ring, the clock it
shares with torch.profiler, the spans the differential timer records,
and the iteration counter beside them."""

import threading
import time

import numpy as np
import pytest
import torch

from tpufd_torch import __main__ as cli
from tpufd_torch import health, metrics, spans


@pytest.fixture
def recorder(monkeypatch):
    """A fresh process recorder and metrics registry."""
    fresh = spans.Recorder()
    monkeypatch.setattr(spans, "_DEFAULT", fresh)
    monkeypatch.setattr(metrics, "_DEFAULT", metrics.Registry())
    return fresh


class FakeClock:
    """perf_counter stand-in: a probe call advances it by a fixed
    overhead plus `per_iter` seconds per loop iteration, or, where
    `first` is (n_max, cost) and the call runs at most n_max iterations,
    `cost` per iteration; it keeps the salts it was given."""

    def __init__(self, per_iter, overhead=0.5, first=None):
        self.now = 0.0
        self.per_iter = per_iter
        self.overhead = overhead
        self.first = first
        self.salts = []

    def __call__(self):
        return self.now

    def probe(self, n, salt):
        self.salts.append(salt)
        per_iter = self.per_iter
        if self.first is not None and int(n) <= self.first[0]:
            per_iter = self.first[1]
        self.now += self.overhead + int(n) * per_iter
        return np.array([float(salt)])


def named(recorder, name):
    return [s for s in recorder.spans if s.name == name]


# ---- the ring ------------------------------------------------------------

def test_spans_nest_with_parent_and_request_ids(recorder):
    with recorder.span("probe", probe="p") as root:
        with recorder.span("timer") as timer:
            with recorder.span("timer.run", n=1) as run:
                pass
        with recorder.span("timer") as second:
            pass
    with recorder.span("probe") as other:
        pass
    assert [s.name for s in recorder.spans] == [
        "timer.run", "timer", "timer", "probe", "probe"]
    assert (root.parent, timer.parent, run.parent, second.parent) == (
        None, root.id, timer.id, root.id)
    assert {s.request for s in (root, timer, run, second)} == {root.id}
    assert other.request == other.id != root.id
    assert len({s.id for s in recorder.spans}) == 5
    assert root.start_ns <= timer.start_ns <= run.start_ns <= run.end_ns \
        <= timer.end_ns <= second.start_ns <= root.end_ns
    assert run.attrs == {"n": 1} and root.attrs == {"probe": "p"}
    assert recorder.current_request() is None


@pytest.mark.parametrize("capacity, opened", [(1, 3), (4, 4), (4, 10)])
def test_the_ring_drops_its_oldest_spans_and_counts_them(capacity, opened):
    recorder = spans.Recorder(capacity=capacity)
    for i in range(opened):
        with recorder.span("s", i=i):
            pass
    kept = min(capacity, opened)
    assert [s.attrs["i"] for s in recorder.spans] == list(
        range(opened - kept, opened))
    assert recorder.dropped == opened - kept


def test_a_raise_closes_the_span_with_its_error(recorder):
    with pytest.raises(ValueError):
        with recorder.span("probe") as root:
            with recorder.span("timer"):
                raise ValueError("boom")
    timer = named(recorder, "timer")[0]
    assert timer.attrs["error"] == root.attrs["error"] == "ValueError: boom"
    assert timer.end_ns is not None and recorder.current_request() is None


def test_each_thread_nests_its_own_spans(recorder):
    seen = {}

    def worker():
        with recorder.span("probe") as s:
            seen["thread"] = (s.parent, recorder.current_request() is s)

    with recorder.span("probe") as mine:
        t = threading.Thread(target=worker)
        t.start()
        t.join(timeout=10)
    assert not t.is_alive()
    assert seen["thread"] == (None, True)
    assert recorder.current_request() is None and mine.parent is None


def test_a_span_lies_around_its_profiler_event_in_the_profilers_clock(
        recorder):
    """Converted to the profiler's clock, a span's ends lie within 200 us
    of those of a record_function region it holds (the best of five, so
    a descheduled thread cannot fail it)."""
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    with prof:
        with torch.profiler.record_function("warm"):
            pass
        for _ in range(5):
            with recorder.span("region"):
                with torch.profiler.record_function("region"):
                    time.sleep(0.002)
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name() == "region"]
    regions = named(recorder, "region")
    assert len(events) == len(regions) == 5
    gaps = [max(abs(e.start_ns() - recorder.to_profiler_ns(s.start_ns)),
                abs(recorder.to_profiler_ns(s.end_ns) - e.end_ns()))
            for e, s in zip(events, regions)]
    assert min(gaps) <= 200_000, gaps


def test_the_clock_offset_is_realtime_minus_perf_counter():
    before = time.time_ns() - time.perf_counter_ns()
    offset = spans.profiler_clock_offset_ns()
    after = time.time_ns() - time.perf_counter_ns()
    assert min(before, after) - 1_000_000 <= offset \
        <= max(before, after) + 1_000_000


# ---- the timer's spans -----------------------------------------------------

# (per_iter, iters, settle_s, the n of each calibration step, the last the
# accepted one, the index of the step aimed at settle_s, (n_max, the cost
# per iteration of a run of at most n_max iterations) where it differs,
# a peer's median over this rank's where ranks agree). Each step runs 3
# pairs of 2n and n; the warm-up, 2 * iters. A step under 1/4 of
# settle_s is followed by a pilot step, aimed at 1/4 of 1.15 times
# settle_s, at least twice its length; a longer step, by the least
# multiple of iters predicted at 1.15 times settle_s, but no further
# than the least iters * 4**k predicted at settle_s: at 1e-3 s, 8 iters,
# the pilot runs at 48 and the aimed step at 176 (0.176 s).
LADDERS = [
    (1e-3, 4, 0.02, [4, 8, 24], 2, None, None),
    (1e-4, 4, 0.02, [4, 60, 232], 2, None, None),
    (2.0, 4, 0.02, [4], None, None, None),
    (1e-3, 8, 0.15, [8, 48, 176], 2, None, None),
    # a first step twice as dear: its pilot falls under 1/4 of settle_s
    # and a second pilot follows, at least twice as long
    (1.5e-4, 8, 0.15, [8, 144, 288, 1152], 3, (16, 3e-4), None),
    # a first step twice as cheap: the pilot runs twice its aim, and the
    # aimed step, aimed from the pilot's cost, lands on it
    (1e-4, 8, 0.15, [8, 864, 1728], 2, (16, 5e-5), None),
    # a first step with no cost to measure: a rung of 4, then the pilot
    (1e-4, 8, 0.15, [8, 32, 432, 1728], 3, (16, 0.0), None),
    # a peer 4 times slower: the agreed median sets every length
    # ([8, 432, 1728] alone)
    (1e-4, 8, 0.15, [8, 112, 432], 2, None, 4.0),
    # a cost 1/1.2 as dear past the pilot's runs: the aimed step reads
    # 0.96 of settle_s and climbs once, to the rung predicted at settle_s
    (1e-4, 8, 0.15, [8, 360, 1440, 2048], 2, (720, 1.2e-4), None),
]


@pytest.mark.parametrize(
    "per_iter, iters, settle_s, ladder, aimed, first, peer", LADDERS,
    ids=[f"{c[0]}-{c[1]}-{c[2]}-ladder{i}" for i, c in enumerate(LADDERS)])
def test_time_iters_records_its_ladder(recorder, monkeypatch, per_iter,
                                       iters, settle_s, ladder, aimed,
                                       first, peer):
    clock = FakeClock(per_iter, first=first)
    monkeypatch.setattr(time, "perf_counter", clock)
    if peer is not None:
        monkeypatch.setattr(health, "_agree_max",
                            lambda value, device: peer * value)
    with recorder.span("probe", probe="matmul-tflops"):
        seconds = health._time_iters(clock.probe, iters, settle_s=settle_s)
    assert seconds == pytest.approx(iters * per_iter * (peer or 1.0))
    (timer,) = named(recorder, "timer")
    steps, runs = named(recorder, "timer.step"), named(recorder, "timer.run")
    assert [s.attrs["n"] for s in steps] == ladder
    assert [s.attrs["accepted"] for s in steps] == [False] * (
        len(ladder) - 1) + [True]
    assert timer.attrs["settle_s"] == settle_s
    jumped = [i for i, s in enumerate(steps) if s.attrs.get("jumped")]
    assert jumped == ([] if aimed is None else [aimed])
    want_runs = [2 * iters] + [m for n in ladder for m in (2 * n, n) * 3]
    assert [r.attrs["n"] for r in runs] == want_runs
    assert [r.attrs["role"] for r in runs] == ["warm"] + ["2n", "n"] * (
        3 * len(ladder))
    assert [r.attrs["salt"] for r in runs] == clock.salts
    assert timer.attrs["iterations_run"] == sum(want_runs)
    assert timer.attrs["iterations_label"] == ladder[-1]
    assert all(r.parent == s.id for s in steps for r in runs
               if s.start_ns <= r.start_ns <= s.end_ns)
    assert {s.parent for s in steps} == {timer.id}
    text = metrics.default_registry().render()
    outcome = None if aimed is None else (
        "accepted" if aimed == len(ladder) - 1 else "climbed")
    for name in health._JUMP_OUTCOMES:
        assert metrics.sample_value(
            text, "tpufd_timer_jumps_total",
            {"probe": "matmul-tflops", "outcome": name}) == (
                name == outcome)


def test_the_same_work_aims_from_its_last_accepted_cost(recorder,
                                                        monkeypatch):
    """A call under a key that a call before accepted aims its second step
    from that call's cost per iteration and runs no pilot; another key
    runs its pilot. Where the cost fell since, 1/1.2 as dear, the aimed
    step falls short and climbs, and the key keeps the newer cost."""
    monkeypatch.setattr(health, "_accepted_cost", {})
    ladders = []
    for per_iter, key in ((1e-3, "a"), (1e-3, "a"), (1e-3, "b"),
                          (1e-3 / 1.2, "a")):
        clock = FakeClock(per_iter)
        monkeypatch.setattr(time, "perf_counter", clock)
        first = len(named(recorder, "timer.step"))
        with recorder.span("probe", probe="matmul-tflops"):
            seconds = health._time_iters(clock.probe, 8, settle_s=0.15,
                                         key=key)
        assert seconds == pytest.approx(8 * per_iter)
        steps = named(recorder, "timer.step")[first:]
        ladders.append([(s.attrs["n"], s.attrs.get("jumped", False))
                        for s in steps])
    assert ladders == [[(8, False), (48, False), (176, True)],
                       [(8, False), (176, True)],
                       [(8, False), (48, False), (176, True)],
                       [(8, False), (176, True), (352, False)]]
    assert health._accepted_cost == pytest.approx(
        {"a": 1e-3 / 1.2, "b": 1e-3})
    text = metrics.default_registry().render()
    assert [metrics.sample_value(text, "tpufd_timer_jumps_total",
                                 {"probe": "matmul-tflops", "outcome": name})
            for name in health._JUMP_OUTCOMES] == [3, 1, 0]


def test_step_differences_are_the_timers(recorder, monkeypatch):
    """Each step holds its three t(2n) - t(n) in the order run; the label
    rests on the accepted step's median. The first step's and the pilot's
    1e-3 s an iteration send the timer on to n = 176, whose runs take the
    times below."""
    clock = FakeClock(1e-3)
    times = iter([0.30, 0.10, 0.31, 0.10, 0.28, 0.10])
    real = clock.probe

    def probe(n, salt):  # the accepted step's runs take the times above
        if n >= 128:
            clock.now += next(times)
            clock.salts.append(salt)
            return np.array([float(salt)])
        return real(n, salt)

    monkeypatch.setattr(time, "perf_counter", clock)
    seconds = health._time_iters(probe, 4, settle_s=0.15)
    step = named(recorder, "timer.step")[-1]
    assert step.attrs["n"] == 176 and step.attrs["accepted"]
    assert step.attrs["differences"] == pytest.approx([0.20, 0.21, 0.18])
    assert seconds == pytest.approx(0.20 * 4 / 176)


def test_an_unmeasurable_timer_closes_its_spans_with_the_error(
        recorder, monkeypatch):
    clock = FakeClock(per_iter=0.0)
    monkeypatch.setattr(time, "perf_counter", clock)
    with pytest.raises(RuntimeError, match="unmeasurable"):
        with recorder.span("probe", probe="hbm-gbps"):
            health._time_iters(clock.probe, 4, settle_s=0.02)
    (probe,), (timer,) = named(recorder, "probe"), named(recorder, "timer")
    assert probe.attrs["error"].startswith("RuntimeError: unmeasurable")
    assert timer.attrs["error"] == probe.attrs["error"]
    assert timer.attrs["iterations_label"] == 0
    steps = named(recorder, "timer.step")
    assert [s.attrs["n"] for s in steps] == [4 * 4 ** k for k in range(6)]
    assert not any(s.attrs["accepted"] for s in steps)
    text = metrics.default_registry().render()
    assert metrics.sample_value(text, "tpufd_timer_iterations_total",
                                {"probe": "hbm-gbps", "role": "label"}) == 0
    assert metrics.sample_value(
        text, "tpufd_timer_iterations_total",
        {"probe": "hbm-gbps", "role": "calibration"}) == \
        timer.attrs["iterations_run"]


def test_a_jump_to_the_cap_that_stays_unmeasurable_raises(recorder,
                                                          monkeypatch):
    """A first step with a sliver of cost, then none: the timer jumps to
    the cap, raises there as a full ladder would, and counts the jump's
    outcome as unmeasurable."""
    clock = FakeClock(per_iter=0.0, first=(8, 1e-7))
    monkeypatch.setattr(time, "perf_counter", clock)
    with pytest.raises(RuntimeError, match="at 4096 iterations"):
        with recorder.span("probe", probe="hbm-gbps"):
            health._time_iters(clock.probe, 4, settle_s=0.02)
    (timer,) = named(recorder, "timer")
    steps = named(recorder, "timer.step")
    assert [s.attrs["n"] for s in steps] == [4, 4096]
    assert [s.attrs.get("jumped", False) for s in steps] == [False, True]
    assert not any(s.attrs["accepted"] for s in steps)
    text = metrics.default_registry().render()
    assert [metrics.sample_value(text, "tpufd_timer_jumps_total",
                                 {"probe": "hbm-gbps", "outcome": name})
            for name in health._JUMP_OUTCOMES] == [0, 0, 1]


@pytest.mark.parametrize("probe, leaf, kwargs", [
    (health.matmul_tflops, "matmul-tflops", {"size": 32}),
    (health.hbm_gbps, "hbm-gbps", {"mib": 1}),
    (health.dma_copy_gbps, "dma-copy-gbps", {"mib": 1}),
])
def test_each_probe_reading_is_one_probe_span_over_its_timer(
        recorder, probe, leaf, kwargs):
    assert probe(device="cpu", **kwargs) > 0
    (root,) = named(recorder, "probe")
    assert root.attrs == {"probe": leaf} and root.parent is None
    (timer,) = named(recorder, "timer")
    assert timer.parent == root.id
    assert all(s.request == root.id for s in recorder.spans)
    runs = named(recorder, "timer.run")
    assert timer.attrs["iterations_run"] == sum(r.attrs["n"] for r in runs)
    assert runs[0].attrs["role"] == "warm"


def test_the_health_textfile_counts_the_spans_iterations(recorder,
                                                         tmp_path, capsys):
    """`health --device cpu --metrics-out` writes a valid textfile whose
    tpufd_timer_iterations_total adds up, per probe and role, to the
    timer spans' counts, and whose tpufd_timer_jumps_total adds up, per
    probe, to the timer calls that aimed a step at settle_s, those whose
    aimed step was accepted apart."""
    out = tmp_path / "health.prom"
    assert cli.main(["health", "--device", "cpu", "--metrics-out",
                     str(out)]) == 0
    text = out.read_text()
    metrics.validate_exposition(text)
    roots = {s.id: s.attrs["probe"] for s in named(recorder, "probe")}
    assert sorted(set(roots.values())) == ["hbm-gbps", "matmul-tflops"]
    for leaf in ("matmul-tflops", "hbm-gbps"):
        timers = [t for t in named(recorder, "timer")
                  if roots[t.request] == leaf]
        assert len(timers) == 3  # the median of three readings
        label = sum(t.attrs["iterations_label"] for t in timers)
        ran = sum(t.attrs["iterations_run"] for t in timers)
        assert 0 < label < ran
        for role, want in (("label", label), ("calibration", ran - label)):
            assert metrics.sample_value(
                text, "tpufd_timer_iterations_total",
                {"probe": leaf, "role": role}) == want
        jumps = {name: metrics.sample_value(
            text, "tpufd_timer_jumps_total",
            {"probe": leaf, "outcome": name})
            for name in health._JUMP_OUTCOMES}
        assert sum(jumps.values()) == sum(
            s.attrs.get("jumped", False) for s in named(recorder, "timer.step")
            if roots[s.request] == leaf)
        assert jumps["accepted"] == sum(
            s.attrs["accepted"] for s in named(recorder, "timer.step")
            if s.attrs.get("jumped") and roots[s.request] == leaf)


# ---- picking the window's readings ---------------------------------------

def fake_reading(recorder, ns):
    with recorder.span("probe", probe="p"):
        with recorder.span("timer"):
            for n in ns:
                with recorder.span("timer.run", n=n):
                    pass


def test_window_takes_the_last_readings_checked_against_their_runs():
    recorder = spans.Recorder()
    for ns in ([1, 2], [3, 4], [5, 6]):
        fake_reading(recorder, ns)
    got = spans.window([[3, 4], [5, 6]], recorder)
    assert [[r.attrs["n"] for r in g["timer.run"]] for g in got] == [
        [3, 4], [5, 6]]
    assert [len(g["timer"]) for g in got] == [1, 1]
    assert got[0]["probe"].request == got[0]["probe"].id
    assert spans.window([[3, 4], [5, 7]], recorder) is None
    assert spans.window([[1, 2]] * 4, recorder) is None
    assert spans.window([], recorder) is None


def test_window_is_silent_once_the_ring_dropped_spans():
    recorder = spans.Recorder(capacity=5)
    fake_reading(recorder, [1, 2])
    assert spans.window([[1, 2]], recorder) is not None
    fake_reading(recorder, [1, 2])
    assert recorder.dropped and spans.window([[1, 2]], recorder) is None
