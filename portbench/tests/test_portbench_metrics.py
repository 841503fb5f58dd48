"""The metric arithmetic on canned records: the window's time per reading
with a raised reading inside it, the harmonic-mean label share, the
spread, and the trace's idle share, launchers and kernel shares."""

import math

import pytest

from portbench import harness, trace


def record(readings, trace_summary=None, spans=None, peak=1000.0):
    return {"readings": readings, "trace": trace_summary,
            "spans": spans or {}, "peak": peak, "setup_s": 9.5,
            "peaks": {"bf16_dense_tflops": 1000.0, "hbm_gbps": 2000.0}}


READINGS = [
    {"start": 0.0, "end": 4.0, "value": 800.0, "error": None},
    {"start": 4.0, "end": 6.0, "value": None, "error": "RuntimeError: x"},
    {"start": 6.0, "end": 10.0, "value": 400.0, "error": None},
]


def read(name, rec):
    return harness.metric_module(name).read(rec)


def test_reading_s_counts_the_raised_reading_and_its_time():
    assert read("reading_s", record(READINGS)) == pytest.approx(10.0 / 3)


def test_label_share_is_the_harmonic_mean_over_the_peak():
    # 2 / (1/800 + 1/400) = 533.33 of a 1000 peak.
    assert read("label_peak_pct", record(READINGS)) == pytest.approx(
        100 * 2 / (1 / 800 + 1 / 400) / 1000)


def test_spread_is_range_over_median():
    assert read("label_spread_pct", record(READINGS)) == pytest.approx(
        100 * 400 / 600)
    assert read("label_spread_pct", record(READINGS[:2])) is None


def test_setup_s_is_the_recorded_set_up():
    assert read("setup_s", record(READINGS)) == 9.5


def test_a_window_of_raised_readings_reads_no_label():
    failed = [dict(r, value=None, error="x") for r in READINGS]
    assert read("label_peak_pct", record(failed)) is None
    assert read("reading_s", record(failed)) == pytest.approx(10.0 / 3)


# A synthetic trace, ns: two readings over [1000, 3000]; device work
# [1000, 1400] GEMM (launched by aten::mm), [1400, 1500] tail, then idle
# until 2000 while the host runs aten::item, [2000, 2900] GEMM + a
# kernel overlapping it; a kernel outside the window is left out.
SYNTH = trace.summarize(
    readings=[("portbench.reading", 1000, 2000),
              ("portbench.reading", 2000, 3000)],
    device_ops=[("nvjet_gemm", 1000, 1400, 7), ("chain_tail_kernel", 1400,
                                                1500, 0),
                ("nvjet_gemm", 2000, 2900, 8), ("memset", 2100, 2200, 8),
                ("outside", 5000, 6000, 0)],
    host_ops=[("aten::item", 1450, 1990), ("aten::mm", 1990, 2050)],
    launchers={7: "aten::mm", 8: "aten::mm"})


def test_summary_of_a_synthetic_trace():
    assert SYNTH["window_s"] == pytest.approx(2000e-9)
    assert SYNTH["busy_s"] == pytest.approx(1400e-9)
    assert SYNTH["readings"] == 2
    assert [op[0] for op in SYNTH["device_ops"]] == [
        "nvjet_gemm", "chain_tail_kernel", "nvjet_gemm", "memset"]
    assert SYNTH["top_ops"][0] == ["nvjet_gemm", pytest.approx(1300e-9)]
    # Gaps: [1500, 2000] in aten::item (500 ns, a seam below 10 us) and
    # [2900, 3000]: both shorter than a seam.
    assert SYNTH["idle_gaps"] == [[trace.SEAM, pytest.approx(600e-9)]]
    assert dict((k, v) for k, v in SYNTH["by_launcher"])["aten::mm"] == (
        pytest.approx(1400e-9))


def test_long_gaps_are_named_by_the_innermost_host_op():
    summary = trace.summarize(
        readings=[("portbench.reading", 0, 100_000)],
        device_ops=[("k", 0, 10_000, 0), ("k", 60_000, 100_000, 0)],
        host_ops=[("aten::matmul", 5_000, 70_000),
                  ("aten::item", 20_000, 50_000)],
        launchers={})
    assert summary["idle_gaps"] == [["aten::item", pytest.approx(50e-6)]]


def test_idle_share_and_device_time_per_reading():
    rec = record(READINGS, SYNTH)
    assert read("device_idle_pct", rec) == pytest.approx(30.0)
    assert read("device_s_per_reading", rec) == pytest.approx(700e-9)
    assert read("device_idle_pct", record(READINGS)) is None


def test_gemm_roofline_and_step_share_from_the_body_spans():
    # One chain call of 4 steps on a 100 x 100 matrix: 2 * 100^3 * 4 =
    # 8e6 operations, 8 ns at 1000 TFLOP/s, against 1400 ns under aten::mm
    # and a 2000 ns window.
    spans = {"tpufd_torch.health:_matmul_chain": [{"flops": 8_000_000}]}
    rec = record(READINGS, SYNTH, spans)
    assert read("gemm_roofline_pct", rec) == pytest.approx(100 * 8 / 1400)
    assert read("step_mfu_pct", rec) == pytest.approx(100 * 8 / 2000)
    assert read("chain_tail_us", rec) == pytest.approx(0.1)
    assert read("gemm_roofline_pct", record(READINGS, SYNTH)) is None


def test_describers_count_operations_and_bytes():
    import torch
    x = torch.zeros(4, 4, dtype=torch.bfloat16)
    gemm = harness.metric_module("gemm_roofline_pct")
    assert gemm.SPANS[gemm.TARGET](x, 3) == {"flops": 2 * 4 * 4 * 4 * 3}
    dma = harness.metric_module("dma_copy_roofline_pct")
    assert dma.SPANS[dma.TARGET](x, 5, 2) == {"bytes": 2 * 16 * 2 * 5}


def test_dma_roofline_needs_a_launch_per_call():
    summary = trace.summarize(
        readings=[("portbench.reading", 0, 1000)],
        device_ops=[("dma_copy_kernel", 0, 800, 0)], host_ops=[],
        launchers={})
    spans = {"tpufd_torch.dma_copy:dma_copy": [{"bytes": 1000}]}
    # 1000 B at 2000 GB/s is 0.5 ns of 800 ns.
    assert read("dma_copy_roofline_pct", record(
        READINGS, summary, spans)) == pytest.approx(100 * 0.5 / 800)
    spans["tpufd_torch.dma_copy:dma_copy"].append({"bytes": 1000})
    assert read("dma_copy_roofline_pct", record(
        READINGS, summary, spans)) is None


LABEL = {"work": "portbench.reference.labels:matmul_tflops"}
SIZES = {"size": 100, "iters": 4}


def timed(value, seconds, runs, iters=4):
    """A reading whose one timer call made `runs`, (n, seconds) each, back
    to back from the call's start."""
    starts, t = [], 0.0
    for n, length in runs:
        starts.append([n, t])
        t += length
    return {"value": value, "error": None, "start": 0.0, "end": t,
            "timer": [{"iters": iters, "runs": starts, "wall_s": t,
                       "seconds": seconds}]}


# Runs of 1000 and 500 iterations at 2 us each and 1 ms of fixed cost a
# run: the least host time an iteration is 2.001 ms / 1000 = 2.001 us.
RUNS = [(1000, 2.001e-3), (500, 1.001e-3), (1000, 2.001e-3),
        (500, 1.001e-3), (1000, 2.001e-3), (500, 1.001e-3)]
SOUND = 8e6 / 8e-6 / 1e12  # 2 * 100^3 * 4 operations in 4 x 2 us


def test_label_numbers_of_a_sound_reading():
    numbers = harness.label_numbers([timed(SOUND, 8e-6, RUNS)], LABEL,
                                    SIZES)
    assert numbers["label_recompute_gap"] == pytest.approx(0, abs=1e-15)
    assert numbers["timer_gap"] == pytest.approx(1 - 2 / 2.001)


def test_a_host_stall_in_a_run_leaves_the_least_time():
    stalled = [(n, length + (0.5e-3 if i < 4 else 0))
               for i, (n, length) in enumerate(RUNS)]
    numbers = harness.label_numbers([timed(SOUND, 8e-6, stalled)], LABEL,
                                    SIZES)
    assert numbers["timer_gap"] == pytest.approx(1 - 2 / 2.001)


def test_label_numbers_of_halved_work_and_halved_time():
    half_work = harness.label_numbers([timed(SOUND / 2, 8e-6, RUNS)],
                                      LABEL, SIZES)
    assert half_work["label_recompute_gap"] == pytest.approx(0.5)
    half_time = harness.label_numbers([timed(2 * SOUND, 4e-6, RUNS)],
                                      LABEL, SIZES)
    assert half_time["label_recompute_gap"] == pytest.approx(0, abs=1e-15)
    assert half_time["timer_gap"] == pytest.approx(1 - 1 / 2.001)
    # A timer that reports more seconds than the runs took reads 0: the
    # label it gives is low, and label_peak_pct's bound holds that.
    slow = harness.label_numbers([timed(SOUND / 2, 16e-6, RUNS)], LABEL,
                                 SIZES)
    assert slow == {"label_recompute_gap": pytest.approx(0, abs=1e-15),
                    "timer_gap": 0.0}


def test_label_numbers_take_the_widest_and_skip_raised_readings():
    raised = {"value": None, "error": "RuntimeError", "start": 0, "end": 1,
              "timer": [{"iters": 4, "runs": [[8, 0.0]], "wall_s": 1.0,
                         "seconds": None}]}
    numbers = harness.label_numbers(
        [timed(SOUND, 8e-6, RUNS), raised,
         timed(SOUND * 1.25, 6.4e-6, RUNS)], LABEL, SIZES)
    assert numbers["timer_gap"] == pytest.approx(1 - 1.6 / 2.001)


@pytest.mark.parametrize("timer", [
    [], [{"iters": 4, "runs": [[8, 0.0]], "wall_s": 1.0, "seconds": 1.0}] * 2])
def test_a_label_without_exactly_one_timer_call_reads_inf(timer):
    reading = dict(timed(1.0, 8e-6, RUNS), timer=timer)
    numbers = harness.label_numbers([reading], LABEL, SIZES)
    assert numbers == {"label_recompute_gap": math.inf, "timer_gap": math.inf}
    assert harness.label_numbers([], LABEL, SIZES)["timer_gap"] == math.inf
