"""The exec cell: each reading one fresh `python3 -m tpufd_torch health
--extended` process, driven whole through run_cell with the exec on the
CPU (--device cpu, the CLI's small probe sizes), and the faults that must
fail it, each planted in the child through a sitecustomize module on its
PYTHONPATH. On the card (marked): a short run is correct, and a label
1000x too high, a timer that halves its seconds and a copy with one
element altered in the exec fail it."""

import json
import math
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from portbench import execs, harness
from portbench.tests.helpers import ROOT, small

CELL = "exec.extended"
CPU = torch.device("cpu")
PEAKS = {"bf16_dense_tflops": 1e6, "hbm_gbps": 1e6}
LABELS = ("matmul-tflops", "hbm-gbps", "dma-copy-gbps")


def run(spec=None, overrides=None, device=CPU, peaks=PEAKS, trace=False):
    overrides = small(CELL) if overrides is None else overrides
    return harness.run_cell(CELL, 2**33 + 11, 0.1, trace, device,
                            overrides=overrides, peaks=peaks,
                            process_start=0.0, spec=spec)


@pytest.fixture(autouse=True)
def few_threads(monkeypatch):
    """Two threads a child: the tests' workers run children side by side."""
    monkeypatch.setenv("OMP_NUM_THREADS", "2")


def failed_checks(result):
    return {k for k, c in result["checks"].items()
            if not c["value"] <= c["limit"]}


def plant(tmp_path, monkeypatch, code):
    """Runs `code` at the start of every child's interpreter."""
    (tmp_path / "sitecustomize.py").write_text(textwrap.dedent(code))
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [str(tmp_path), str(ROOT)]
        + [p for p in [os.environ.get("PYTHONPATH")] if p]))


@pytest.mark.parametrize("trace", [False, True])
def test_the_sound_exec_is_correct(trace):
    result, readings, _ = run(trace=trace)
    assert result["correct"] and not failed_checks(result), result["checks"]
    assert result["attempted"] == len(readings) == 1
    spec = harness.cell_spec(CELL)
    wanted = spec["per_layer"] if trace else spec["end_to_end"]
    assert set(result["metrics"]) == {m["name"] for m in wanted}
    exec_record = readings[0]["exec"]
    assert set(exec_record["labels"]) == set(LABELS)
    assert [c["probe"] for c in readings[0]["timer"]] == [
        name for name in LABELS for _ in range(3)]
    assert result["checks"]["label_recompute_gap"]["value"] == 0
    # The output checks ran in the exec's process, timed apart.
    child = exec_record["child"]
    assert set(child["checks"]) == {
        "chain_gap", "copy_mismatches", "stream_mismatches"}
    assert child["checks_s"] > 0
    if trace:
        startup, inside, between, wall = execs.phases(exec_record)
        assert min(startup, inside, between) > 0
        metrics = result["metrics"]
        assert (metrics["exec_startup_pct"]["value"]
                + metrics["exec_between_probes_pct"]["value"]
                + 100 * inside / wall) == pytest.approx(100, abs=1)
        assert child["trace"]["window_s"] > 0
    else:
        assert result["metrics"]["exec_s"]["value"] == pytest.approx(
            exec_record["ended"] - exec_record["started"]
            - child["checks_s"])
    json.dumps(result)


FAULTS = {
    # The CLI prints every label and ok=true, then exits 1.
    "exits_1": ("""
        import tpufd_torch.__main__ as cli
        health = cli.cmd_health
        cli.cmd_health = lambda args: health(args) or 1
        """, "exited 1"),
    # The matmul probe raises, and again on its retry: ok=false, exit 1.
    "ok_false": ("""
        from tpufd_torch import health
        def raises(*args, **kwargs):
            raise RuntimeError("planted")
        health.matmul_tflops = raises
        """, "printed no ok=true"),
    # The DMA-copy probe raises: the CLI skips its label, ok stays true.
    "no_dma_copy_label": ("""
        from tpufd_torch import health
        def raises(*args, **kwargs):
            raise RuntimeError("planted")
        health.dma_copy_gbps = raises
        """, "printed no dma-copy-gbps"),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_failed_exec_fails_the_run(tmp_path, monkeypatch, fault):
    code, why = FAULTS[fault]
    plant(tmp_path, monkeypatch, code)
    result, readings, _ = run()
    assert not result["correct"]
    assert result["failed"] == result["attempted"] == 1
    assert why in readings[0]["error"]
    assert {"failed_readings", "label_recompute_gap"} <= failed_checks(result)


def test_a_label_1000x_too_high(tmp_path, monkeypatch):
    plant(tmp_path, monkeypatch, """
        from tpufd_torch import health
        probe = health.matmul_tflops
        health.matmul_tflops = lambda *a, **k: 1000 * probe(*a, **k)
        """)
    result, _, _ = run()
    assert not result["correct"]
    assert failed_checks(result) == {"label_recompute_gap"}
    assert result["checks"]["label_recompute_gap"]["value"] > 100


def test_a_label_from_half_the_work(tmp_path, monkeypatch):
    plant(tmp_path, monkeypatch, """
        from tpufd_torch import health
        probe = health.hbm_gbps
        health.hbm_gbps = lambda *a, **k: 0.5 * probe(*a, **k)
        """)
    result, _, _ = run()
    assert failed_checks(result) == {"label_recompute_gap"}
    assert result["checks"]["label_recompute_gap"]["value"] == (
        pytest.approx(0.5, abs=0.02))


def test_a_timer_that_halves_its_seconds(tmp_path, monkeypatch):
    """The labels agree with the halved seconds the timer returned; the
    host clock over the timer's own runs does not. The timer's limit is
    the card's here: a sound CPU run reads up to about 0.2 (helpers'
    small), a halved one 0.5 or more."""
    plant(tmp_path, monkeypatch, """
        from tpufd_torch import health
        timer = health._time_iters
        health._time_iters = lambda *a, **k: 0.5 * timer(*a, **k)
        """)
    overrides = small(CELL)
    overrides["label"] = harness.cell_spec(CELL)["workload"]["label"]
    result, _, _ = run(overrides=overrides)
    assert not result["correct"]
    assert "timer_gap" in failed_checks(result)
    assert result["checks"]["timer_gap"]["value"] > 0.3
    assert result["checks"]["label_recompute_gap"]["value"] == 0


def test_a_copy_altered_in_the_exec_alone(tmp_path, monkeypatch):
    """A body fault that only the exec's process takes (one bit of the
    copy's first element flipped): the checks run there, on its modules,
    and see it."""
    plant(tmp_path, monkeypatch, """
        import torch
        from tpufd_torch import dma_copy
        copy = dma_copy.dma_copy
        def altered(*args, **kwargs):
            out = copy(*args, **kwargs)
            out.view(-1).view(torch.int16)[0] ^= 1
            return out
        dma_copy.dma_copy = altered
        """)
    result, _, _ = run()
    assert failed_checks(result) == {"copy_mismatches"}
    assert result["checks"]["copy_mismatches"]["value"] == 1


def _canned_exec(offset_error_ns):
    """An exec of 10 s: start-up 2 s, probes of 2 s at 2-4, 4.5-6.5 and
    7-9 s, checks 0.25 s from 9.25 s, exit stamped at 9.75 s; the child's
    boot offset read `offset_error_ns` off."""
    boot = 100 * 10**9  # the process start, CLOCK_BOOTTIME ns
    perf = 7 * 10**9  # perf_counter ns at that start
    s = 10**9

    def probe(a, b):
        return {"name": "probe", "parent": None,
                "start_ns": perf + int(a * s), "end_ns": perf + int(b * s)}

    return {"started": boot / s, "ended": boot / s + 10.0, "child": {
        "dropped": 0, "trace_start_s": 0.0, "trace_stop_s": 0.0,
        "checks_s": 0.25, "boot_offset_ns": boot - perf + offset_error_ns,
        "spans": [probe(7, 9), probe(2, 4), probe(4.5, 6.5)],
        "exit_ns": perf + int(9.75 * s), "exit_boot_ns": boot + 9.75 * s}}


@pytest.mark.parametrize("offset_error_s", [0.0, 0.5, -0.25])
def test_the_phases_meet_the_wall_only_where_the_spans_are_placed_right(
        offset_error_s):
    startup, inside, between, wall = execs.phases(
        _canned_exec(int(offset_error_s * 1e9)))
    assert wall == pytest.approx(9.75)
    assert inside == pytest.approx(6.0)
    assert between == pytest.approx(1.0 + 0.5 + 0.25)
    assert startup == pytest.approx(2.0 + offset_error_s)
    assert startup + inside + between - wall == pytest.approx(offset_error_s)


def test_a_child_that_imports_jax(tmp_path, monkeypatch):
    plant(tmp_path, monkeypatch, "import jax\n")
    result, _, _ = run()
    assert failed_checks(result) == {"child_jax_modules"}
    assert result["checks"]["child_jax_modules"]["value"] >= 1


def test_an_exec_past_its_timeout_is_killed_and_fails(tmp_path, monkeypatch):
    pid_file = tmp_path / "pid"
    plant(tmp_path, monkeypatch, f"""
        import os
        with open({str(pid_file)!r}, "w") as f:
            f.write(str(os.getpid()))
        """)
    spec = harness.cell_spec(CELL)
    spec["config"] = dict(spec["config"], exec_timeout_s=2)
    result, readings, _ = run(spec=spec)
    assert not result["correct"]
    assert result["failed"] == result["attempted"] == 1
    assert readings[0]["error"] == (
        "RuntimeError: killed after 2 s; printed no ok=true; printed no "
        "dma-copy-gbps, hbm-gbps, matmul-tflops; wrote no record")
    assert readings[0]["end"] < 10
    with pytest.raises(ProcessLookupError):
        os.kill(int(pid_file.read_text()), 0)


@pytest.mark.parametrize("text,values,gap", [
    ("834", [834.9, 834.1, 834.5], 0.0),
    ("835", [835.0 * (1 - 1e-12)] * 3, 0.0),  # either side of 835
    ("834", [835.0 * (1 - 1e-12)] * 3, 0.0),
    ("833", [835.0 * (1 - 1e-12)] * 3, 1 / 834),
    ("0.22", [0.2234, 0.2201, 0.25], 0.0),
    ("0.21", [0.2234, 0.2201, 0.25], 0.01 / 0.22),
    ("417", [834.9, 834.1, 834.5], 417 / 834),
])
def test_the_recomputed_label_is_written_as_the_program_writes_it(
        text, values, gap):
    assert execs.recompute_gap(text, values) == pytest.approx(gap)


def test_an_exec_workload_names_the_deployments_probes():
    spec = harness.cell_spec(CELL)
    workload, config = spec["workload"], spec["config"]
    assert spec["cell"]["config"] == "h100-health-extended"
    assert spec["cell"]["chips"] == 1
    assert workload["exec"] == ["health", "--extended"]
    assert workload["env"] == {"TFD_CHIP_COUNT": "1"}
    assert config["exec_timeout_s"] == 240
    assert {name: label["kwargs"] for name, label
            in workload["labels"].items()} == config["probes"]
    # The label cells' checks, at their sizes and limits.
    assert workload["checks"] == [
        harness.cell_spec(cell)["workload"]["check"]
        for cell in ("health.matmul", "extended.dma_copy", "health.hbm")]
    assert math.isfinite(workload["label"]["limits"]["timer_gap"])


@pytest.mark.card
def test_a_short_exec_run_is_correct_on_the_card(card):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELL, "--seed",
         str(2**32 + 101), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"


@pytest.mark.card
@pytest.mark.parametrize("fault,caught", [
    ("""
        from tpufd_torch import health
        probe = health.matmul_tflops
        health.matmul_tflops = lambda *a, **k: 1000 * probe(*a, **k)
        """, {"label_recompute_gap", "label_over_peak"}),
    ("""
        from tpufd_torch import health
        timer = health._time_iters
        health._time_iters = lambda *a, **k: 0.5 * timer(*a, **k)
        """, {"timer_gap", "label_over_peak"}),
    ("""
        import torch
        from tpufd_torch import dma_copy
        copy = dma_copy.dma_copy
        def altered(*args, **kwargs):
            out = copy(*args, **kwargs)
            out.view(-1).view(torch.int16)[0] ^= 1
            return out
        dma_copy.dma_copy = altered
        """, {"copy_mismatches"}),
], ids=["label_1000x", "halved_timer", "altered_copy"])
def test_a_label_fault_fails_the_exec_on_the_card(card, tmp_path, monkeypatch,
                                                  fault, caught):
    plant(tmp_path, monkeypatch, fault)
    result, _, _ = harness.run_cell(CELL, 2**32 + 103, 1.0, False, card)
    assert not result["correct"]
    assert caught <= failed_checks(result), result["checks"]
