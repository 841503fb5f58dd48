"""The `health.hbm` cell: its files resolve to the deployment's probe, its
window runs correct on the CPU at a small size, its stream check fails
the faults it can see and the control, and `stream_roofline_pct` reads
what its docstring says. The tests marked `card` hold the check at the
cell's own size on the card and skip without one."""

import json
import subprocess
import sys
import textwrap

import pytest
import torch

from portbench import harness, trace
from portbench.faults import LABEL_FAULTS
from portbench.tests.helpers import ROOT, small
from tpufd_torch import health, spans

CELL = "health.hbm"
CPU = torch.device("cpu")
PEAKS = {"bf16_dense_tflops": 1e6, "hbm_gbps": 1e6}
STREAM = health._stream


def run(seed=2**33 + 5, trace_=False):
    result, readings, _ = harness.run_cell(
        CELL, seed, 0.1, trace_, CPU, overrides=small(CELL), peaks=PEAKS,
        process_start=0.0)
    return result, readings


def failed_checks(result):
    return {k for k, c in result["checks"].items()
            if not c["value"] <= c["limit"]}


def test_the_cell_drives_the_deployments_stream_probe():
    spec = harness.cell_spec(CELL)
    workload, config = spec["workload"], spec["config"]
    assert spec["cell"]["config"] == "h100-health-hbm"
    assert spec["cell"]["chips"] == 1
    assert workload["entry"] == "tpufd_torch.health:hbm_gbps"
    assert config["probes"]["hbm-gbps"] == workload["kwargs"] == {
        "mib": 512, "iters": 16}
    # The probe is the default exec's, at that exec's sizes.
    exec_config = harness.cell_spec("health.matmul")["config"]
    assert exec_config["probes"]["hbm-gbps"] == workload["kwargs"]
    for key in ("card", "dtype", "settle_s", "readings_per_label"):
        assert config[key] == exec_config[key]
    assert config["stream"]["elements"] * 2 == workload["kwargs"]["mib"] << 20
    assert config["stream"]["bytes_per_flip"] == 2 * (
        workload["kwargs"]["mib"] << 20)
    assert workload["warm"]["kwargs"]["mib"] == workload["check"]["mib"] == (
        workload["kwargs"]["mib"])
    assert workload["check"]["flips"] == [workload["kwargs"]["iters"],
                                          workload["kwargs"]["iters"] + 1]
    assert harness.resolve(workload["check"]["body"]) is health._stream
    assert [m["name"] for m in spec["per_layer"]
            if "workloads" in m] == ["stream_roofline_pct"]


@pytest.mark.parametrize("trace_", [False, True])
def test_a_small_cpu_window_is_correct(trace_):
    result, readings = run(trace_=trace_)
    assert result["correct"] and not failed_checks(result)
    assert result["checks"]["stream_mismatches"]["value"] == 0
    assert result["attempted"] == len(readings) >= 1
    # No device operations on the CPU: the roofline reads nothing.
    assert "stream_roofline_pct" not in result["metrics"]


def _one_element_left_unflipped(x, n):
    for _ in range(n):
        x[1:].neg_()
    return x


@pytest.mark.parametrize("body", [
    _one_element_left_unflipped,
    lambda x, n: STREAM(x, n - n % 2),  # the odd-n parity ignored
    lambda x, n: STREAM(x, n // 2),  # half the flips
    lambda x, n: STREAM(x.float(), n),  # a float32 result
])
def test_stream_faults_fail_the_check(monkeypatch, body):
    monkeypatch.setattr(health, "_stream", body)
    result, _ = run()
    assert failed_checks(result) == {"stream_mismatches"}


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_control_fails_the_check(seed):
    spec = small(CELL)["check"]
    numbers = harness.check_module("stream").control(spec, seed, CPU)
    assert numbers["stream_mismatches"] > 0


def test_a_label_that_counts_half_the_work(monkeypatch):
    probe = health.hbm_gbps
    monkeypatch.setattr(health, "hbm_gbps",
                        lambda *a, **k: 0.5 * probe(*a, **k))
    result, _ = run()
    assert failed_checks(result) == {"label_recompute_gap"}


# Two readings over [0, 1000] ns: two neg_ launches of one _stream call
# of 2 flips, the salting add and a fetch.
NEG = ("void at::native::vectorized_elementwise_kernel<4, "
       "at::native::neg_kernel_cuda(at::TensorIteratorBase&)>")
SYNTH = trace.summarize(
    readings=[("portbench.reading", 0, 500), ("portbench.reading", 500,
                                               1000)],
    device_ops=[("add_kernel", 0, 100, 0), (NEG, 100, 400, 0),
                (NEG, 400, 700, 0), ("Memcpy DtoH", 700, 710, 0)],
    host_ops=[], launchers={})


def stream_record(calls):
    return {"trace": SYNTH, "spans": {"tpufd_torch.health:_stream": calls},
            "peaks": {"hbm_gbps": 2000.0}}


def test_stream_roofline_is_least_over_measured_time():
    metric = harness.metric_module("stream_roofline_pct")
    x = torch.zeros(250, dtype=torch.bfloat16)
    call = metric.SPANS[metric.TARGET](x, 2)
    assert call == {"bytes": 2 * 250 * 2 * 2, "flips": 2}
    # 2000 B at 2000 GB/s is 1 ns, of 600 ns of neg_ kernels.
    assert metric.read(stream_record([call])) == pytest.approx(100 / 600)


@pytest.mark.parametrize("flips", [[1], [2, 1], [0]])
def test_stream_roofline_is_silent_when_the_launches_differ(flips):
    metric = harness.metric_module("stream_roofline_pct")
    calls = [{"bytes": 1000 * n, "flips": n} for n in flips]
    assert metric.read(stream_record(calls)) is None
    assert metric.read(stream_record([])) is None


def test_the_timer_metrics_read_on_the_cells_spans(monkeypatch):
    monkeypatch.setattr(spans, "_DEFAULT", spans.Recorder())
    result, readings = run(seed=2**31 + 29, trace_=True)
    got = result["metrics"]
    assert {"timer_useful_pct", "timer_ladder_pct",
            "timer_pair_spread_pct"} <= set(got)
    assert 0 < got["timer_useful_pct"]["value"] < 100 / 9 + 1e-9
    probes = [s for s in spans.default_recorder().spans
              if s.name == "probe"]
    assert [p.attrs["probe"] for p in probes] == ["hbm-gbps"] * len(
        readings)


def test_a_run_loads_no_jax_and_no_jax_package():
    program = textwrap.dedent("""
        import json, sys
        sys.path.insert(0, sys.argv[1])
        import torch
        from portbench import harness
        from portbench.tests.helpers import small
        for trace in (False, True):
            harness.run_cell("health.hbm", 5, 0.1, trace,
                             torch.device("cpu"),
                             overrides=small("health.hbm"),
                             peaks={"bf16_dense_tflops": 1e6,
                                    "hbm_gbps": 1e6})
        print(json.dumps(sorted({m.partition(".")[0]
                                 for m in sys.modules})))
    """)
    out = subprocess.run([sys.executable, "-c", program, str(ROOT)],
                         capture_output=True, text=True, timeout=300,
                         check=True, cwd=ROOT)
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "tpufd_torch" in loaded and "portbench" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "tpufd"}


def test_the_reference_imports_nothing_of_the_program():
    source = (ROOT / "portbench" / "reference" / "stream.py").read_text()
    imported = {line.split()[1].partition(".")[0]
                for line in source.splitlines()
                if line.startswith(("import ", "from "))}
    assert imported == {"torch"}


# ---- on the card, at the cell's size ---------------------------------------

def _card_check(card, body, seed):
    spec = harness.cell_spec(CELL)["workload"]["check"]
    return harness.check_module("stream").run(spec, seed, card, body)


@pytest.mark.card
def test_a_short_run_on_the_card_is_correct(card):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELL, "--seed",
         str(2**32 + 99), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["checks"]["stream_mismatches"]["value"] == 0


@pytest.mark.card
@pytest.mark.parametrize("seed", [11, 12, 13])
def test_the_program_passes_and_the_control_fails_at_the_cells_size(
        card, seed):
    assert _card_check(card, health._stream, seed) == {
        "stream_mismatches": 0.0}
    spec = harness.cell_spec(CELL)["workload"]["check"]
    numbers = harness.check_module("stream").control(spec, seed, card)
    assert numbers["stream_mismatches"] > 0


@pytest.mark.card
def test_half_the_flips_fail_at_the_cells_size(card):
    numbers = _card_check(card, lambda x, n: STREAM(x, n // 2), 11)
    assert numbers["stream_mismatches"] > 0


@pytest.mark.card
@pytest.mark.parametrize("fault", sorted(LABEL_FAULTS))
def test_a_label_fault_fails_a_run_on_the_card(card, fault):
    workload = harness.cell_spec(CELL)["workload"]
    with LABEL_FAULTS[fault](workload):
        result, _, _ = harness.run_cell(CELL, 2**32 + 7, 0.5, False, card)
    failed = failed_checks(result)
    assert {"halved_time": "timer_gap",
            "halved_work": "label_recompute_gap"}[fault] in failed
    assert not result["correct"]
