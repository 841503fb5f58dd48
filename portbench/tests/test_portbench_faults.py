"""The output check fails the program's faults and the control, and passes
the sound program: each cell driven whole on the CPU at a small size,
with the timed path broken underneath."""

import math

import pytest
import torch

from portbench import harness
from portbench.tests.helpers import small
from tpufd_torch import chain_tail, dma_copy, health

CPU = torch.device("cpu")
PEAKS = {"bf16_dense_tflops": 1e6, "hbm_gbps": 1e6}


def run(cell, peaks=PEAKS):
    result, _, _ = harness.run_cell(cell, 2**33 + 5, 0.1, False, CPU,
                                    overrides=small(cell), peaks=peaks)
    return result


def failed_checks(result):
    return {k for k, c in result["checks"].items()
            if not c["value"] <= c["limit"]}


@pytest.mark.parametrize("cell", ["health.matmul", "extended.dma_copy"])
def test_the_sound_program_is_correct(cell):
    result = run(cell)
    assert result["correct"] and not failed_checks(result)


def test_a_chain_step_that_returns_its_state_unchanged(monkeypatch):
    monkeypatch.setattr(chain_tail, "chain_tail", lambda p, acc: acc)
    assert failed_checks(run("health.matmul")) == {"chain_gap"}


def test_half_the_chain_steps_left_out(monkeypatch):
    chain = health._matmul_chain
    monkeypatch.setattr(health, "_matmul_chain",
                        lambda x, n: chain(x, max(n // 2, 1)))
    assert "chain_gap" in failed_checks(run("health.matmul"))


def test_half_the_rows_left_out(monkeypatch):
    def half(p, acc):
        rows = acc.shape[0] // 2
        chain_tail.chain_tail_plain(p[:rows].contiguous(), acc[:rows])
        return acc

    monkeypatch.setattr(chain_tail, "chain_tail", half)
    assert "chain_gap" in failed_checks(run("health.matmul"))


def test_a_chain_tail_without_tanh():
    fault = harness.check_module("matmul_chain").FAULTS["tail_without_tanh"]
    with fault():
        assert failed_checks(run("health.matmul")) == {"chain_gap"}


def test_a_chain_element_altered_where_it_is_produced(monkeypatch):
    def altered(p, acc):
        chain_tail.chain_tail_plain(p, acc)
        acc[0, 0] += 1.0
        return acc

    monkeypatch.setattr(chain_tail, "chain_tail", altered)
    assert failed_checks(run("health.matmul")) == {"chain_gap"}


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_copy_faults(monkeypatch, fault):
    plain = dma_copy.dma_copy_plain

    def broken(x, n, chunks):
        out = plain(x, n, chunks)
        if fault == "unchanged":
            return torch.zeros_like(out)
        if fault == "half":
            out[out.shape[0] // 2:] = 0
        else:
            out.view(torch.int16)[0, 0] ^= 1
        return out

    monkeypatch.setattr(dma_copy, "dma_copy", broken)
    assert failed_checks(run("extended.dma_copy")) == {"copy_mismatches"}


@pytest.mark.parametrize("cell,entry", [
    ("health.matmul", "matmul_tflops"),
    ("extended.dma_copy", "dma_copy_gbps")])
def test_a_label_altered_where_it_is_produced(monkeypatch, cell, entry):
    sound = run(cell)["checks"]["label_over_peak"]["value"] * PEAKS[
        harness.cell_spec(cell)["workload"]["peak"]]
    # A card whose peak is 10x the sound label, and a label 1000x too high.
    peaks = dict(PEAKS, **{harness.cell_spec(cell)["workload"]["peak"]:
                           10 * sound})
    probe = getattr(health, entry)
    monkeypatch.setattr(health, entry, lambda *a, **k: 1000 * probe(*a, **k))
    assert failed_checks(run(cell, peaks)) == {"label_over_peak",
                                               "label_recompute_gap"}


@pytest.mark.parametrize("cell,entry", [
    ("health.matmul", "matmul_tflops"),
    ("extended.dma_copy", "dma_copy_gbps")])
def test_a_label_that_counts_half_the_work(monkeypatch, cell, entry):
    probe = getattr(health, entry)
    monkeypatch.setattr(health, entry, lambda *a, **k: 0.5 * probe(*a, **k))
    result = run(cell)
    assert failed_checks(result) == {"label_recompute_gap"}
    assert result["checks"]["label_recompute_gap"]["value"] == (
        pytest.approx(0.5))


def test_a_label_that_no_timer_call_produced(monkeypatch):
    monkeypatch.setattr(health, "matmul_tflops", lambda *a, **k: 1.0)
    result = run("health.matmul")
    assert not result["correct"]
    assert failed_checks(result) == {"label_recompute_gap"}
    assert result["checks"]["timer_gap"]["value"] == math.inf


def test_a_raised_reading_is_counted_and_fails_the_run(monkeypatch):
    def raises(*args, **kwargs):
        raise RuntimeError("unmeasurable device time")

    monkeypatch.setattr(health, "dma_copy_gbps", raises)
    result = run("extended.dma_copy")
    assert result["failed"] == result["attempted"] >= 1
    assert not result["correct"]
    assert failed_checks(result) == {"failed_readings", "label_over_peak",
                                     "label_recompute_gap"}
    assert result["checks"]["timer_gap"]["value"] == math.inf


@pytest.mark.parametrize("cell", ["health.matmul", "extended.dma_copy"])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_control_fails_the_check(cell, seed):
    spec = small(cell)["check"]
    numbers = harness.check_module(spec["module"]).control(spec, seed, CPU)
    assert any(not numbers[k] <= limit for k, limit in spec["limits"].items())
