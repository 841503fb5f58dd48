"""On the card: each cell's run ends correct; the control and the planted
faults fail its check at the cell's own size. Skips without a card."""

import json
import subprocess
import sys

import pytest

from portbench import harness
from portbench.faults import LABEL_FAULTS
from portbench.tests.helpers import ROOT

CELLS = ["health.matmul", "extended.dma_copy"]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_is_correct(card, cell):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         str(2**32 + 99), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"


@pytest.mark.card
@pytest.mark.parametrize("seed", [11, 12, 13])
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_at_the_cells_size(card, cell, seed):
    spec = harness.cell_spec(cell)["workload"]["check"]
    numbers = harness.check_module(spec["module"]).control(spec, seed, card)
    assert any(not numbers[k] <= limit for k, limit in spec["limits"].items())


@pytest.mark.card
@pytest.mark.parametrize("seed", [11, 12, 13])
@pytest.mark.parametrize("fault", ["tail_without_tanh"])
def test_the_chain_faults_fail_at_the_cells_size(card, fault, seed):
    spec = harness.cell_spec("health.matmul")["workload"]["check"]
    checker = harness.check_module(spec["module"])
    with checker.FAULTS[fault]():
        numbers = checker.run(spec, seed, card, harness.resolve(spec["body"]))
    assert any(not numbers[k] <= limit for k, limit in spec["limits"].items())


@pytest.mark.card
@pytest.mark.parametrize("fault", sorted(LABEL_FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_a_label_fault_fails_a_run_on_the_card(card, cell, fault):
    workload = harness.cell_spec(cell)["workload"]
    with LABEL_FAULTS[fault](workload):
        result, _, _ = harness.run_cell(cell, 2**32 + 7, 0.5, False, card)
    failed = {k for k, c in result["checks"].items()
              if not c["value"] <= c["limit"]}
    assert {"halved_time": "timer_gap",
            "halved_work": "label_recompute_gap"}[fault] in failed
    assert not result["correct"]
