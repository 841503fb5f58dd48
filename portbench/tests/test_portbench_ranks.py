"""A cell over several ranks, one process each: gloo ranks on the host
drive the port's all-reduce probe, unchanged, through the harness code a
cell of several chips takes (`harness._RankGroup`), with a test-only cell
and a stub check (`ranked.py`)."""

import json
import subprocess
import sys
import textwrap
import time

import pytest
import torch

from portbench import harness
from portbench.tests import ranked
from portbench.tests.helpers import ROOT

CPU = torch.device("cpu")
BROKEN = "portbench.tests.ranked:_broken"


def run(spec, seconds=0.5, trace=False):
    return harness.run_cell("test.allreduce", 2**33 + 3, seconds, trace, CPU,
                            spec=spec, peaks=ranked.PEAKS)


def failed_checks(result):
    return {k for k, c in result["checks"].items()
            if not c["value"] <= c["limit"]}


@pytest.mark.parametrize("ranks,trace", [(4, True)])
def test_every_rank_reads_in_lockstep_to_valid_labels(ranks, trace):
    """At k = 4 here; at k = 2 the test below reads the same labels."""
    result, readings, _ = run(ranked.spec(ranks), trace=trace)
    assert result["correct"], result["checks"]
    # Every reading heard from every other rank, none raised; a rank
    # that made another number of readings would raise RankFault.
    assert result["attempted"] == len(readings) >= 1
    assert all(r["ranks"] == {rank: None for rank in range(1, ranks)}
               for r in readings)
    checks = result["checks"]
    # The work counted at k ranks (at 1 it would be 0).
    assert checks["label_recompute_gap"]["value"] <= 1e-9
    assert checks["timer_gap"]["value"] <= 0.08
    # The check ran on every rank; each number is the worst of them.
    assert checks["rank"]["value"] == ranks - 1
    assert checks["allreduce_gap"]["value"] <= 1e-6
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result) == keys + (["breakdown"] if trace else []) + [
        "checks"]
    assert result["device"]["count"] == ranks
    json.dumps(result)


def test_a_rank_that_raises_in_its_second_reading_fails_it(tmp_path):
    """At k = 2: the other readings' labels are valid, with the work
    counted at 2 ranks, and every rank made each reading."""
    result, readings, _ = run(ranked.spec(
        2, BROKEN, pid_dir=str(tmp_path), fault="raise", call=3),
        seconds=3.0)  # a reading takes 1-3 s here: the window makes two
    assert len(readings) >= 2
    assert all(sorted(r["ranks"]) == [1] for r in readings)
    assert readings[1]["value"] is None
    assert readings[1]["error"] == "rank 1: RuntimeError: rank 1's call 3"
    assert [r["error"] for r in readings[:1] + readings[2:]] == [None] * (
        len(readings) - 1)
    assert result["failed"] == 1 and not result["correct"]
    assert failed_checks(result) == {"failed_readings"}


def test_a_rank_holding_jax_ends_the_run(tmp_path):
    with pytest.raises(harness.RankFault, match=r"rank 1 of 2 holds \['jax'\]"):
        run(ranked.spec(2, BROKEN, pid_dir=str(tmp_path), fault="jax",
                        call=1))


# A run in a process of its own, as run.py makes it: a rank fault ends
# the process.
PROGRAM = textwrap.dedent("""
    import json, sys
    sys.path.insert(0, sys.argv[1])
    import torch
    from portbench import harness
    from portbench.tests import ranked
    harness.PAST_WINDOW_S = 1
    spec = ranked.spec(2, "portbench.tests.ranked:_broken",
                       pid_dir=sys.argv[2], fault=sys.argv[3], call=2)
    result, _, _ = harness.run_cell("test.allreduce", 5, 0.5, False,
                                    torch.device("cpu"), spec=spec,
                                    peaks=ranked.PEAKS)
    print(json.dumps(result))
""")


def _alive(pid):
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rpartition(")")[2].split()[0] != "Z"
    except FileNotFoundError:
        return False


@pytest.mark.parametrize("fault,says", [
    ("kill", "rank 1 of 2 exited with code -9 before its output check "
             "reported"),
    ("stall", "rank 1 of 2 did not finish reading 1 within 1 s past the "
              "window's close")])
def test_a_killed_or_stalled_rank_ends_the_run_naming_it(tmp_path, fault,
                                                         says):
    start = time.monotonic()
    out = subprocess.run(
        [sys.executable, "-c", PROGRAM, str(ROOT), str(tmp_path), fault],
        capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert out.returncode == harness.RANK_FAULT_EXIT, out.stderr[-3000:]
    assert f"portbench: {says}" in out.stderr
    assert not out.stdout.strip()
    # The window is 0.5 s, the bound 1 s past it; spawning and warming up
    # take a few seconds more.
    assert time.monotonic() - start < 40
    pids = [int(p.read_text()) for p in tmp_path.glob("rank*")]
    assert len(pids) == 2 and not any(_alive(pid) for pid in pids)
