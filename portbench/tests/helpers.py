"""What the benchmark's CPU tests share."""

import math
from pathlib import Path

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]

# Sizes a CPU test run holds, in place of the cell's card sizes.
SMALL_SIZES = {"size": 64, "mib": 1}


def small(name):
    """Cell `name`'s workload file as overrides with its sizes shrunk
    (matmul 64 x 64, DMA copy 1 MiB); everything else, the check's limits
    too, as the file has it, but for the timer's: at these sizes on the
    CPU a loop iteration takes microseconds and the host's jitter moves
    the program's differential by up to twice, so `timer_gap` read 0 to
    0.24 on sound runs and 0 to 0.65 with the timer's seconds halved. It
    is held to its limit on the card (test_portbench_card.py) and to
    arithmetic on canned readings (test_portbench_metrics.py)."""
    workload = harness.load_json(
        harness.BENCH / "workloads" / f"{name}.json")

    def shrink(d):
        return {k: SMALL_SIZES.get(k, v) for k, v in d.items()}

    warm = workload["warm"]
    return {
        "kwargs": shrink(workload["kwargs"]),
        "warm": warm if warm == "entry" else dict(
            warm, kwargs=shrink(warm["kwargs"])),
        "check": shrink(workload["check"]),
        "label": dict(workload["label"], limits=dict(
            workload["label"]["limits"], timer_gap=math.inf)),
    }
