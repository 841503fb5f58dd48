"""A test-only cell over several ranks: the port's all-reduce probe
(`tpufd_torch.health.allreduce_gbps`, unchanged) on a one-axis mesh,
with the label's work at k ranks and a stub output check; and entries
that break one rank in its second reading. Rank processes import this
module, so it imports no JAX."""

import os
import signal
import sys
import time
import types

import torch
import torch.distributed as dist

from tpufd_torch import health

PEAKS = {"allreduce_gbps": 1e6}
# The cells that read one probe's labels in the harness's process: the
# metrics common to all of them are this cell's.
LABEL_CELLS = {"health.matmul", "extended.dma_copy", "health.hbm"}
_calls = 0


def allreduce_gbps_work(kwargs, iters, ranks=1):
    """The port's byte count: 2 (k - 1) / k of the mib-MiB bf16 array a
    step, over all k ranks' rows: GB."""
    n = kwargs["mib"] * 1024 * 1024 // 2
    return 2.0 * n * 2 * (ranks - 1) / ranks * iters / 1e9


def spec(ranks, entry="tpufd_torch.health:allreduce_gbps", **extra):
    """The cell in cell_spec's form, on `ranks` ranks, at the CPU's 8 MiB
    (health.probe_sizes) and one loop iteration a unit (a gloo step of
    8 MiB bf16 takes about 70 ms here), its window driving `entry` with
    the `extra` arguments."""
    from portbench import harness
    manifest = harness.load_json(harness.ROOT / "BENCHMARK.json")
    workload = {
        "name": "test.allreduce", "probe": "allreduce-gbps",
        "entry": entry, "mesh": "all",
        "kwargs": {"mib": 8, "iters": 1, **extra},
        "peak": "allreduce_gbps",
        "reader": {"loop": "closed", "readers": 1},
        "warm": "entry",
        "label": {"timer": "tpufd_torch.health:_time_iters",
                  "work": "portbench.tests.ranked:allreduce_gbps_work",
                  "limits": {"label_recompute_gap": 1e-9,
                             "timer_gap": 0.08}},
        "check": {"module": "portbench.tests.ranked",
                  "body": "tpufd_torch.health:_allreduce_loop",
                  "limits": {"allreduce_gap": 1e-6, "rank": ranks - 1}},
    }
    return {"cell": {"name": "test.allreduce", "chips": ranks},
            "workload": workload, "config": {},
            "end_to_end": [m for m in manifest["end_to_end"]
                           if LABEL_CELLS <= set(m.get("workloads",
                                                       LABEL_CELLS))],
            "per_layer": [m for m in manifest["per_layer"]
                          if LABEL_CELLS <= set(m["workloads"])]}


def run(check_spec, seed, device, body):
    """The stub check, on every rank: one step of the program's
    all-reduce loop over the default group on this rank's row of a
    seeded (k, 16) array, against the row plus 1e-6 of the column sums;
    and the rank's own number, whose worst over the ranks is k - 1."""
    k, rank = dist.get_world_size(), dist.get_rank()
    rows = torch.randn((k, 16), generator=torch.Generator().manual_seed(
        seed % 2**63))
    out = body(rows[rank].clone().to(device), 1, None).cpu()
    want = rows[rank] + rows.sum(0) * 1e-6
    return {"allreduce_gap": float((out - want).abs().max()),
            "rank": float(rank)}


def control(check_spec, seed, device):
    return {"allreduce_gap": float("inf"), "rank": float("inf")}


def _broken(mesh, mib, iters, pid_dir, fault, call):
    """allreduce_gbps, with rank 1 broken in its `call`-th call (the
    warm-up's is the first, the window's first reading the second):
    `fault` "raise" raises once the collectives are done, "kill" kills
    the process before them, "stall" sleeps there, and "jax" loads a
    module named jax. Each rank leaves its pid in `pid_dir`."""
    global _calls
    _calls += 1
    rank = dist.get_rank()
    with open(os.path.join(pid_dir, f"rank{rank}"), "w") as f:
        f.write(str(os.getpid()))
    broken = rank == 1 and _calls == call
    if broken and fault == "kill":
        os.kill(os.getpid(), signal.SIGKILL)
    if broken and fault == "stall":
        time.sleep(3600)
    if broken and fault == "jax":
        sys.modules["jax"] = types.ModuleType("jax")
    value = health.allreduce_gbps(mesh, mib=mib, iters=iters)
    if broken and fault == "raise":
        raise RuntimeError(f"rank 1's call {call}")
    return value
