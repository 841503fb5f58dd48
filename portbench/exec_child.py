"""One exec reading's process: a fresh interpreter that runs the port's
CLI, the code ``python3 -m tpufd_torch`` runs, with the program's timer
recorded, then the cell's output checks on the kernels it loaded.

    python3 portbench/exec_child.py --out <file> \
        --timer tpufd_torch.health:_time_iters --trace 0 \
        --checks '<JSON list>' --seed 7 --device cuda:0 -- health --extended

It installs harness.recording_timer on the timer, each call tagged with
the probe whose ``probe`` span is open, calls tpufd_torch.__main__.main
with the argv after ``--`` and exits with its return code (1 where it
raises). Where main returns, it reads ``torch.cuda.max_memory_allocated``
and then runs each of ``--checks`` (harness.output_check, on ``--device``
with ``--seed``) in this process, on the program's modules as the exec
left them, and times them. On the way out it stamps its exit on both
clocks and writes to ``--out`` (JSON): the timer calls; the program's
``probe``, ``timer``, ``timer.step`` and ``timer.run`` spans, with the
spans the ring dropped and the offset from their perf_counter stamps to
CLOCK_BOOTTIME; the memory peak; the checks' numbers and seconds; the
loaded modules of JAX or the JAX package; and with ``--trace 1`` the
summary of a torch.profiler trace over the CLI's run (portbench.trace)
with the seconds the profiler took to start and to stop. It dies with the
process that started it.
"""

import argparse
import contextlib
import ctypes
import json
import math
import os
import signal
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SPANS = ("probe", "timer", "timer.step", "timer.run")


def _boot_ns():
    return time.clock_gettime_ns(time.CLOCK_BOOTTIME)


def boot_offset_ns():
    """CLOCK_BOOTTIME ns minus perf_counter_ns, from the closest together
    of five readings of the pair."""
    best = None
    for _ in range(5):
        before = time.perf_counter_ns()
        boot = _boot_ns()
        after = time.perf_counter_ns()
        if best is None or after - before < best[0]:
            best = (after - before, boot - (before + after) // 2)
    return best[1]


def memory_peak(torch):
    return (torch.cuda.max_memory_allocated()
            if torch.cuda.is_initialized() else 0)


def run_checks(checks, seed, device):
    """Each output check's numbers, the worst where two name one."""
    from portbench import harness

    numbers = {}
    for check in checks:
        for key, value in harness.output_check(check, seed, device).items():
            numbers[key] = harness._worst(numbers.get(key, -math.inf), value)
    return numbers


def main(argv=None):
    ctypes.CDLL(None).prctl(1, signal.SIGKILL)  # PR_SET_PDEATHSIG
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", required=True)
    parser.add_argument("--timer", required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    parser.add_argument("--checks", default="[]")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cpu")
    parser.add_argument("cli", nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)
    cli_argv = args.cli[1:] if args.cli[:1] == ["--"] else args.cli
    sys.path[:] = [str(ROOT)] + [p for p in sys.path
                                 if Path(p or ".").resolve()
                                 != ROOT / "portbench"]

    import torch

    from portbench import harness
    from tpufd_torch import spans
    from tpufd_torch.__main__ import main as cli

    recorder = spans.default_recorder()

    def probe():
        request = recorder.current_request()
        return {"probe": request.attrs.get("probe")
                if request is not None and request.name == "probe" else None}

    calls = []
    record = {"trace": None, "trace_start_s": 0.0, "trace_stop_s": 0.0,
              "checks": None, "checks_s": 0.0, "memory_peak_bytes": None}
    code = 1
    try:
        with harness.recording_timer(args.timer, calls, tag=probe):
            if args.trace:
                from portbench import trace as trace_lib
                start = _boot_ns()
                profiler = trace_lib.profiler(torch.device(
                    "cuda" if torch.cuda.is_available() else "cpu"))
                profiler.start()
                record["trace_start_s"] = (_boot_ns() - start) / 1e9
            try:
                with (trace_lib.mark() if args.trace
                      else contextlib.nullcontext()):
                    code = cli(cli_argv)
            finally:
                if args.trace:
                    stop = _boot_ns()
                    profiler.stop()
                    summary = trace_lib.reduce(profiler)
                    if summary is not None:
                        del summary["device_ops"]
                    record["trace"] = summary
                    record["trace_stop_s"] = (_boot_ns() - stop) / 1e9
        record["memory_peak_bytes"] = memory_peak(torch)
        start = _boot_ns()
        record["checks"] = run_checks(json.loads(args.checks), args.seed,
                                      torch.device(args.device))
        record["checks_s"] = (_boot_ns() - start) / 1e9
    finally:
        if record["memory_peak_bytes"] is None:
            record["memory_peak_bytes"] = memory_peak(torch)
        record.update(
            timer=calls,
            spans=[{"name": s.name, "start_ns": s.start_ns,
                    "end_ns": s.end_ns, "id": s.id, "parent": s.parent,
                    "request": s.request, "attrs": s.attrs}
                   for s in list(recorder.spans) if s.name in SPANS],
            dropped=recorder.dropped,
            boot_offset_ns=boot_offset_ns(),
            forbidden=harness.forbidden_modules(),
            exit_ns=time.perf_counter_ns(), exit_boot_ns=_boot_ns())
        tmp = f"{args.out}.tmp"
        with open(tmp, "w") as f:
            json.dump(record, f, default=repr)
        os.replace(tmp, args.out)
    return code


if __name__ == "__main__":
    sys.exit(main())
