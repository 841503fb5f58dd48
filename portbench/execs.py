"""Exec readings: each reading is one fresh process that runs the port's
CLI, as the daemon execs ``python3 -m tpufd_torch health --extended``.

A workload file that gives ``"exec": [argv]`` in place of ``"entry"``
names:

  - ``exec``: the CLI's argv; ``env``: what the exec's environment adds
    to the harness's (which holds run.py's kernel and cache directories);
  - ``prefix`` and ``labels``: the labels the exec must publish, each by
    its leaf, with the probe's arguments (``kwargs``), the peak it is
    held to and its work in the reference (``work``);
  - ``label``: the program's timer and the label check's limits;
  - ``warm``: ``{"build": "module:attr"}``, called on a card to build the
    port's kernel libraries, so that no reading pays the compiler;
  - ``checks``: the output checks, each as a label cell's ``check``, run
    by the launcher in the exec's own process once the CLI has returned,
    on the program's modules as the exec left them (its environment, its
    loaded kernels and anything planted in it), with the run's seed.

Each reading starts ``portbench/exec_child.py`` (the launcher) in a
session of its own and waits for it to exit, at most the configuration's
``exec_timeout_s``: one that outlives it is killed with its process
group. The exec's wall time (`wall_s`) runs from its process start
(/proc/<pid>/stat, CLOCK_BOOTTIME, as run.py reads its own) to the moment
the harness saw it exit, less the seconds the launcher spent on the
output checks and, in a traced run, on starting and stopping the
profiler, each timed by the launcher. Its standard output is read as the daemon reads it, NFD
``key=value`` lines. A reading fails where the exec exits non-zero, is
killed, prints no ``ok=true``, lacks a label the workload names or gives
one that is no number, or writes no record.

The label check works each published label out again from the child's
timer calls for that probe: the last ``readings_per_label`` calls that
returned (the probe scheduler may retry a probe), each the reference's
work over the seconds the call returned, their median written as the
program writes a label (`label_text`). `label_recompute_gap` is the
relative gap between the published value and that writing, with one
allowance: where the median lies within ROUNDING (relative) of a
boundary of the writing (a whole number; below 10, the second
significant digit), the program's float arithmetic and the reference's
may land on either side of it, and a value that either side writes
reads 0.
"""

import contextlib
import json
import math
import os
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

from portbench import harness

CHILD = harness.BENCH / "exec_child.py"
ROUNDING = 1e-9
STDERR_TAIL = 2000


def process_start(pid):
    """The CLOCK_BOOTTIME second process `pid` began (/proc/<pid>/stat's
    starttime, in clock ticks since boot)."""
    with open(f"/proc/{pid}/stat") as f:
        fields = f.read().rpartition(")")[2].split()
    return int(fields[19]) / os.sysconf("SC_CLK_TCK")


def _boot_s():
    return time.clock_gettime(time.CLOCK_BOOTTIME)


def label_text(value):
    """A label value as tpufd_torch.health.health_labels writes it: whole
    numbers from 10 up, two significant digits below."""
    return str(int(value)) if value >= 10 else f"{value:.2g}"


def recompute_gap(published, values):
    """The relative gap between a published label and the median of the
    reference's `values`, written as the program writes a label; 0 where
    the median lies within ROUNDING of a boundary of the writing and the
    published value is the writing of either side."""
    median = statistics.median(values)
    sides = {label_text(median * (1 + s * ROUNDING)) for s in (-1, 0, 1)}
    if published in sides:
        return 0.0
    expected = float(label_text(median))
    if not expected:
        return math.inf
    return abs(float(published) - expected) / expected


def label_numbers(readings, workload, count):
    """The label check's numbers over the readings that did not fail:
    `label_recompute_gap`, the widest over every label the workload
    names, and `timer_gap` (harness.timer_gap), the widest over every
    timer call that returned. A label whose probe has fewer than `count`
    returned calls reads inf in both; so does a window with no sound
    reading."""
    recompute = timer = -math.inf
    for r in readings:
        if r["error"] is not None:
            continue
        calls = [c for c in r["timer"] if c["seconds"] and c["runs"]]
        for name, label in workload["labels"].items():
            done = [c for c in calls if c.get("probe") == name][-count:]
            if len(done) < count:
                return {"label_recompute_gap": math.inf, "timer_gap": math.inf}
            work = harness.resolve(label["work"])
            values = [work(label["kwargs"], c["iters"]) / c["seconds"]
                      for c in done]
            recompute = max(recompute, recompute_gap(r["exec"]["labels"][name],
                                                     values))
        for c in calls:
            timer = max(timer, harness.timer_gap(c))
    if recompute < 0:
        return {"label_recompute_gap": math.inf, "timer_gap": math.inf}
    return {"label_recompute_gap": recompute, "timer_gap": max(timer, 0.0)}


def _spent(child):
    """Seconds the launcher spent on the benchmark's own work: the output
    checks and the profiler's start and stop."""
    if not child:
        return 0.0
    return child["checks_s"] + child["trace_start_s"] + child["trace_stop_s"]


def wall_s(exec_record):
    """One exec's wall time: its process start to its exit as the harness
    saw it, less what `_spent` counts."""
    return (exec_record["ended"] - exec_record["started"]
            - _spent(exec_record["child"]))


def phases(exec_record):
    """(start-up, inside `probe` spans, between probes, wall) seconds of
    one exec, or None where its child wrote no record or no probe span.
    Each of the first three is measured on its own, so that their sum
    meets `wall_s` only where the child's spans are placed right:
      - start-up, from the process start to the first probe span's open,
        placed on CLOCK_BOOTTIME through the child's boot_offset_ns,
        less the profiler's start (before the CLI ran);
      - inside, the probe spans' own lengths;
      - between, the gaps between consecutive probe spans, the last
        span's close to the child's exit stamp (its perf_counter) less
        the profiler's stop and the output checks (after the CLI
        returned), and the exit stamp (its CLOCK_BOOTTIME) to the exit
        the harness saw: the record's write and the interpreter's exit.
    The sum less the wall is the error of the offset at the exit stamp."""
    child = exec_record["child"]
    if not child or child["dropped"]:
        return None
    probes = sorted((s for s in child["spans"]
                     if s["name"] == "probe" and s["parent"] is None),
                    key=lambda s: s["start_ns"])
    if not probes:
        return None
    first = (probes[0]["start_ns"] + child["boot_offset_ns"]) / 1e9
    startup = first - exec_record["started"] - child["trace_start_s"]
    inside = sum(s["end_ns"] - s["start_ns"] for s in probes) / 1e9
    gaps = sum(b["start_ns"] - a["end_ns"]
               for a, b in zip(probes, probes[1:])) / 1e9
    tail = ((child["exit_ns"] - probes[-1]["end_ns"]) / 1e9
            - child["trace_stop_s"] - child["checks_s"])
    exit_s = exec_record["ended"] - child["exit_boot_ns"] / 1e9
    return startup, inside, gaps + tail + exit_s, wall_s(exec_record)


def _parse(stdout):
    """NFD feature lines: key=value, one a line."""
    return dict(line.split("=", 1) for line in stdout.splitlines()
                if "=" in line)


def exec_once(workload, seed, device, timeout, trace, timer_calls):
    """One exec of the workload's argv through the launcher, which runs
    the workload's checks on `device` with `seed` after it. Returns its
    record (process start and exit, return code, the labels the workload
    names, the child's record) and the reading's error, None where it is
    sound; adds the child's timer calls to `timer_calls`."""
    tmp = Path(tempfile.mkdtemp(prefix="portbench_exec_"))
    try:
        out = tmp / "child.json"
        argv = [sys.executable, str(CHILD), "--out", str(out), "--timer",
                workload["label"]["timer"], "--trace", str(int(trace)),
                "--checks", json.dumps(workload["checks"]), "--seed",
                str(seed), "--device", str(device), "--", *workload["exec"]]
        env = dict(os.environ, **workload.get("env", {}))
        with open(tmp / "stderr", "w+") as err:
            proc = subprocess.Popen(argv, cwd=harness.ROOT, env=env,
                                    stdout=subprocess.PIPE, stderr=err,
                                    text=True, start_new_session=True)
            started = process_start(proc.pid)
            try:
                stdout, _ = proc.communicate(timeout=timeout)
                killed = False
            except subprocess.TimeoutExpired:
                os.killpg(proc.pid, signal.SIGKILL)
                stdout, _ = proc.communicate()
                killed = True
            ended = _boot_s()
            err.seek(0)
            stderr = err.read()
        child = harness.load_json(out) if out.exists() else None
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    published = _parse(stdout)
    prefix = workload["prefix"]
    labels = {name: published[prefix + name] for name in workload["labels"]
              if prefix + name in published}
    errors = []
    if killed:
        errors.append(f"killed after {timeout} s")
    elif proc.returncode != 0:
        errors.append(f"exited {proc.returncode}")
    if published.get(prefix + "ok") != "true":
        errors.append("printed no ok=true")
    missing = sorted(set(workload["labels"]) - set(labels))
    if missing:
        errors.append(f"printed no {', '.join(missing)}")
    for name, value in labels.items():
        try:
            float(value)
        except ValueError:
            errors.append(f"printed {name}={value!r}, no number")
    if child is None:
        errors.append("wrote no record")
    else:
        timer_calls.extend(child.pop("timer"))
    record = {"started": started, "ended": ended,
              "returncode": proc.returncode, "labels": labels,
              "child": child}
    if errors:
        sys.stderr.write(f"portbench: exec {' '.join(workload['exec'])}: "
                         f"{'; '.join(errors)}; its stderr ends:\n"
                         f"{stderr[-STDERR_TAIL:]}\n")
    return record, "; ".join(errors) or None


def _merge(summaries):
    """The children's trace summaries as one: busy and window seconds
    summed, the top device operations and idle gaps summed by name."""
    summaries = [s for s in summaries if s is not None]
    if not summaries:
        return None

    def top(key):
        sums = {}
        for s in summaries:
            for name, seconds in s[key]:
                sums[name] = sums.get(name, 0.0) + seconds
        return sorted(([n, v] for n, v in sums.items()),
                      key=lambda kv: -kv[1])[:10]

    return {"busy_s": sum(s["busy_s"] for s in summaries),
            "window_s": sum(s["window_s"] for s in summaries),
            "readings": sum(s["readings"] for s in summaries),
            "top_ops": top("top_ops"), "idle_gaps": top("idle_gaps")}


def check_numbers(readings, limits):
    """The output checks' numbers, each the worst over the window's
    execs as their launchers read them; inf where an exec has none."""
    numbers = dict.fromkeys(limits, -math.inf)
    for r in readings:
        got = (r["exec"]["child"] or {}).get("checks") or {}
        for key in limits:
            numbers[key] = harness._worst(numbers[key], got.get(key))
    return numbers


def run(spec, workload, seed, seconds, trace, device, peaks, process_start,
        beside):
    """run_cell for an exec workload: the warm-up, the closed-loop window
    of execs (each with its output checks) and the metrics. Returns what
    run_cell returns."""
    warm_s = time.perf_counter()
    if device.type == "cuda":
        harness.resolve(workload["warm"]["build"])()
    print(f"portbench: set-up: kernel libraries "
          f"{time.perf_counter() - warm_s:.3f} s", file=sys.stderr)
    timeout = spec["config"]["exec_timeout_s"]
    timer_calls, records = [], []

    def read():
        exec_record, error = exec_once(workload, seed, device, timeout, trace,
                                       timer_calls)
        records.append(exec_record)
        if error is not None:
            raise RuntimeError(error)
        return exec_record["ended"] - exec_record["started"]

    with beside():
        window_boot = _boot_s()
        readings = harness.closed_loop(read, seconds,
                                       contextlib.nullcontext, timer_calls)
    for reading, exec_record in zip(readings, records):
        reading["exec"] = exec_record
    children = [r["exec"]["child"] for r in readings if r["exec"]["child"]]
    memory_peak = max([c["memory_peak_bytes"] for c in children]
                      + [torch.cuda.max_memory_allocated(device)
                         if device.type == "cuda" else 0])

    limits = {key: limit for check in workload["checks"]
              for key, limit in check["limits"].items()}
    compared = {key: harness.within(value, limits[key]) for key, value
                in check_numbers(readings, limits).items()}
    label = workload["label"]
    for key, value in label_numbers(
            readings, workload,
            spec["config"]["readings_per_label"]).items():
        compared[key] = harness.within(value, label["limits"][key])
    over = [float(value) / peaks[workload["labels"][name]["peak"]]
            for r in readings if r["error"] is None
            for name, value in r["exec"]["labels"].items()]
    compared["label_over_peak"] = harness.within(
        max(over) if over else math.inf, 1.0)
    compared["failed_readings"] = harness.within(
        float(sum(r["error"] is not None for r in readings)), 0.0)
    # The child holds no module of JAX or of the JAX package.
    forbidden = sorted({m for c in children for m in c["forbidden"]})
    if forbidden:
        sys.stderr.write(f"portbench: an exec held {forbidden}, the JAX "
                         f"stack or the JAX package\n")
    compared["child_jax_modules"] = harness.within(float(len(forbidden)), 0.0)

    if trace:
        for r in readings:
            split = phases(r["exec"])
            if split is not None:
                print(f"portbench: exec phases: start-up {split[0]:.3f} s, "
                      f"probes {split[1]:.3f} s, between {split[2]:.3f} s, "
                      f"their sum {100 * sum(split[:3]) / split[3]:.3f}% of "
                      f"the wall {split[3]:.3f} s", file=sys.stderr)
    trace_summary = _merge([c["trace"] for c in children]) if trace else None
    record = {
        "workload": workload, "config": spec["config"], "peaks": peaks,
        "readings": readings, "trace": trace_summary, "spans": {},
        "setup_s": (window_boot - process_start
                    if process_start is not None else None),
    }
    per_layer = {m["name"]: harness.metric_module(m["name"])
                 for m in spec["per_layer"]} if trace else {}
    result = harness.result_line(spec, trace, record, per_layer, compared,
                                 device, memory_peak)
    return result, readings, trace_summary
