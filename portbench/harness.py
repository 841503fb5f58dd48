"""One run of one cell: set-up, the closed-loop window of label readings,
the output check, and the metrics, all found by name.

Everything that belongs to one cell, configuration or metric is a file of
its own, found by the name ``BENCHMARK.json`` gives it:

  - ``portbench/workloads/<cell>.json``: the probe entry the window drives,
    its arguments, the peak its label is held to, the warm-up call, the
    program's timer and the label's work in the reference, and the output
    check;
  - ``portbench/configs/<config>.json``: the deployment's sizes;
  - ``portbench/metrics/<metric>.py``: ``read(record)``, the metric's
    value from the run's record, or None when it finds nothing to read;
  - ``portbench/checks/<module>.py``: ``run`` and ``control``, the numbers
    of the program's output that decide ``correct``, each against the
    plain reference in ``portbench/reference/``; ``FAULTS``, where there
    are any, plants the faults the check has to catch.

Each reading's label is checked too: worked out again from the probe's
sizes and the seconds the program's timer returned, and the timer's
seconds held to the host clock's least over the timer's own runs.

Of the program it imports only ``tpufd_torch``, through the names the
workload file gives.
"""

import contextlib
import gc
import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

import torch

from portbench import trace as trace_lib

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "tpufd")


def load_json(path):
    with open(path) as f:
        return json.load(f)


def resolve(target):
    """The object a "module:attr" name points at."""
    module, _, attr = target.partition(":")
    return getattr(importlib.import_module(module), attr)


def load_file_module(path, name):
    """A module loaded from a file under portbench/ (metric and check
    names may hold dots, so they are not imported by package name)."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _applies(metric, cell):
    return cell in metric.get("workloads", [cell])


def cell_spec(name):
    """What one cell runs: its manifest entry, workload and configuration
    files, and the metrics BENCHMARK.json gives it."""
    manifest = load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                       f"known: {sorted(cells)}")
    cell = cells[name]
    config = {c["name"]: c for c in manifest["configs"]}[cell["config"]]
    return {
        "cell": cell,
        "workload": load_json(BENCH / "workloads" / f"{name}.json"),
        "config": load_json(ROOT / config["file"]),
        "end_to_end": [m for m in manifest["end_to_end"]
                       if _applies(m, name)],
        "per_layer": [m for m in manifest["per_layer"]
                      if _applies(m, name)],
    }


def metric_module(name):
    return load_file_module(BENCH / "metrics" / f"{name}.py",
                            f"portbench_metric_{name}")


def check_module(name):
    return load_file_module(BENCH / "checks" / f"{name}.py",
                            f"portbench_check_{name}")


def card_peaks(kind):
    """The frozen data-sheet peaks of a card, by its CUDA name."""
    table = load_json(BENCH / "peaks.json")
    if kind not in table:
        raise KeyError(f"no data-sheet peaks for {kind!r} in "
                       f"portbench/peaks.json")
    return table[kind]


def forbidden_modules():
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted({m.partition(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def warm(workload, device):
    """One iteration of the probe body at the cell's sizes: loads (on a
    checkout's first run, builds) the kernel libraries and makes the
    library handles and buffers the readings use."""
    spec = workload["warm"]
    fn = resolve(spec["factory"])(device, **spec["kwargs"])
    fn(spec["n"], 0.125)
    _sync(device)


def closed_loop(read, seconds, mark, timer_calls):
    """Readings back to back, each after the last, until `seconds` have
    passed since the first began; the reading under way then runs to its
    end. Each reading's start and end are seconds from the first's
    start; its "timer" holds the timer calls recorded into `timer_calls`
    while it ran."""
    readings = []
    t0 = time.perf_counter()
    while True:
        start, first_call = time.perf_counter(), len(timer_calls)
        with mark():
            try:
                value, error = float(read()), None
            except Exception as e:  # noqa: BLE001 -- a raised reading is
                # counted as failed and its time stays in the window.
                value, error = None, f"{type(e).__name__}: {e}"
        end = time.perf_counter()
        readings.append({"start": start - t0, "end": end - t0,
                         "value": value, "error": error,
                         "timer": timer_calls[first_call:]})
        if end - t0 >= seconds:
            return readings


@contextlib.contextmanager
def recording_timer(target, calls):
    """Records into `calls` each call of the program's differential timer
    `target` ("module:attr", called as timer(fn, iters, ...), where
    fn(n, salt) runs n loop iterations): its iters; its runs, [n, the
    second the run's fn call began] each, seconds from the call's start;
    its wall seconds; and the seconds it returned (None where it
    raised)."""
    module_name, _, attr = target.partition(":")
    module = importlib.import_module(module_name)
    original = getattr(module, attr)

    def timer(fn, iters, *args, **kwargs):
        call = {"iters": iters, "runs": [], "wall_s": None, "seconds": None}
        calls.append(call)
        start = time.perf_counter()

        def counted(n, salt):
            call["runs"].append([n, time.perf_counter() - start])
            return fn(n, salt)

        try:
            call["seconds"] = original(counted, iters, *args, **kwargs)
        finally:
            call["wall_s"] = time.perf_counter() - start
        return call["seconds"]

    setattr(module, attr, timer)
    try:
        yield calls
    finally:
        setattr(module, attr, original)


def least_s_per_iteration(call):
    """The least host-clock seconds per loop iteration over a timer call's
    runs of the most iterations: a run lasts from its fn call's start to
    the next run's start (the last, to the call's end), so it holds the
    program's own timing of that run and its fetch. A host stall only
    lengthens a run, and a sound per-iteration time lies under this least
    one by the run's fixed cost over its iterations."""
    runs = call["runs"]
    ends = [s for _, s in runs[1:]] + [call["wall_s"]]
    most = max(n for n, _ in runs)
    return min((end - s) / n for (n, s), end in zip(runs, ends) if n == most)


def label_numbers(readings, label, kwargs):
    """The label check's numbers over the readings that returned a label:
    `label_recompute_gap`, the widest gap between a label and the one
    the reference works out from the probe's sizes and the seconds the
    timer returned; `timer_gap`, the widest share by which the timer's
    seconds per iteration fall short of the host clock's least over the
    timer's own runs (a label can claim no more than the card did in the
    host's clock; a label that claims less is held by `label_peak_pct`'s
    bound). A label that no single timer call produced reads inf in both;
    so does a window with no label."""
    work = resolve(label["work"])
    recompute = timer = -math.inf
    for r in readings:
        if r["value"] is None:
            continue
        calls = r["timer"]
        if (len(calls) != 1 or not calls[0]["seconds"]
                or not calls[0]["runs"]):
            return {"label_recompute_gap": math.inf, "timer_gap": math.inf}
        c = calls[0]
        expected = work(kwargs, c["iters"]) / c["seconds"]
        recompute = max(recompute, abs(r["value"] - expected) / expected)
        timer = max(timer, 1.0 - (c["seconds"] / c["iters"])
                    / least_s_per_iteration(c), 0.0)
    if recompute < 0:
        return {"label_recompute_gap": math.inf, "timer_gap": math.inf}
    return {"label_recompute_gap": recompute, "timer_gap": timer}


class _Spans:
    """Records the calls of the program functions the cell's per-layer
    metrics name (their SPANS), for the traced run only."""

    def __init__(self, metrics):
        self.wanted = {}
        for m in metrics:
            for target, describe in getattr(m, "SPANS", {}).items():
                self.wanted.setdefault(target, []).append(describe)
        self.calls = {target: [] for target in self.wanted}
        self._saved = []

    def __enter__(self):
        for target, describers in self.wanted.items():
            module_name, _, attr = target.partition(":")
            module = importlib.import_module(module_name)
            original = getattr(module, attr)
            calls = self.calls[target]

            def wrapper(*args, _original=original, _calls=calls,
                        _describers=describers, **kwargs):
                call = {}
                for describe in _describers:
                    call.update(describe(*args, **kwargs))
                _calls.append(call)
                return _original(*args, **kwargs)

            self._saved.append((module, attr, original))
            setattr(module, attr, wrapper)
        return self

    def __exit__(self, *exc):
        for module, attr, original in reversed(self._saved):
            setattr(module, attr, original)
        self._saved.clear()
        return False


def _number(value, limit):
    """A compared number passes when it is finite and within its limit."""
    return {"value": value, "limit": limit,
            "ok": value is not None and math.isfinite(value)
            and value <= limit}


def run_cell(name, seed, seconds, trace, device, overrides=None, peaks=None,
             process_start=None, beside=contextlib.nullcontext):
    """Runs cell `name` on `device`.

    `overrides` replaces keys of the workload file (the CPU tests shrink
    the sizes with it), `peaks` the card's data-sheet row,
    `process_start` is the CLOCK_BOOTTIME second the process began, and
    `beside()` a context held around the window alone (run.py samples
    nvidia-smi in it). Returns (the result line's object, the readings,
    the trace's summary or None)."""
    spec = cell_spec(name)
    workload = dict(spec["workload"], **(overrides or {}))
    if workload["reader"] != {"loop": "closed", "readers": 1}:
        raise ValueError(f"{name}: the harness runs one closed-loop reader, "
                         f"not {workload['reader']}")
    if peaks is None:
        peaks = card_peaks(torch.cuda.get_device_name(device))
    peak = peaks[workload["peak"]]
    per_layer = {m["name"]: metric_module(m["name"])
                 for m in spec["per_layer"]} if trace else {}

    warm_s = time.perf_counter()
    warm(workload, device)
    print(f"portbench: set-up: warm-up iteration (and kernel libraries) "
          f"{time.perf_counter() - warm_s:.3f} s", file=sys.stderr)
    entry = resolve(workload["entry"])
    kwargs = workload["kwargs"]
    spans = _Spans(per_layer.values())
    timer_calls = []
    with contextlib.ExitStack() as stack:
        if trace:
            profiler = stack.enter_context(trace_lib.profiler(device))
            stack.enter_context(spans)
        stack.enter_context(recording_timer(workload["label"]["timer"],
                                            timer_calls))
        stack.enter_context(beside())
        window_boot = time.clock_gettime(time.CLOCK_BOOTTIME)
        readings = closed_loop(lambda: entry(device, **kwargs), seconds,
                               trace_lib.mark if trace
                               else contextlib.nullcontext, timer_calls)
        _sync(device)
    trace_summary = trace_lib.reduce(profiler) if trace else None
    profiler = None  # frees the trace before the check runs
    memory_peak = (torch.cuda.max_memory_allocated(device)
                   if device.type == "cuda" else 0)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    check_spec = workload["check"]
    checker = check_module(check_spec["module"])
    try:
        numbers = checker.run(check_spec, seed, device,
                              resolve(check_spec["body"]))
    except Exception as e:  # noqa: BLE001 -- a body that raises is wrong
        print(f"check {check_spec['module']} raised: "
              f"{type(e).__name__}: {e}", file=sys.stderr)
        numbers = {key: math.inf for key in check_spec["limits"]}
    compared = {key: _number(numbers.get(key), limit)
                for key, limit in check_spec["limits"].items()}
    labels = [r["value"] for r in readings if r["value"] is not None]
    failed = sum(r["error"] is not None for r in readings)
    label = workload["label"]
    for key, value in label_numbers(readings, label, kwargs).items():
        compared[key] = _number(value, label["limits"][key])
    # Every label the window published, against the card's data sheet.
    compared["label_over_peak"] = _number(
        max(labels) / peak if labels else math.inf, 1.0)
    compared["failed_readings"] = _number(float(failed), 0.0)

    record = {
        "workload": workload, "config": spec["config"], "peaks": peaks,
        "peak": peak, "readings": readings, "trace": trace_summary,
        "spans": spans.calls,
        "setup_s": (window_boot - process_start
                    if process_start is not None else None),
    }
    wanted = spec["per_layer"] if trace else spec["end_to_end"]
    readers = per_layer if trace else {m["name"]: metric_module(m["name"])
                                       for m in wanted}
    metrics = {}
    for m in wanted:
        value = readers[m["name"]].read(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    device_info = {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "kind": (torch.cuda.get_device_name(device)
                 if device.type == "cuda" else "cpu"),
        "count": (torch.cuda.device_count()
                  if device.type == "cuda" else 1),
        "memory_peak_bytes": memory_peak,
    }
    result = {
        "correct": all(c["ok"] for c in compared.values()),
        "attempted": len(readings), "failed": failed,
        "metrics": metrics, "device": device_info,
    }
    if trace_summary is not None:
        device_info["busy_s"] = trace_summary["busy_s"]
        device_info["window_s"] = trace_summary["window_s"]
        result["breakdown"] = {"device_ops": trace_summary["top_ops"],
                               "idle_gaps": trace_summary["idle_gaps"]}
    result["checks"] = {key: {"value": c["value"], "limit": c["limit"]}
                        for key, c in compared.items()}
    return result, readings, trace_summary

