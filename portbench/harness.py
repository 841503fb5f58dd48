"""One run of one cell: set-up, the closed-loop window of label readings,
the output check, and the metrics, all found by name.

Everything that belongs to one cell, configuration or metric is a file of
its own, found by the name ``BENCHMARK.json`` gives it:

  - ``portbench/workloads/<cell>.json``: the probe entry the window drives,
    its arguments, the peak its label is held to, the warm-up call, the
    program's timer and the label's work in the reference, and the output
    check; or, in place of the entry, the argv of the program's CLI that
    each reading execs in a fresh process (``portbench/execs.py``), with
    the labels it must publish and a list of output checks;
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

A cell of k > 1 chips runs over k ranks of one process group, one
process per card (`_RankGroup`): the calling process is rank 0 on its
device, and every rank runs the same warm-up, window and output check
in lockstep. k = 1 runs in the calling process alone, with no group.

Of the program it imports only ``tpufd_torch``, through the names the
workload file gives.
"""

import contextlib
import ctypes
import datetime
import gc
import importlib
import importlib.util
import json
import math
import multiprocessing
import multiprocessing.connection
import os
import queue
import shutil
import signal
import sys
import tempfile
import threading
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist

from portbench import trace as trace_lib

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "tpufd")
# A cell over several ranks: every rank has joined the group and warmed up
# within SETUP_LIMIT_S of the spawn, and has read its last reading and run
# its output check within PAST_WINDOW_S of the window's close. A rank that
# dies, raises outside a reading or misses either limit ends the run.
SETUP_LIMIT_S = 240
PAST_WINDOW_S = 100
RANK_FAULT_EXIT = 4


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
    """The output check `checks/<name>.py`; a dotted name is imported as a
    module (the tests' stub checks)."""
    if "." in name:
        return importlib.import_module(name)
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


def warm(workload, device, target):
    """The warm-up at the cell's sizes: loads (on a checkout's first run,
    builds) the kernel libraries and makes the library handles and
    buffers the readings use. A "warm" of {"factory", "kwargs", "n"} runs
    one iteration of the probe body; "entry" runs one call of the entry
    on `target` (the device, or the cell's mesh) at the workload's
    kwargs, for an entry with no body factory."""
    spec = workload["warm"]
    if spec == "entry":
        float(resolve(workload["entry"])(target, **workload["kwargs"]))
    else:
        fn = resolve(spec["factory"])(device, **spec["kwargs"])
        fn(spec["n"], 0.125)
    _sync(device)


def closed_loop(read, seconds, mark, timer_calls, after=None):
    """Readings back to back, each after the last, until `seconds` have
    passed since the first began; the reading under way then runs to its
    end. Each reading's start and end are seconds from the first's
    start; its "timer" holds the timer calls recorded into `timer_calls`
    while it ran. `after(reading, more)`, where given, runs after each
    reading, outside its mark, with whether the window goes on."""
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
        more = end - t0 < seconds
        if after is not None:
            after(readings[-1], more)
        if not more:
            return readings


@contextlib.contextmanager
def recording_timer(target, calls, tag=None):
    """Records into `calls` each call of the program's differential timer
    `target` ("module:attr", called as timer(fn, iters, ...), where
    fn(n, salt) runs n loop iterations): its iters; its runs, [n, the
    second the run's fn call began] each, seconds from the call's start;
    its wall seconds; the seconds it returned (None where it raised);
    and what `tag()`, where given, returns as the call begins."""
    module_name, _, attr = target.partition(":")
    module = importlib.import_module(module_name)
    original = getattr(module, attr)

    def timer(fn, iters, *args, **kwargs):
        call = {"iters": iters, "runs": [], "wall_s": None, "seconds": None,
                **(tag() if tag is not None else {})}
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


def label_numbers(readings, label, kwargs, ranks=1):
    """The label check's numbers over the readings that returned a label:
    `label_recompute_gap`, the widest gap between a label and the one
    the reference works out from the probe's sizes, the number of ranks
    and the seconds the timer returned; `timer_gap`, the widest share by
    which the timer's seconds per iteration fall short of the host
    clock's least over the timer's own runs (a label can claim no more
    than the card did in the host's clock; a label that claims less is
    held by `label_peak_pct`'s bound). A label that no single timer call
    produced reads inf in both; so does a window with no label."""
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
        expected = work(kwargs, c["iters"], ranks=ranks) / c["seconds"]
        recompute = max(recompute, abs(r["value"] - expected) / expected)
        timer = max(timer, timer_gap(c))
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


def within(value, limit):
    """A compared number passes when it is finite and within its limit."""
    return {"value": value, "limit": limit,
            "ok": value is not None and math.isfinite(value)
            and value <= limit}


def _worst(value, other):
    """The worse of two compared numbers (no number, or NaN, is inf)."""
    def finite_or_inf(v):
        return math.inf if v is None or v != v else v
    return max(finite_or_inf(value), finite_or_inf(other))


def timer_gap(call):
    """The share by which a timer call's seconds per iteration fall short
    of the host clock's least over its runs of most iterations."""
    return max(1.0 - (call["seconds"] / call["iters"])
               / least_s_per_iteration(call), 0.0)


def output_check(check_spec, seed, device):
    """The output check's numbers on this process's device: the check
    module's run on the program's body, or inf for each number where it
    raises (a body that raises is wrong)."""
    checker = check_module(check_spec["module"])
    try:
        return checker.run(check_spec, seed, device,
                           resolve(check_spec["body"]))
    except Exception as e:  # noqa: BLE001 -- a body that raises is wrong
        print(f"check {check_spec['module']} raised: "
              f"{type(e).__name__}: {e}", file=sys.stderr)
        return {key: math.inf for key in check_spec["limits"]}


def _entry_target(workload, device):
    """What the entry takes first: the device, or, where the workload
    names a mesh axis ("mesh"), a one-axis DeviceMesh over the process
    group, as the program's rank bodies build it."""
    axis = workload.get("mesh")
    if axis is None:
        return device
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device.type, (dist.get_world_size(),),
                            mesh_dim_names=(axis,))


def _join_group(rank, world, device, store_path):
    """Joins the cell's process group: NCCL on a card, gloo on the host;
    rendezvous through a FileStore, no TCP port."""
    options = ({"backend": "nccl", "device_id": device}
               if device.type == "cuda" else {"backend": "gloo"})
    dist.init_process_group(
        store=dist.FileStore(store_path, world), rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=SETUP_LIMIT_S), **options)


class RankFault(RuntimeError):
    """A rank of a cell's process group broke the run outside a reading."""


def _rank_main(rank, world, device_type, store_path, workload, seed, conn):
    """Rank `rank` (1 .. world - 1) of a cell: joins the group on
    cuda:rank (gloo on the host, with the cards hidden), warms up, makes
    a reading each time rank 0 says "go", runs the output check once it
    says "stop", and reports each step to rank 0 over `conn`: ("step", 0,
    None) when ready, ("step", i, error) after reading i, then ("done",
    numbers, memory peak, forbidden modules, readings made); ("raised",
    traceback) for an exception outside a reading."""
    # The rank dies with rank 0: none is left behind when rank 0 is killed.
    ctypes.CDLL(None).prctl(1, signal.SIGKILL)  # PR_SET_PDEATHSIG
    try:
        if device_type == "cuda":
            device = torch.device("cuda", rank)
            torch.cuda.set_device(device)
        else:
            os.environ["CUDA_VISIBLE_DEVICES"] = ""
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
            device = torch.device("cpu")
        _join_group(rank, world, device, store_path)
        target = _entry_target(workload, device)
        warm(workload, device, target)
        conn.send(("step", 0, None))
        entry, kwargs = resolve(workload["entry"]), workload["kwargs"]
        made = 0
        while conn.recv() == "go":
            made += 1
            try:
                float(entry(target, **kwargs))
                error = None
            except Exception as e:  # noqa: BLE001 -- reported to rank 0
                error = f"{type(e).__name__}: {e}"
            conn.send(("step", made, error))
        _sync(device)
        memory_peak = (torch.cuda.max_memory_allocated(device)
                       if device.type == "cuda" else 0)
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        numbers = output_check(workload["check"], seed, device)
        conn.send(("done", numbers, memory_peak, forbidden_modules(), made))
        dist.destroy_process_group()
    except Exception:  # noqa: BLE001 -- reported to rank 0, which ends
        # the run naming this rank.
        with contextlib.suppress(OSError):
            conn.send(("raised", traceback.format_exc()))
        sys.exit(1)


class _RankGroup:
    """Ranks 1 .. k - 1 of a cell's process group, each in a process of
    its own started with the spawn method, and rank 0, the calling
    process, joined with them.

    A watchdog thread is the only reader of the ranks' pipes. It ends the
    process (exit RANK_FAULT_EXIT, the rank named on stderr, every rank
    killed) when a rank raises outside a reading, exits before its output
    check has reported, or has not finished the step rank 0 is in by the
    deadline: set-up within SETUP_LIMIT_S of the spawn, every later step
    within PAST_WINDOW_S of the window's close. Rank 0's main thread may
    then be waiting in a collective that would never return."""

    def __init__(self, world, device, workload, seed):
        self.world = world
        self.tmp = tempfile.mkdtemp(prefix="portbench_ranks_")
        store_path = os.path.join(self.tmp, "store")
        ctx = multiprocessing.get_context("spawn")
        self.procs, self.conns = {}, {}
        self.inbox = {rank: queue.Queue() for rank in range(1, world)}
        self.progress = {rank: -1 for rank in range(1, world)}
        self.step, self.what = 0, "set-up"
        self.deadline = time.monotonic() + SETUP_LIMIT_S
        self.closing = threading.Event()
        for rank in range(1, world):
            ours, theirs = ctx.Pipe()
            self.procs[rank] = ctx.Process(
                target=_rank_main, daemon=True,
                args=(rank, world, device.type, store_path, workload, seed,
                      theirs))
            self.conns[rank] = ours
            self.procs[rank].start()
            theirs.close()
        self.watchdog = threading.Thread(target=self._watch, daemon=True)
        self.watchdog.start()
        try:
            _join_group(0, world, device, store_path)
        except BaseException:
            self.close(kill=True)
            raise

    def _fault(self, ranks, why):
        if self.closing.is_set():
            return
        names = ", ".join(str(rank) for rank in ranks)
        sys.stderr.write(f"portbench: rank{'s' * (len(ranks) > 1)} {names} "
                         f"of {self.world} {why}\n")
        sys.stderr.flush()
        for proc in self.procs.values():
            proc.kill()
        for proc in self.procs.values():
            proc.join(timeout=5)
        os._exit(RANK_FAULT_EXIT)

    def _receive(self, rank):
        try:
            message = self.conns[rank].recv()
        except (EOFError, OSError):
            return False
        if message[0] == "raised":
            self._fault([rank], f"raised outside a reading:\n{message[1]}")
        self.progress[rank] = (message[1] if message[0] == "step"
                               else math.inf)
        self.inbox[rank].put(message)
        return True

    def _watch(self):
        conns = {conn: rank for rank, conn in self.conns.items()}
        ended = {p.sentinel: rank for rank, p in self.procs.items()}
        while not self.closing.is_set():
            ready = multiprocessing.connection.wait(
                list(conns) + list(ended), timeout=0.5)
            for obj in ready:
                if obj in conns and not self._receive(conns[obj]):
                    del conns[obj]
            for obj in ready:
                if obj not in ended:
                    continue
                rank = ended.pop(obj)
                conn = self.conns[rank]
                while conn in conns and conn.poll() and self._receive(rank):
                    pass
                if self.progress[rank] != math.inf:
                    self.procs[rank].join(timeout=5)  # reaps its exit code
                    self._fault([rank], f"exited with code "
                                      f"{self.procs[rank].exitcode} before "
                                      f"its output check reported")
            if time.monotonic() > self.deadline:
                late = [r for r, done in self.progress.items()
                        if done < self.step] or [0]
                limit = (f"{SETUP_LIMIT_S} s from the spawn" if self.step == 0
                         else f"{PAST_WINDOW_S} s past the window's close")
                self._fault(late, f"did not finish {self.what} within "
                                  f"{limit}")

    def _await(self, rank, kind):
        message = self.inbox[rank].get()
        if message[0] != kind:
            raise RankFault(f"rank {rank} of {self.world} sent {message[0]} "
                            f"where rank 0 waited for {kind}")
        return message[1:]

    def ready(self):
        """Waits until every rank has joined and warmed up."""
        for rank in self.inbox:
            self._await(rank, "step")

    def begin(self, seconds):
        """Starts the window's first reading on every rank."""
        self.deadline = time.monotonic() + seconds + PAST_WINDOW_S
        self._next(True)

    def _next(self, more):
        self.step += 1 if more else math.inf
        self.what = (f"reading {self.step}" if more
                     else "its last reading and output check")
        for conn in self.conns.values():
            conn.send("go" if more else "stop")

    def after_reading(self, reading, more):
        """Rank 0's reading is done: waits for every rank's, marks the
        reading failed where one raised, and tells every rank whether
        the window goes on."""
        errors = {rank: self._await(rank, "step")[1] for rank in self.inbox}
        reading["ranks"] = errors
        raised = [f"rank {rank}: {error}" for rank, error in errors.items()
                  if error is not None]
        if raised:
            reading["value"] = None
            reading["error"] = "; ".join(
                ([reading["error"]] if reading["error"] else []) + raised)
        self._next(more)

    def finish(self, readings):
        """Every rank's (numbers, memory peak, forbidden modules) once
        its output check is done; raises RankFault where a rank made
        another number of readings than rank 0's `readings`."""
        out = {}
        for rank in self.inbox:
            numbers, memory_peak, forbidden, made = self._await(rank, "done")
            if made != readings:
                raise RankFault(f"rank {rank} of {self.world} made {made} "
                                f"readings, rank 0 {readings}")
            out[rank] = (numbers, memory_peak, forbidden)
        self.deadline = math.inf
        return out

    def close(self, kill=False):
        """Leaves the group and stops every rank's process: at once with
        `kill` (rank 0 failed, and the ranks may wait in a collective),
        else once each has left the group."""
        self.closing.set()
        if dist.is_initialized():
            dist.destroy_process_group()
        for proc in self.procs.values():
            if not kill:
                proc.join(timeout=30)
            if proc.is_alive():
                proc.kill()
            proc.join()
        self.watchdog.join()
        for conn in self.conns.values():
            conn.close()
        shutil.rmtree(self.tmp, ignore_errors=True)


def run_cell(name, seed, seconds, trace, device, overrides=None, peaks=None,
             process_start=None, beside=contextlib.nullcontext, spec=None,
             ranks=None):
    """Runs cell `name` on `device`.

    `overrides` replaces keys of the workload file (the CPU tests shrink
    the sizes with it), `peaks` the card's data-sheet row,
    `process_start` is the CLOCK_BOOTTIME second the process began, and
    `beside()` a context held around the window alone (run.py samples
    nvidia-smi in it). `spec` replaces the cell's entry, files and
    metrics (cell_spec's form; the tests' cells of their own). A cell of
    k > 1 chips runs over k ranks of a process group, this process rank 0
    on `device` (`_RankGroup`); `ranks` forces a group of that many (the
    tests force one of 1). A workload that names an "exec" runs its
    readings as fresh processes of the program's CLI (`execs.run`).
    Returns (the result line's object, the readings, the trace's summary
    or None)."""
    spec = spec or cell_spec(name)
    workload = dict(spec["workload"], **(overrides or {}))
    if workload["reader"] != {"loop": "closed", "readers": 1}:
        raise ValueError(f"{name}: the harness runs one closed-loop reader, "
                         f"not {workload['reader']}")
    if peaks is None:
        peaks = card_peaks(torch.cuda.get_device_name(device))
    if "exec" in workload:
        from portbench import execs
        return execs.run(spec, workload, seed, seconds, trace, device, peaks,
                         process_start, beside)
    peak = peaks[workload["peak"]]
    per_layer = {m["name"]: metric_module(m["name"])
                 for m in spec["per_layer"]} if trace else {}
    world = spec["cell"]["chips"] if ranks is None else ranks
    group = None
    if ranks is not None or world > 1:
        group = _RankGroup(world, device, workload, seed)
    try:
        result = _run(spec, workload, seed, seconds, trace, device, peaks,
                      peak, per_layer, process_start, beside, group)
    except BaseException:
        if group is not None:
            group.close(kill=True)
        raise
    if group is not None:
        group.close()
    return result


def _run(spec, workload, seed, seconds, trace, device, peaks, peak,
         per_layer, process_start, beside, group):
    """run_cell's set-up, window, check and metrics, on rank 0 where
    `group` holds the other ranks."""
    target = device if group is None else _entry_target(workload, device)
    warm_s = time.perf_counter()
    warm(workload, device, target)
    if group is not None:
        group.ready()
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
        if group is not None:
            group.begin(seconds)
        readings = closed_loop(lambda: entry(target, **kwargs), seconds,
                               trace_lib.mark if trace
                               else contextlib.nullcontext, timer_calls,
                               None if group is None else group.after_reading)
        _sync(device)
    trace_summary = trace_lib.reduce(profiler) if trace else None
    profiler = None  # frees the trace before the check runs
    memory_peak = (torch.cuda.max_memory_allocated(device)
                   if device.type == "cuda" else 0)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    check_spec = workload["check"]
    numbers = output_check(check_spec, seed, device)
    if group is not None:
        for rank, (theirs, their_peak, forbidden) in group.finish(
                len(readings)).items():
            if forbidden:
                raise RankFault(f"rank {rank} of {group.world} holds "
                                f"{forbidden}, the JAX stack or the JAX "
                                f"package")
            numbers = {key: _worst(numbers.get(key), theirs.get(key))
                       for key in check_spec["limits"]}
            memory_peak = max(memory_peak, their_peak)
    compared = {key: within(numbers.get(key), limit)
                for key, limit in check_spec["limits"].items()}
    labels = [r["value"] for r in readings if r["value"] is not None]
    failed = sum(r["error"] is not None for r in readings)
    label = workload["label"]
    for key, value in label_numbers(
            readings, label, kwargs,
            ranks=1 if group is None else group.world).items():
        compared[key] = within(value, label["limits"][key])
    # Every label the window published, against the card's data sheet.
    compared["label_over_peak"] = within(
        max(labels) / peak if labels else math.inf, 1.0)
    compared["failed_readings"] = within(float(failed), 0.0)

    record = {
        "workload": workload, "config": spec["config"], "peaks": peaks,
        "peak": peak, "readings": readings, "trace": trace_summary,
        "spans": spans.calls,
        "setup_s": (window_boot - process_start
                    if process_start is not None else None),
    }
    result = result_line(spec, trace, record, per_layer, compared, device,
                         memory_peak,
                         None if group is None else group.world)
    return result, readings, trace_summary


def result_line(spec, trace, record, per_layer, compared, device,
                memory_peak, count=None):
    """The result line's object: the cell's end-to-end metrics (its
    per-layer ones, read by `per_layer`'s modules, in a traced run) from
    `record`, the device, and the `compared` numbers; `count` is the
    number of cards the run used (None: those visible)."""
    wanted = spec["per_layer"] if trace else spec["end_to_end"]
    readers = per_layer if trace else {m["name"]: metric_module(m["name"])
                                       for m in wanted}
    metrics = {}
    for m in wanted:
        value = readers[m["name"]].read(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    if count is None:
        count = torch.cuda.device_count() if device.type == "cuda" else 1
    device_info = {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "kind": (torch.cuda.get_device_name(device)
                 if device.type == "cuda" else "cpu"),
        "count": count,
        "memory_peak_bytes": memory_peak,
    }
    readings = record["readings"]
    result = {
        "correct": all(c["ok"] for c in compared.values()),
        "attempted": len(readings),
        "failed": sum(r["error"] is not None for r in readings),
        "metrics": metrics, "device": device_info,
    }
    trace_summary = record["trace"]
    if trace_summary is not None:
        device_info["busy_s"] = trace_summary["busy_s"]
        device_info["window_s"] = trace_summary["window_s"]
        result["breakdown"] = {"device_ops": trace_summary["top_ops"],
                               "idle_gaps": trace_summary["idle_gaps"]}
    result["checks"] = {key: {"value": c["value"], "limit": c["limit"]}
                        for key, c in compared.items()}
    return result
