"""idle_outside_runs_pct: the seconds of the window in which no device
operation runs and the host is inside no timed run of the program's
timer, over the traced window, in percent: timer bookkeeping between
runs, the probe's set-up and the harness between readings.

The runs are the program's ``timer.run`` spans (tpufd_torch.spans),
each from its fn call to the fetch's return, laid over the trace in the
profiler's clock (Recorder.to_profiler_ns); the stretch looked at runs
from the first reading's ``probe`` span start to the last one's end.
Silent without device operations (the CPU), where the program records
no spans, or where its spans are not the window's readings."""

from portbench.trace import union_ns


def read(record):
    trace = record["trace"]
    if not trace or not trace["device_ops"] or not trace["window_s"]:
        return None
    try:
        from tpufd_torch import spans
    except ImportError:
        return None
    readings = spans.window(
        [[n for call in r["timer"] for n, _ in call["runs"]]
         for r in record["readings"]])
    if readings is None:
        return None
    clock = spans.default_recorder().to_profiler_ns
    lo = clock(readings[0]["probe"].start_ns)
    hi = clock(readings[-1]["probe"].end_ns)
    covered = [(clock(s.start_ns), clock(s.end_ns))
               for r in readings for s in r["timer.run"]]
    covered += [(s, e) for _, s, e, _ in trace["device_ops"]]
    covered = union_ns(sorted((max(s, lo), min(e, hi))
                              for s, e in covered if e > lo and s < hi))
    outside_ns = (hi - lo) - sum(e - s for s, e in covered)
    return 100.0 * outside_ns / 1e9 / trace["window_s"]
