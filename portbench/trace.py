"""The traced run: torch.profiler over the window, reduced to what the
per-layer metrics read.

Each reading is marked with a user annotation (``READING``), so the
window is taken in the trace's own clock: from the first reading's start
to the last one's end. Device operations are the card's kernels, copies
and sets; the device is busy where one of them runs. Each carries its
launcher: the host operation the profiler links it to (its linked
correlation id), "aten::mm" for cuBLAS's GEMM and its memset. An idle gap
is named by the innermost host operation that was running at its
middle.
"""

import bisect

import torch

READING = "portbench.reading"
# Gaps shorter than this are the launch-to-launch seam between two
# back-to-back kernels; they count as idle time under one name.
SEAM_NS = 10_000
SEAM = "(between back-to-back kernels)"
TOP = 10


def profiler(device):
    """A torch.profiler over the host and, on a card, the device."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=activities)


def mark():
    """The annotation around one reading."""
    return torch.profiler.record_function(READING)


def _is_device(event):
    return (event.device_type() == torch.autograd.DeviceType.CUDA
            and not event.is_user_annotation())


def union_ns(intervals):
    """Merged (start, end) pairs of sorted-by-start intervals."""
    merged = []
    for start, end in intervals:
        if merged and start <= merged[-1][1]:
            if end > merged[-1][1]:
                merged[-1][1] = end
        else:
            merged.append([start, end])
    return merged


def summarize(readings, device_ops, host_ops, launchers=None):
    """The trace's summary from plain tuples: `readings` and `host_ops`
    are (name, start_ns, end_ns) on the host, `device_ops` (name,
    start_ns, end_ns, linked correlation id) on the device, and
    `launchers` maps a host operation's correlation id to its name. Only
    what lies inside the window counts."""
    if not readings:
        return None
    launchers = launchers or {}
    lo = min(start for _, start, _ in readings)
    hi = max(end for _, _, end in readings)
    ops = sorted((max(s, lo), min(e, hi), name,
                  launchers.get(linked, "host (no operation)"))
                 for name, s, e, linked in device_ops if e > lo and s < hi)
    busy = union_ns((s, e) for s, e, _, _ in ops)
    busy_ns = sum(e - s for s, e in busy)

    per_op = {}
    for s, e, name, _ in ops:
        per_op[name] = per_op.get(name, 0) + (e - s)
    top_ops = sorted(per_op.items(), key=lambda kv: -kv[1])[:TOP]

    by_launcher = {}
    for s, e, _, launcher in ops:
        by_launcher[launcher] = by_launcher.get(launcher, 0) + (e - s)

    host = sorted((s, e, name) for name, s, e in host_ops)
    starts = [s for s, _, _ in host]
    gaps = {}
    edges = [lo] + [x for pair in busy for x in pair] + [hi]
    for start, end in zip(edges[::2], edges[1::2]):
        if end <= start:
            continue
        name = SEAM if end - start < SEAM_NS else _host_at(
            host, starts, (start + end) // 2)
        gaps[name] = gaps.get(name, 0) + (end - start)
    idle_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        "window_s": (hi - lo) / 1e9,
        "busy_s": busy_ns / 1e9,
        "readings": len(readings),
        "device_ops": [(name, s, e, launcher)
                       for s, e, name, launcher in ops],
        "top_ops": [[name, ns / 1e9] for name, ns in top_ops],
        "by_launcher": sorted(([name, ns / 1e9] for name, ns
                               in by_launcher.items()), key=lambda x: -x[1]),
        "idle_gaps": [[name, ns / 1e9] for name, ns in idle_gaps],
    }


def _host_at(host, starts, t, lookback=64):
    """The innermost host operation running at `t`, else "host (no
    operation)"."""
    best = None
    i = bisect.bisect_right(starts, t)
    for s, e, name in reversed(host[max(0, i - lookback):i]):
        if e >= t and (best is None or e - s < best[0]):
            best = (e - s, name)
    return best[1] if best else "host (no operation)"


def reduce(prof):
    """The summary of a finished torch.profiler.profile."""
    readings, device_ops, host_ops, launchers, spans = [], [], [], {}, {}
    for event in prof.profiler.kineto_results.events():
        item = (event.name(), event.start_ns(), event.end_ns())
        if _is_device(event):
            device_ops.append(item + (event.linked_correlation_id(),))
            continue
        if event.device_type() == torch.autograd.DeviceType.CUDA:
            continue  # an annotation's device-side copy
        # Runtime calls carry CUPTI's ids; an overhead record such as
        # "Command Buffer Full" carries the id of the op it fell in, which
        # lasts longer.
        key = event.correlation_id()
        if not event.name().startswith("cu") and (
                key not in spans or spans[key] < event.duration_ns()):
            spans[key] = event.duration_ns()
            launchers[key] = event.name()
        if event.name() == READING and event.is_user_annotation():
            readings.append(item)
        elif not event.is_user_annotation():
            host_ops.append(item)
    return summarize(readings, device_ops, host_ops, launchers)
