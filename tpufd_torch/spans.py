"""Spans of the port's probes: what a reading, its differential timer,
each calibration step and each timed run cost, recorded where the work
happens (standard library only).

A span has a name, a start and an end in ``time.perf_counter_ns()``, its
own id, its parent's id and the id of its root span, the request: every
span of one probe reading carries the id of that reading's ``probe``
span. It also holds a small dict of attributes. Spans nest by the
``with`` statements that open them, per thread.

The recorder is always on. The probes record per timer run, never per
loop iteration, so a reading costs a few dozen spans. Finished spans go
into a bounded ring that drops its oldest span when full and counts what
it dropped, as ``tpufd_torch.trace.TraceRecorder`` does.

The recorder emits nothing into ``torch.profiler``. It keeps the offset
from its stamps to the clock of the profiler's kineto events
(CLOCK_REALTIME nanoseconds, the ``start_ns()`` of every event), so a
span can be laid over a device trace: :meth:`Recorder.to_profiler_ns`.

:func:`window` picks the spans of the last readings out of the ring,
checked against the runs their timer made.
"""

import collections
import itertools
import threading
import time

# Spans kept: about 40 a reading (the matmul probe's ladder has 31 timed
# runs), so a ten-second window of readings many times over.
CAPACITY = 4096


def profiler_clock_offset_ns():
    """CLOCK_REALTIME ns minus perf_counter_ns, from the closest together
    of five readings of the pair."""
    best = None
    for _ in range(5):
        before = time.perf_counter_ns()
        wall = time.time_ns()
        after = time.perf_counter_ns()
        if best is None or after - before < best[0]:
            best = (after - before, wall - (before + after) // 2)
    return best[1]


class Span:
    """One timed region; a context manager that records itself into its
    recorder when it closes. An exception leaving the region sets the
    ``error`` attribute and propagates."""

    __slots__ = ("name", "start_ns", "end_ns", "id", "parent", "request",
                 "attrs", "_recorder")

    def __init__(self, recorder, name, attrs):
        self._recorder = recorder
        self.name = name
        self.attrs = attrs
        self.start_ns = self.end_ns = None

    def __enter__(self):
        stack = self._recorder._stack()
        self.id = next(self._recorder._ids)
        if stack:
            self.parent, self.request = stack[-1].id, stack[-1].request
        else:
            self.parent, self.request = None, self.id
        stack.append(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, kind, value, tb):
        self.end_ns = time.perf_counter_ns()
        if kind is not None:
            self.attrs["error"] = f"{kind.__name__}: {value}"
        self._recorder._stack().pop()
        self._recorder._keep(self)
        return False

    @property
    def seconds(self):
        return (self.end_ns - self.start_ns) / 1e9


class Recorder:
    """The bounded ring of finished spans and each thread's open ones."""

    def __init__(self, capacity=CAPACITY):
        self.spans = collections.deque(maxlen=max(1, capacity))
        self.dropped = 0
        self.offset_ns = profiler_clock_offset_ns()
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._lock = threading.Lock()

    def span(self, name, **attrs):
        """A span named `name`, child of this thread's innermost open
        span; use it in a ``with`` statement."""
        return Span(self, name, attrs)

    def current_request(self):
        """This thread's outermost open span, or None."""
        stack = self._stack()
        return stack[0] if stack else None

    def to_profiler_ns(self, t_ns):
        """A perf_counter_ns stamp in the profiler's clock."""
        return t_ns + self.offset_ns

    def _stack(self):
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _keep(self, span):
        with self._lock:
            if len(self.spans) == self.spans.maxlen:
                self.dropped += 1
            self.spans.append(span)


_DEFAULT = Recorder()


def default_recorder():
    """The process's recorder, which the probes write to."""
    return _DEFAULT


def span(name, **attrs):
    """A span on the process's recorder."""
    return _DEFAULT.span(name, **attrs)


_TIMER_SPANS = ("timer", "timer.step", "timer.run")


def window(run_ns, recorder=None):
    """The spans of the last ``len(run_ns)`` readings, each
    {"probe": span, "timer": [...], "timer.step": [...], "timer.run":
    [...]} in the order they closed, or None where they cannot be the
    readings': the ring dropped spans, it holds fewer ``probe`` spans,
    or a reading's runs asked for other n than ``run_ns[i]`` lists (the
    n of every run its timer made, the warm-up run included)."""
    recorder = recorder or _DEFAULT
    with recorder._lock:
        kept = list(recorder.spans)
        dropped = recorder.dropped
    probes = [s for s in kept if s.name == "probe" and s.parent is None]
    if dropped or not run_ns or len(probes) < len(run_ns):
        return None
    readings = []
    for probe, want in zip(probes[-len(run_ns):], run_ns):
        reading = {name: [] for name in _TIMER_SPANS}
        for s in kept:
            if s.request == probe.id and s.name in reading:
                reading[s.name].append(s)
        reading["probe"] = probe
        if [s.attrs["n"] for s in reading["timer.run"]] != list(want):
            return None
        readings.append(reading)
    return readings
