"""The port's own copy of ``tpufd.trace`` (``tpufd/trace.py``), kept equal
to it and importing nothing of ``tpufd``.

Causal label-propagation trace recorder — the Python twin of
``src/tfd/obs/trace.h`` (TraceRecorder).

Every label-moving event mints a monotone **change-id** at its origin
(probe-snapshot movement, slice verdict adoption, lifecycle edge,
watch-drift heal) and accumulates per-stage timestamps as it flows
through the pass pipeline (plan -> render -> govern -> publish ->
publish-acked). The change id is the cross-process join key: it rides
as the ``tfd.google.com/change-id`` CR annotation
(:data:`tpufd_torch.sink.CHANGE_ANNOTATION`), is echoed by the slice
blackboard verdict and the aggregator's inventory object, and is
carried by journal events and ``--log-format=json`` lines next to the
rewrite generation.

Parity contract: given the same mint/stage/publish sequence with
injected timestamps, :meth:`TraceRecorder.render_json` and
:meth:`TraceRecorder.render_chrome_trace` reproduce the C++ renderings
BYTE-FOR-BYTE — pinned by the golden grids in
``src/tfd/tests/unit_tests.cc`` (TestTraceRecorder*) and
``tests/test_trace.py`` against one shared literal. The recorder is
bounded (drop-oldest) exactly like the C++ ring.

The simulation side (``scripts/cluster_soak.py``) uses the richer
:class:`tpufd_torch.cluster.ChangeTracker` for per-failure-class stage
breakdowns; THIS class is the daemon-twin used for parity pins and
harness-side parsing of ``/debug/trace`` documents.
"""

import json

# The terminal stage MarkPublished stamps (C++ kPublishAckedStage).
PUBLISH_ACKED = "publish-acked"

# The pass-pipeline stage vocabulary, in pipeline order (the daemon
# stamps these; the Chrome rendering slices records along them).
PASS_STAGES = ("plan", "render", "govern", "publish", PUBLISH_ACKED)


def _quote(s):
    """jsonlite::Quote parity: json.dumps matches its escape set
    (quote, backslash, \\b \\f \\n \\r \\t, \\u00XX controls) for
    UTF-8-clean text."""
    return json.dumps(s, ensure_ascii=False)


def _ts(t):
    """Fixed 6-decimal timestamp rendering (C++ FormatTs)."""
    return f"{t:.6f}"


def _micros(t):
    """Half-up microsecond rounding (C++ Micros)."""
    return int(t * 1e6 + 0.5)


class TraceRecorder:
    """Bounded causal-trace ring: mint/stage/mark_published plus the
    two renderings (/debug/trace JSON and the Perfetto-loadable Chrome
    trace-event document)."""

    DEFAULT_CAPACITY = 256

    def __init__(self, capacity=DEFAULT_CAPACITY):
        self.capacity = max(1, capacity)
        self.records = []
        self.next_change = 1
        self.dropped = 0

    def mint(self, origin, source, detail, now):
        """New change id at a label-moving origin; drop-oldest past
        capacity (counted, like the C++ tfd_trace_dropped_total)."""
        change = self.next_change
        self.next_change += 1
        self.records.append({
            "change": change, "generation": 0, "minted_ts": now,
            "origin": origin, "source": source, "detail": detail,
            "published": False, "stages": [],
        })
        if len(self.records) > self.capacity:
            self.records.pop(0)
            self.dropped += 1
        return change

    def stage(self, name, now):
        """Stamps `name` on every active record (first-wins)."""
        for record in self.records:
            if record["published"]:
                continue
            if any(stage == name for stage, _ in record["stages"]):
                continue
            record["stages"].append((name, now))

    def mark_published(self, generation, now, through_change=None):
        """Publish-acks every active record under `generation` —
        bounded by `through_change` (C++ parity: a change minted
        concurrently with the publishing pass was not in its content
        and stays active; None retires everything). Returns the records
        retired by THIS call (terminal stamp included), like the C++
        MarkPublished — the caller folds them into the SLO sketches."""
        retired = []
        for record in self.records:
            if record["published"]:
                continue
            if through_change is not None and \
                    record["change"] > through_change:
                continue
            record["published"] = True
            record["generation"] = generation
            record["stages"].append((PUBLISH_ACKED, now))
            retired.append(record)
        return retired

    def latest_active_change(self):
        latest = 0
        for record in self.records:
            if not record["published"]:
                latest = max(latest, record["change"])
        return latest

    def active(self):
        return sum(1 for r in self.records if not r["published"])

    def _snapshot(self, n=0, change=0):
        out = [r for r in self.records
               if change == 0 or r["change"] == change]
        if n and len(out) > n:
            out = out[-n:]
        return out

    def render_json(self, n=0, change=0):
        """The /debug/trace document, byte-identical to the C++
        RenderJson for the same inputs."""
        parts = []
        for r in self._snapshot(n, change):
            stages = ",".join(
                f"{_quote(stage)}:{_ts(ts)}" for stage, ts in r["stages"])
            parts.append(
                "{\"change\":%d,\"generation\":%d,\"minted_ts\":%s,"
                "\"origin\":%s,\"source\":%s,\"detail\":%s,"
                "\"published\":%s,\"stages\":{%s}}" % (
                    r["change"], r["generation"], _ts(r["minted_ts"]),
                    _quote(r["origin"]), _quote(r["source"]),
                    _quote(r["detail"]),
                    "true" if r["published"] else "false", stages))
        return ("{\"capacity\":%d,\"dropped_total\":%d,\"active\":%d,"
                "\"minted_total\":%d,\"records\":[%s]}" % (
                    self.capacity, self.dropped, self.active(),
                    self.next_change - 1, ",".join(parts)))

    def render_chrome_trace(self):
        """Chrome trace-event JSON (C++ RenderChromeTrace parity): one
        complete event per stage interval, tid = change id."""
        events = []
        for r in self._snapshot():
            prev = r["minted_ts"]
            for stage, ts in r["stages"]:
                start = prev
                end = max(ts, prev)
                prev = end
                events.append(
                    "{\"name\":%s,\"cat\":%s,\"ph\":\"X\",\"ts\":%d,"
                    "\"dur\":%d,\"pid\":1,\"tid\":%d,\"args\":"
                    "{\"change\":%s,\"origin\":%s,\"source\":%s,"
                    "\"generation\":%s}}" % (
                        _quote(stage), _quote(r["origin"]),
                        _micros(start), _micros(end) - _micros(start),
                        r["change"], _quote(str(r["change"])),
                        _quote(r["origin"]), _quote(r["source"]),
                        _quote(str(r["generation"]))))
        return ("{\"displayTimeUnit\":\"ms\",\"traceEvents\":[%s]}"
                % ",".join(events))


def stage_durations_ms(record):
    """C++ obs/slo.h StageDurationsMs twin: per-stage durations (ms) of
    one closed trace record, sliced by the RenderChromeTrace interval
    rule (previous stamp -> stage stamp, minted_ts first, clamped at 0
    against clock steps). "govern" folds into "render"; stages outside
    the SLO vocabulary (tpufd_torch.agg.SLO_STAGES) are dropped."""
    from tpufd_torch.agg import SLO_STAGES

    out = {}
    prev = record["minted_ts"]
    for stage, ts in record["stages"]:
        end = max(ts, prev)
        ms = (end - prev) * 1000.0
        prev = end
        if stage == "govern":
            out["render"] = out.get("render", 0.0) + ms
        elif stage in SLO_STAGES:
            out[stage] = out.get(stage, 0.0) + ms
    return out


class StageSlo:
    """C++ obs/slo.h StageSlo twin: windowed per-stage latency sketches
    — each closed change folds its stage durations (ms) into one
    removable sketch per stage, retire-oldest past `window_s`, so the
    view is the last N minutes, not since boot. render_json is
    byte-parity-pinned against the C++ RenderJson."""

    DEFAULT_WINDOW_S = 600

    def __init__(self, window_s=DEFAULT_WINDOW_S):
        self.window_s = max(1, window_s)
        self.samples = []   # (ts, [(stage, ms)])
        self.sketches = {}  # stage -> tpufd_torch.agg.Sketch
        self.folded = 0
        self.retired = 0
        self.last_change = 0

    def _expire(self, now):
        while self.samples and self.samples[0][0] <= now - self.window_s:
            _, stages = self.samples.pop(0)
            for stage, ms in stages:
                sketch = self.sketches.get(stage)
                if sketch is None:
                    continue
                sketch.remove(ms)
                if sketch.total <= 0:
                    del self.sketches[stage]
            self.retired += 1

    def fold(self, change, stage_ms, now):
        from tpufd_torch.agg import SLO_STAGES, Sketch

        stages = []
        for name in SLO_STAGES:
            if name not in stage_ms:
                continue
            self.sketches.setdefault(name, Sketch()).add(stage_ms[name])
            stages.append((name, stage_ms[name]))
        if stages:
            self.samples.append((now, stages))
            self.folded += 1
            self.last_change = max(self.last_change, change)
        self._expire(now)

    def expire(self, now):
        self._expire(now)

    def serialize(self):
        from tpufd_torch.agg import serialize_stage_sketches

        return serialize_stage_sketches(self.sketches)

    def render_json(self):
        """The /debug/slo document, byte-identical to the C++
        RenderJson for the same fold/expire sequence."""
        from tpufd_torch.agg import SLO_STAGES, fixed3

        parts = []
        for name in SLO_STAGES:
            sketch = self.sketches.get(name)
            if sketch is None or sketch.total <= 0:
                continue
            parts.append(
                "%s:{\"count\":%d,\"p50_ms\":%s,\"p99_ms\":%s}" % (
                    _quote(name), sketch.total,
                    fixed3(sketch.quantile(0.50)),
                    fixed3(sketch.quantile(0.99))))
        return ("{\"window_s\":%d,\"samples\":%d,\"folded_total\":%d,"
                "\"retired_total\":%d,\"last_change\":%d,\"stages\":{%s},"
                "\"serialized\":%s}" % (
                    self.window_s, len(self.samples), self.folded,
                    self.retired, self.last_change, ",".join(parts),
                    _quote(self.serialize())))


def parse_slo(text):
    """Parses a /debug/slo (or SIGUSR1-dump ``slo``) document; raises
    ValueError when the schema is off — the harness-side mirror of
    :func:`parse_trace`."""
    doc = json.loads(text) if isinstance(text, (str, bytes)) else text
    for key in ("window_s", "samples", "folded_total", "retired_total",
                "last_change", "stages", "serialized"):
        if key not in doc:
            raise ValueError(f"slo document missing {key!r}")
    for stage, entry in doc["stages"].items():
        for key in ("count", "p50_ms", "p99_ms"):
            if key not in entry:
                raise ValueError(
                    f"slo stage {stage!r} missing {key!r}: {entry}")
    return doc


def parse_trace(text):
    """Parses a /debug/trace (or SIGUSR1-dump ``trace``) document;
    raises ValueError when the schema is off — the harness-side
    mirror of :func:`tpufd_torch.journal.parse_journal`."""
    doc = json.loads(text) if isinstance(text, (str, bytes)) else text
    for key in ("capacity", "dropped_total", "active", "minted_total",
                "records"):
        if key not in doc:
            raise ValueError(f"trace document missing {key!r}")
    if len(doc["records"]) > doc["capacity"]:
        raise ValueError("trace holds more records than its capacity "
                         f"({len(doc['records'])} > {doc['capacity']}) — "
                         "the ring is not bounded")
    for record in doc["records"]:
        for key in ("change", "generation", "minted_ts", "origin",
                    "published", "stages"):
            if key not in record:
                raise ValueError(f"trace record missing {key!r}: {record}")
    return doc


def records_for_change(doc, change):
    """The parsed records carrying one change id (join helper)."""
    return [r for r in doc["records"] if r.get("change") == change]
