"""The port's own copy of ``tpufd.fakes.simnet``
(``tpufd/fakes/simnet.py``), kept equal to it and importing nothing of
``tpufd``.

Shared virtual-clock simulation primitives for the cluster-in-a-box
soaks (fleet --watch, fleet --aggregate, scripts/cluster_soak.py).

Grown inside scripts/fleet_soak.py (the 10k watch-mode simulation, then
the aggregator simulation) and extracted so the cluster, fleet, and
aggregate soaks import ONE copy of
the clock / sharded-apiserver / daemon scheduling machinery instead of
re-growing private forks.

Everything here is seeded and virtual-time: no wall clock, no sockets,
no threads. Wire-level truth (chunked watch framing, SSA ownership,
410 resync) is pinned separately against the real
tpufd_torch.fakes.apiserver; these primitives model the fleet-scale emergent
behavior — fan-out, pacing, convergence — on a discrete-event loop.
"""

import collections
import heapq
import random

from tpufd_torch import sink as sinklib

BASE_LABELS = {
    "google.com/tfd.tpu-vm": "true",
    "google.com/tpu.accelerator-type": "v5litepod-16",
    "google.com/tpu.count": "4",
    "google.com/tpu.machine": "ct5lp-hightpu-4t",
    "google.com/tpu.product": "tpu-v5-lite-podslice",
    "google.com/tpu.slice.shape": "4x4",
    "google.com/tpu.topology": "4x4",
    "google.com/tpu.vcpu": "112",
}


def percentile(values, pct):
    if not values:
        return 0.0
    ordered = sorted(values)
    idx = min(len(ordered) - 1, int(round(pct / 100.0 * (len(ordered) - 1))))
    return ordered[idx]


class SimClock:
    """Discrete-event loop: schedule(t, fn) then run(until)."""

    def __init__(self):
        self.heap = []
        self.seq = 0
        self.now = 0.0

    def schedule(self, t, fn):
        self.seq += 1
        heapq.heappush(self.heap, (t, self.seq, fn))

    def run(self, until):
        while self.heap and self.heap[0][0] <= until:
            t, _, fn = heapq.heappop(self.heap)
            self.now = max(self.now, t)
            fn(self.now)
        self.now = until


class SimApiServer:
    """Sharded store + per-object watch fan-out (the watch-mode
    model). Each shard owns its objects, its per-second request
    accounting, and (during the storm) its watch (re-)establishment
    capacity."""

    def __init__(self, clock, shards, rng):
        self.clock = clock
        self.shards = shards
        self.rng = rng
        self.objects = {}     # name -> {labels, rv, managers}
        self.watchers = {}    # name -> SimDaemon
        self.buckets = collections.Counter()   # int(t) -> requests
        self.by_verb = collections.Counter()
        self.watch_capacity = 0  # per shard per second (0 = unlimited)
        self.watch_buckets = collections.Counter()  # (shard, sec) -> n
        self.partitioned = set()  # names whose daemon lost connectivity

    def shard_of(self, name):
        return sinklib.fnv1a64(name) % self.shards

    def _wire_latency(self):
        return self.rng.uniform(0.0005, 0.003)

    def count(self, t, verb):
        self.buckets[int(t)] += 1
        self.by_verb[verb] += 1

    def apply(self, t, name, labels, manager="tfd"):
        """SSA write from a daemon: tfd-owned keys replaced, foreign
        managers' keys preserved. Returns the new rv."""
        self.count(t, "APPLY")
        obj = self.objects.setdefault(
            name, {"labels": {}, "rv": 0, "managers": {}})
        owned = obj["managers"].setdefault(manager, set())
        for key in owned - set(labels):
            obj["labels"].pop(key, None)
        for key, value in labels.items():
            obj["labels"][key] = value
            for other, keys in obj["managers"].items():
                if other != manager:
                    keys.discard(key)
        obj["managers"][manager] = set(labels)
        obj["rv"] += 1
        self._fanout(t, name, "MODIFIED" if obj["rv"] > 1 else "ADDED")
        return obj["rv"]

    def edit(self, t, name, key, value):
        """Foreign drift: another manager moves one of OUR keys (value
        override) — the heal drill's injection."""
        obj = self.objects[name]
        obj["labels"][key] = value
        for keys in obj["managers"].values():
            keys.discard(key)
        obj["managers"].setdefault("chaos", set()).add(key)
        obj["rv"] += 1
        self._fanout(t, name, "MODIFIED")

    def delete(self, t, name):
        obj = self.objects.pop(name, None)
        if obj is not None:
            self._fanout(t, name, "DELETED")

    def _fanout(self, t, name, event_type):
        daemon = self.watchers.get(name)
        if daemon is None or name in self.partitioned:
            return
        obj = self.objects.get(name)
        labels = dict(obj["labels"]) if obj else {}
        deliver = t + self._wire_latency()
        self.clock.schedule(
            deliver,
            lambda now, d=daemon, et=event_type, lb=labels:
                d.on_watch_event(now, et, lb))

    def watch_connect(self, t, name, daemon):
        """A watch (re-)establishment attempt. Returns (ok,
        retry_after_s): during the storm each shard only admits
        watch_capacity establishments per second; the overflow gets a
        429 + Retry-After: 1 — APF pacing, a LIVE server."""
        self.count(t, "WATCH")
        if name in self.partitioned:
            return False, 0.0  # transport error, not pacing
        if self.watch_capacity:
            key = (self.shard_of(name), int(t))
            self.watch_buckets[key] += 1
            overflow = self.watch_buckets[key] - self.watch_capacity
            if overflow > 0:
                # Backlog-proportional Retry-After (what APF estimates):
                # the i-th rejected arrival is told to come back when
                # the queue ahead of it will have drained — later
                # arrivals wait longer, so the retry wave spreads
                # instead of re-herding every Retry-After period.
                return False, max(1.0, overflow / self.watch_capacity)
        self.watchers[name] = daemon
        return True, 0.0

    def drop_all_watches(self, t):
        dropped = list(self.watchers.values())
        self.watchers.clear()
        return dropped


class SimDaemon:
    """One event-driven daemon: publishes via the SSA flow, holds a
    watch, heals drift on watch events, reconnects with Retry-After
    pacing / jittered backoff, and counts its passes."""

    def __init__(self, server, clock, index, seed):
        self.server = server
        self.clock = clock
        self.name = f"sim-node-{index:05d}"
        self.rng = random.Random(seed * 7919 + index)
        self.labels = dict(BASE_LABELS)
        self.labels["google.com/tfd.node"] = self.name
        self.breaker = sinklib.Breaker(open_after=3, cooldown_s=30.0)
        self.connected = False
        self.reconnect_failures = 0
        self.passes = 0
        self.heal_requested_at = None
        self.heal_latencies_ms = []
        self.reconnected_at = None

    def _pass_latency(self):
        return self.rng.uniform(0.0003, 0.0015)

    def join(self, t):
        self.server.apply(t, self.name, self.labels)
        self.passes += 1
        self.connect(t)

    def connect(self, t):
        ok, retry_after = self.server.watch_connect(t, self.name, self)
        if ok:
            self.connected = True
            self.reconnect_failures = 0
            self.reconnected_at = t
            # Re-list drift check on (re-)establish: heal anything that
            # moved while we were not watching.
            obj = self.server.objects.get(self.name)
            self.server.count(t, "GET")
            if obj is None or any(
                    obj["labels"].get(k) != v
                    for k, v in self.labels.items()):
                self._schedule_heal(t)
            return
        self.connected = False
        if retry_after > 0:
            # Server-directed pacing (the storm): a pacing server is
            # alive — never feeds the breaker.
            self.breaker.defer(
                sinklib.spread_retry_after_s(retry_after, self.name), t)
            pause = sinklib.spread_retry_after_s(retry_after, self.name)
        else:
            # Transport failure (partition): exponential + jitter.
            self.reconnect_failures += 1
            self.breaker.record_transient_failure(t)
            base = min(30.0, 1.0 * (2 ** min(self.reconnect_failures - 1,
                                             10)))
            pause = sinklib.spread_retry_after_s(base, self.name)
        self.clock.schedule(t + pause, lambda now: self.connect(now))

    def drop(self, t):
        # Mirrors the C++ watcher's errored-stream path: first reconnect
        # after backoff_initial (1s), stretched per node by the desync
        # hash. The first wave still herds (physics: everyone was
        # dropped at the same instant) — the SERVER's Retry-After pacing
        # is what spreads the retries.
        self.connected = False
        self.clock.schedule(t + sinklib.spread_retry_after_s(1.0, self.name),
                            lambda now: self.connect(now))

    def on_watch_event(self, t, event_type, labels):
        if not self.connected:
            return
        if event_type == "DELETED" or any(
                labels.get(k) != v for k, v in self.labels.items()):
            self._schedule_heal(t)

    def _schedule_heal(self, t):
        if self.heal_requested_at is None:
            self.heal_requested_at = t
            self.clock.schedule(t + self._pass_latency(),
                                lambda now: self._heal_pass(now))

    def _heal_pass(self, t):
        self.passes += 1
        requested = self.heal_requested_at
        self.heal_requested_at = None
        if self.name in self.server.partitioned:
            # The pass's write fails in transit; retried on reconnect.
            self.breaker.record_transient_failure(t)
            return
        self.server.apply(t, self.name, self.labels)
        self.breaker.record_success()
        if requested is not None:
            self.heal_latencies_ms.append((t - requested) * 1000.0)


class AggSimServer:
    """The apiserver as the aggregator sees it: per-node label objects,
    a collection-watch fan-out to ONE watcher, and per-second request
    accounting attributed to the aggregator."""

    def __init__(self, clock, rng):
        self.clock = clock
        self.rng = rng
        self.objects = {}          # node -> labels
        self.watcher = None        # the SimAggregator
        self.agg_requests = collections.Counter()  # int(t) -> n
        self.by_verb = collections.Counter()
        self.output_writes = []    # (t, labels) — the rollup object

    def _wire_latency(self):
        return self.rng.uniform(0.0005, 0.003)

    def count_agg(self, t, verb):
        self.agg_requests[int(t)] += 1
        self.by_verb[verb] += 1

    def daemon_apply(self, t, node, labels):
        """A daemon's SSA write (not counted against the aggregator's
        budget — the per-daemon load is proven separately)."""
        self.objects[node] = dict(labels)
        if self.watcher is not None:
            deliver = t + self._wire_latency()
            self.clock.schedule(
                deliver,
                lambda now, n=node, lb=dict(labels):
                    self.watcher.on_event(now, n, lb))

    def daemon_delete(self, t, node):
        self.objects.pop(node, None)
        if self.watcher is not None:
            self.clock.schedule(
                t + self._wire_latency(),
                lambda now, n=node:
                    self.watcher.on_event(now, n, None))


class SimAggregator:
    """The aggregator twin: incremental store + coalescing flush +
    lease renewals, all through tpufd_torch.agg (parity-pinned against the
    C++ core)."""

    def __init__(self, server, clock, debounce_s, lease_s):
        from tpufd_torch import agg as agglib

        self.agglib = agglib
        self.server = server
        self.clock = clock
        self.store = agglib.InventoryStore()
        self.flush = agglib.FlushController(debounce_s)
        self.lease_s = lease_s
        self.synced = False
        self.flush_scheduled = False
        self.pending_changes = []  # change times awaiting a publish
        self.publish_latencies_ms = []

    def start(self, t):
        # Lease bootstrap + the renewal cadence (GET + PATCH per tick,
        # the real runner's LeaseTick).
        self.lease_tick(t)

    def lease_tick(self, t):
        self.server.count_agg(t, "GET")
        self.server.count_agg(t, "PATCH")
        self.clock.schedule(t + self.lease_s / 3.0,
                            lambda now: self.lease_tick(now))

    def _stage_slo(self, labels):
        """The stage-slo annotation analogue: the base aggregator has
        none; the cluster soak overrides this to lift each node's
        serialized stage sketches off its object."""
        return ""

    def sync(self, t):
        """The initial collection LIST: ONE request regardless of fleet
        size, every item applied through the same incremental path."""
        self.server.count_agg(t, "LIST")
        for node, labels in self.server.objects.items():
            self.store.apply(node, labels, self._stage_slo(labels))
        self.server.watcher = self
        self.synced = True
        self._note_dirty(t)

    def on_event(self, t, node, labels):
        moved = (self.store.remove(node) if labels is None
                 else self.store.apply(node, labels,
                                       self._stage_slo(labels)))
        if moved:
            self.pending_changes.append(t)
            self._note_dirty(t)

    def _note_dirty(self, t):
        self.flush.note_dirty(t)
        if not self.flush_scheduled:
            self.flush_scheduled = True
            self.clock.schedule(self.flush.due_at(),
                                lambda now: self._flush(now))

    def _flush(self, t):
        self.flush_scheduled = False
        if not self.flush.should_flush(t):
            return
        self.server.count_agg(t, "APPLY")
        self.server.output_writes.append(
            (t, self.store.build_output_labels()))
        self.flush.note_flushed()
        for changed_at in self.pending_changes:
            self.publish_latencies_ms.append((t - changed_at) * 1000.0)
        self.pending_changes = []
