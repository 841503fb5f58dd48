"""The port's own copy of ``tpufd.agg`` (``tpufd/agg.py``), kept equal to
it and importing nothing of ``tpufd``.

Python twin of the cluster-inventory aggregator core (src/tfd/agg/).

Mirrors, constant for constant, the pure logic the 10k-node aggregate
soak needs to simulate the aggregator without running it — and that the
parity tests pin against the C++ (change one side, change both):

  - the fixed-bin log-bucket quantile sketch (REMOVABLE + mergeable:
    counts per bucket, boundaries by repeated IEEE-double
    multiplication so both languages bucket identically bit-for-bit);
  - per-node contribution extraction from a published label set;
  - the incremental inventory store: every delta retires the node's old
    contribution and applies the new one — O(changed labels) per event,
    `full_recomputes` counts the from-scratch rebuilds the steady path
    must never take;
  - the coalescing bounded-staleness flush controller.
"""

from tpufd_torch.sink import fnv1a64

PREFIX = "google.com/"

SLICE_ID = PREFIX + "tpu.slice.id"
SLICE_DEGRADED = PREFIX + "tpu.slice.degraded"
MULTISLICE_SLICE_ID = PREFIX + "tpu.multislice.slice-id"
PERF_CLASS = PREFIX + "tpu.perf.class"
PERF_MATMUL = PREFIX + "tpu.perf.matmul-tflops"
PERF_HBM = PREFIX + "tpu.perf.hbm-gbps"
TPU_COUNT = PREFIX + "tpu.count"
LIFECYCLE_PREEMPT = PREFIX + "tpu.lifecycle.preempt-imminent"
LIFECYCLE_DRAINING = PREFIX + "tpu.lifecycle.draining"

INVENTORY_SLICES = PREFIX + "tpu.slice-inventory.slices"
INVENTORY_HEALTHY = PREFIX + "tpu.slice-inventory.healthy-slices"
INVENTORY_DEGRADED = PREFIX + "tpu.slice-inventory.degraded-slices"
CAPACITY_PREFIX = PREFIX + "tpu.capacity."
FLEET_NODES = PREFIX + "tpu.fleet.nodes"
FLEET_PREEMPTING = PREFIX + "tpu.fleet.preempting"
MULTISLICE_GROUPS = PREFIX + "tpu.multislice.groups"
FLEET_MATMUL_P10 = PREFIX + "tpu.fleet.perf.matmul-p10"
FLEET_MATMUL_P50 = PREFIX + "tpu.fleet.perf.matmul-p50"
FLEET_HBM_P10 = PREFIX + "tpu.fleet.perf.hbm-p10"
FLEET_HBM_P50 = PREFIX + "tpu.fleet.perf.hbm-p50"

# Fleet SLO engine (lm/schema.h kObsStagePrefix / kSloBurnPrefix):
# keys are prefix + stage (+ suffix), stage in SLO_STAGES.
OBS_STAGE_PREFIX = PREFIX + "tpu.obs.stage."
SLO_BURN_PREFIX = PREFIX + "tpu.slo."

# agg.h kSloStages — the node-pipeline stage vocabulary the SLO engine
# sketches ("govern" folds into "render" on the node side).
SLO_STAGES = ("plan", "render", "publish", "publish-acked")

# agg.cc DefaultSloBudgetsMs — node-stage latency budgets (ms), derived
# from the cluster protocol budgets (bench_gate CLUSTER_STAGE_BUDGETS_MS):
# plan and publish each get the chain "hold" allowance (the governor's
# local think-time), render the "fanout" allowance (pure CPU), and
# publish-acked — which absorbs brownout deferral — hold+fanout.
# bench_gate --slo re-derives this table and cross-checks it; change
# one side, change all.
SLO_STAGE_BUDGETS_MS = {
    "plan": 1200.0,
    "render": 100.0,
    "publish": 1200.0,
    "publish-acked": 1300.0,
}

# Sharded aggregation tree (lm/schema.h kAgg*): the label keys an L1
# shard's PARTIAL rollup CR carries — the shard's whole aggregate state
# as counter maps and sparse sketch buckets, merged O(delta) by the L2
# root into the byte-compatible cluster inventory.
AGG_PREFIX = PREFIX + "tfd.agg."
AGG_TIER = AGG_PREFIX + "tier"
AGG_SHARD = AGG_PREFIX + "shard"
AGG_NODES = AGG_PREFIX + "nodes"
AGG_PREEMPTING = AGG_PREFIX + "preempting"
AGG_SLICES = AGG_PREFIX + "slices"
AGG_CAPACITY = AGG_PREFIX + "capacity"
AGG_MULTISLICE = AGG_PREFIX + "multislice"
AGG_MATMUL = AGG_PREFIX + "matmul"
AGG_HBM = AGG_PREFIX + "hbm"
AGG_STAGE_SLO = AGG_PREFIX + "stage-slo"
AGG_TIER_PARTIAL = "partial"

# agg.h kSketch* — the parity grid pins bucket indices on both sides.
SKETCH_MIN = 0.5
SKETCH_GAMMA = 1.1
SKETCH_BUCKETS = 128


def shard_index_of(node, shards):
    """C++ ShardIndexOf: node -> L1 shard via the twin-pinned textbook
    FNV-1a name hash (shards <= 1 maps everything to shard 0)."""
    if shards <= 1:
        return 0
    return fnv1a64(node) % shards


# runner.cc ClassifyName: how one watched object participates in a
# tier's ingest. The inventory exclusion comes FIRST: partials
# deliberately carry the nfd node-name label (so the L2's selector
# watch sees them), which puts them in EVERY tier's stream — without
# the explicit name rule a shard would re-ingest inventory as node
# contributions.
CR_NAME_PREFIX = "tfd-features-for-"
INVENTORY_NAME_PREFIX = "tfd-inventory-"
PARTIAL_NAME_PREFIX = "tfd-inventory-shard-"

OBJ_NODE_CR = "node-cr"
OBJ_PARTIAL = "partial"
OBJ_OTHER = "other"


def classify_name(name, output_name):
    """Twin of runner.cc ClassifyName."""
    if name.startswith(PARTIAL_NAME_PREFIX):
        return OBJ_PARTIAL
    if name.startswith(INVENTORY_NAME_PREFIX) or name == output_name:
        return OBJ_OTHER
    if name.startswith(CR_NAME_PREFIX):
        return OBJ_NODE_CR
    return OBJ_OTHER


def sketch_bucket_index(value):
    """C++ SketchBucketIndex: repeated multiplication, never log()."""
    try:
        in_zero = not (value > SKETCH_MIN)  # NaN lands in bucket 0 too
    except TypeError:
        return 0
    if in_zero:
        return 0
    idx = 0
    edge = SKETCH_MIN
    while idx < SKETCH_BUCKETS - 1 and value > edge:
        edge *= SKETCH_GAMMA
        idx += 1
    return idx


def sketch_bucket_value(bucket):
    if bucket <= 0:
        return SKETCH_MIN
    bucket = min(bucket, SKETCH_BUCKETS - 1)
    edge = SKETCH_MIN
    for _ in range(bucket):
        edge *= SKETCH_GAMMA
    return edge


class Sketch:
    def __init__(self):
        self.counts = [0] * SKETCH_BUCKETS
        self.total = 0

    def add(self, value):
        self.counts[sketch_bucket_index(value)] += 1
        self.total += 1

    def remove(self, value):
        idx = sketch_bucket_index(value)
        if self.counts[idx] > 0:
            self.counts[idx] -= 1
            self.total -= 1

    def merge(self, other):
        for i in range(SKETCH_BUCKETS):
            self.counts[i] += other.counts[i]
        self.total += other.total

    def unmerge(self, other):
        """C++ Unmerge: retires a previously-merged sketch (per-bucket,
        clamped at zero)."""
        for i in range(SKETCH_BUCKETS):
            take = min(other.counts[i], self.counts[i])
            self.counts[i] -= take
            self.total -= take

    def add_bucket_count(self, bucket, n):
        """C++ AddBucketCount: deserialization primitive (out-of-range
        bucket / non-positive n ignored)."""
        if bucket < 0 or bucket >= SKETCH_BUCKETS or n <= 0:
            return
        self.counts[bucket] += n
        self.total += n

    def fraction_above(self, threshold):
        """C++ FractionAbove: fraction of mass whose bucket
        representative exceeds `threshold` (0 when empty)."""
        if self.total <= 0:
            return 0.0
        over = sum(n for i, n in enumerate(self.counts)
                   if n > 0 and sketch_bucket_value(i) > threshold)
        return over / self.total

    def quantile(self, q):
        if self.total <= 0:
            return -1.0
        q = min(max(q, 0.0), 1.0)
        target = int(q * (self.total - 1))
        cumulative = 0
        for i in range(SKETCH_BUCKETS):
            cumulative += self.counts[i]
            if cumulative > target:
                return sketch_bucket_value(i)
        return sketch_bucket_value(SKETCH_BUCKETS - 1)

    def __eq__(self, other):
        """C++ QuantileSketch::operator== (total + per-bucket counts)."""
        if not isinstance(other, Sketch):
            return NotImplemented
        return self.total == other.total and self.counts == other.counts

    def __ne__(self, other):
        eq = self.__eq__(other)
        return eq if eq is NotImplemented else not eq


def slo_budgets_ms_from_spec(spec):
    """C++ SloBudgetsMsFromSpec: the defaults with operator overrides
    applied — ``spec`` is "stage=ms[,stage=ms...]" (the
    TFD_SLO_BUDGETS_MS env format); unknown stages and malformed
    entries are ignored."""
    budgets = dict(SLO_STAGE_BUDGETS_MS)
    for entry in (spec or "").split(","):
        stage, eq, ms = entry.partition("=")
        if not eq or stage not in budgets or not ms.isdigit():
            continue
        if int(ms) <= 0:
            continue
        budgets[stage] = float(int(ms))
    return budgets


def serialize_stage_sketches(stages):
    """C++ SerializeStageSketches: compact annotation encoding —
    stages in SLO_STAGES order, empty skipped, sparse ascending
    ``bucket:count`` pairs, e.g. ``plan=0:3,5:2;publish=17:1``."""
    parts = []
    for name in SLO_STAGES:
        sketch = stages.get(name)
        if sketch is None or sketch.total <= 0:
            continue
        pairs = ",".join(f"{i}:{n}" for i, n in enumerate(sketch.counts)
                         if n > 0)
        parts.append(f"{name}={pairs}")
    return ";".join(parts)


def parse_stage_sketches(text):
    """C++ ParseStageSketches: tolerant inverse — unknown stages and
    malformed tokens are skipped, never fatal."""
    out = {}
    for entry in (text or "").split(";"):
        stage, eq, body = entry.partition("=")
        if not eq or stage not in SLO_STAGES:
            continue
        sketch = Sketch()
        for pair in body.split(","):
            bucket, colon, count = pair.partition(":")
            if not colon or not bucket.isdigit() or not count.isdigit():
                continue
            sketch.add_bucket_count(int(bucket), int(count))
        if sketch.total > 0:
            out.setdefault(stage, Sketch()).merge(sketch)
    return out


class BurnEvaluator:
    """C++ agg::BurnEvaluator twin: multi-window burn detection over
    the merged fleet sketches. A stage starts burning when the
    fast-window mean over-budget fraction crosses 1/2 while the
    slow-window mean has spent the 10% error budget; it clears when
    the fast mean drops back under 1/2."""

    FAST_WINDOW_S = 300.0
    SLOW_WINDOW_S = 3600.0
    FAST_THRESHOLD = 0.5
    SLOW_THRESHOLD = 0.1

    def __init__(self, budgets_ms=None, fast_window_s=FAST_WINDOW_S,
                 slow_window_s=SLOW_WINDOW_S):
        self.budgets = dict(SLO_STAGE_BUDGETS_MS if budgets_ms is None
                            else budgets_ms)
        self.fast_window_s = fast_window_s
        self.slow_window_s = slow_window_s
        self.samples = {}  # stage -> [(ts, over-fraction)]
        self.state = {}    # stage -> burning bool

    def burning(self, stage):
        return self.state.get(stage, False)

    def burning_stages(self):
        return sorted(s for s, b in self.state.items() if b)

    def note(self, now, sketches):
        """One evaluation tick; returns the burn edges as a list of
        (stage, burning) tuples (C++ Note, budget-sorted order)."""
        edges = []
        for stage in sorted(self.budgets):
            budget = self.budgets[stage]
            sketch = sketches.get(stage)
            have = sketch is not None and sketch.total > 0
            if not have and stage not in self.samples:
                continue
            fraction = sketch.fraction_above(budget) if have else 0.0
            window = self.samples.setdefault(stage, [])
            window.append((now, fraction))
            while window and window[0][0] <= now - self.slow_window_s:
                window.pop(0)
            fast = [f for ts, f in window if ts > now - self.fast_window_s]
            fast_mean = sum(fast) / len(fast) if fast else 0.0
            slow_mean = (sum(f for _, f in window) / len(window)
                         if window else 0.0)
            burning = self.state.get(stage, False)
            if (not burning and fast_mean >= self.FAST_THRESHOLD and
                    slow_mean >= self.SLOW_THRESHOLD):
                self.state[stage] = True
                edges.append((stage, True))
            elif burning and fast_mean < self.FAST_THRESHOLD:
                self.state[stage] = False
                edges.append((stage, False))
        return edges


def _parse_float(labels, key, fallback):
    raw = labels.get(key, "")
    try:
        return float(raw) if raw else fallback
    except ValueError:
        return fallback


def _parse_int(labels, key, fallback):
    raw = labels.get(key, "")
    return int(raw) if raw.isdigit() else fallback


def extract_contribution(labels, stage_slo=""):
    """C++ ExtractContribution: what one node's label set contributes to
    the rollups (equal dicts <=> no rollup can move). `stage_slo` is the
    node's serialized stage-sketch annotation, kept raw — string
    equality is the no-rollup-moved check."""
    return {
        "stage_slo": stage_slo,
        "slice_id": labels.get(SLICE_ID, ""),
        "slice_degraded": labels.get(SLICE_DEGRADED) == "true",
        "multislice_group": labels.get(MULTISLICE_SLICE_ID, ""),
        "perf_class": labels.get(PERF_CLASS, ""),
        "chips": _parse_int(labels, TPU_COUNT, 0),
        "matmul_tflops": _parse_float(labels, PERF_MATMUL, -1.0),
        "hbm_gbps": _parse_float(labels, PERF_HBM, -1.0),
        "preempting": (labels.get(LIFECYCLE_PREEMPT) == "true" or
                       labels.get(LIFECYCLE_DRAINING) == "true"),
    }


def capacity_bucket(perf_class):
    if perf_class in ("gold", "silver", "degraded"):
        return perf_class
    return "unclassed"


def fixed3(v):
    """util/strings.h Fixed3 ("%.3f") — the shared canonical format."""
    return "%.3f" % v


def rollup_state():
    """C++ RollupState zero value: the complete aggregate state one tier
    holds — what an L1 publishes as its partial, what the L2 accumulates
    per shard and as the merged total. Dict twin; ``slices`` values are
    ``[members, degraded, preempting]`` lists (the store's format)."""
    return {
        "nodes": 0,
        "preempting": 0,
        "slices": {},
        "capacity": {},
        "multislice": {},
        "matmul": Sketch(),
        "hbm": Sketch(),
        "stage": {},
    }


def build_rollup_labels(state):
    """C++ BuildRollupLabels: the cluster-scoped rollup label set from
    an aggregate state — every tier's output flows through this one
    function so byte-compat across the tree is structural."""
    healthy = sum(1 for agg in state["slices"].values()
                  if agg[1] == 0 and agg[2] == 0)
    degraded = len(state["slices"]) - healthy
    out = {
        INVENTORY_SLICES: str(len(state["slices"])),
        INVENTORY_HEALTHY: str(healthy),
        INVENTORY_DEGRADED: str(degraded),
    }
    total_chips = 0
    for bucket in ("gold", "silver", "degraded", "unclassed"):
        chips = state["capacity"].get(bucket, 0)
        total_chips += chips
        out[CAPACITY_PREFIX + bucket] = str(chips)
    out[CAPACITY_PREFIX + "total-chips"] = str(total_chips)
    out[FLEET_NODES] = str(state["nodes"])
    out[FLEET_PREEMPTING] = str(state["preempting"])
    out[MULTISLICE_GROUPS] = str(len(state["multislice"]))
    if state["matmul"].total > 0:
        out[FLEET_MATMUL_P10] = fixed3(state["matmul"].quantile(0.10))
        out[FLEET_MATMUL_P50] = fixed3(state["matmul"].quantile(0.50))
    if state["hbm"].total > 0:
        out[FLEET_HBM_P10] = fixed3(state["hbm"].quantile(0.10))
        out[FLEET_HBM_P50] = fixed3(state["hbm"].quantile(0.50))
    for name in SLO_STAGES:
        sketch = state["stage"].get(name)
        if sketch is None or sketch.total <= 0:
            continue
        base = OBS_STAGE_PREFIX + name
        out[base + ".p50-ms"] = fixed3(sketch.quantile(0.50))
        out[base + ".p99-ms"] = fixed3(sketch.quantile(0.99))
    return out


def serialize_sketch(sketch):
    """C++ SerializeSketch: sparse ascending ``bucket:count`` pairs
    joined by ',' ("" = empty)."""
    return ",".join(f"{i}:{n}" for i, n in enumerate(sketch.counts)
                    if n > 0)


def parse_sketch(text):
    """C++ ParseSketch: tolerant inverse (malformed pairs skipped)."""
    sketch = Sketch()
    for pair in (text or "").split(","):
        bucket, colon, count = pair.partition(":")
        if not colon or not bucket.isdigit() or not count.isdigit():
            continue
        sketch.add_bucket_count(int(bucket), int(count))
    return sketch


def serialize_partial_labels(state, shard_spec):
    """C++ SerializePartialLabels: the partial CR's label payload —
    the aggregate state under the AGG_* keys plus the tier marker and
    the "i/n" shard spec; empty maps/sketches omit their key."""
    out = {
        AGG_TIER: AGG_TIER_PARTIAL,
        AGG_SHARD: shard_spec,
        AGG_NODES: str(state["nodes"]),
        AGG_PREEMPTING: str(state["preempting"]),
    }
    if state["slices"]:
        out[AGG_SLICES] = ",".join(
            f"{sid}:{agg[0]}:{agg[1]}:{agg[2]}"
            for sid, agg in sorted(state["slices"].items()))
    if state["capacity"]:
        out[AGG_CAPACITY] = ",".join(
            f"{k}:{n}" for k, n in sorted(state["capacity"].items()))
    if state["multislice"]:
        out[AGG_MULTISLICE] = ",".join(
            f"{k}:{n}" for k, n in sorted(state["multislice"].items()))
    if state["matmul"].total > 0:
        out[AGG_MATMUL] = serialize_sketch(state["matmul"])
    if state["hbm"].total > 0:
        out[AGG_HBM] = serialize_sketch(state["hbm"])
    slo = serialize_stage_sketches(state["stage"])
    if slo:
        out[AGG_STAGE_SLO] = slo
    return out


def parse_partial_labels(labels):
    """C++ ParsePartialLabels: None when the tier marker is absent (the
    labels are not a partial); malformed fields are skipped, never
    fatal — the payload arrives from the wire."""
    if labels.get(AGG_TIER) != AGG_TIER_PARTIAL:
        return None
    state = rollup_state()
    for key, field in ((AGG_NODES, "nodes"), (AGG_PREEMPTING, "preempting")):
        raw = labels.get(key, "")
        if raw.isdigit():
            state[field] = int(raw)
    for entry in labels.get(AGG_SLICES, "").split(","):
        parts = entry.split(":")
        if len(parts) != 4 or not parts[0]:
            continue
        if not all(p.isdigit() for p in parts[1:]):
            continue
        state["slices"][parts[0]] = [int(p) for p in parts[1:]]
    for key, field in ((AGG_CAPACITY, "capacity"),
                       (AGG_MULTISLICE, "multislice")):
        for entry in labels.get(key, "").split(","):
            name, colon, count = entry.partition(":")
            if not colon or not name or not count.isdigit():
                continue
            state[field][name] = int(count)
    if AGG_MATMUL in labels:
        state["matmul"] = parse_sketch(labels[AGG_MATMUL])
    if AGG_HBM in labels:
        state["hbm"] = parse_sketch(labels[AGG_HBM])
    if AGG_STAGE_SLO in labels:
        state["stage"] = parse_stage_sketches(labels[AGG_STAGE_SLO])
    return state


class ShardMergeStore:
    """C++ ShardMergeStore twin: the L2 root's store — one RollupState
    per live shard plus the merged total, maintained O(delta per
    partial): apply retires the shard's previous partial (counter
    subtraction + sketch unmerge) and admits the new one. Root state is
    O(shards), never O(nodes)."""

    def __init__(self):
        self.partials = {}
        self.merged = rollup_state()
        self.events = 0
        self.full_recomputes = 0

    def _retire(self, p):
        m = self.merged
        m["nodes"] -= p["nodes"]
        m["preempting"] -= p["preempting"]
        for sid, agg in p["slices"].items():
            have = m["slices"].get(sid)
            if have is None:
                continue
            have[0] -= agg[0]
            have[1] -= agg[1]
            have[2] -= agg[2]
            if have[0] <= 0:
                del m["slices"][sid]
        for field in ("capacity", "multislice"):
            for key, n in p[field].items():
                if key not in m[field]:
                    continue
                m[field][key] -= n
                if m[field][key] <= 0:
                    del m[field][key]
        m["matmul"].unmerge(p["matmul"])
        m["hbm"].unmerge(p["hbm"])
        for stage, sketch in p["stage"].items():
            merged = m["stage"].get(stage)
            if merged is None:
                continue
            merged.unmerge(sketch)
            if merged.total <= 0:
                del m["stage"][stage]

    def _admit(self, p):
        m = self.merged
        m["nodes"] += p["nodes"]
        m["preempting"] += p["preempting"]
        for sid, agg in p["slices"].items():
            have = m["slices"].setdefault(sid, [0, 0, 0])
            have[0] += agg[0]
            have[1] += agg[1]
            have[2] += agg[2]
        for field in ("capacity", "multislice"):
            for key, n in p[field].items():
                m[field][key] = m[field].get(key, 0) + n
        m["matmul"].merge(p["matmul"])
        m["hbm"].merge(p["hbm"])
        for stage, sketch in p["stage"].items():
            m["stage"].setdefault(stage, Sketch()).merge(sketch)

    def apply_partial(self, shard, partial):
        """Returns True when the shard's partial changed (a rollup
        moved and a publish is owed) — equal partials are a no-op."""
        self.events += 1
        prev = self.partials.get(shard)
        if prev is not None:
            if prev == partial:
                return False
            self._retire(prev)
        self.partials[shard] = partial
        self._admit(partial)
        return True

    def remove_partial(self, shard):
        self.events += 1
        prev = self.partials.pop(shard, None)
        if prev is None:
            return False
        self._retire(prev)
        return True

    @property
    def stage_sketches(self):
        return self.merged["stage"]

    def build_output_labels(self):
        return build_rollup_labels(self.merged)

    def recompute_all(self):
        """Self-check ONLY — full_recomputes == 0 on every tier is the
        acceptance contract."""
        self.full_recomputes += 1
        self.merged = rollup_state()
        for p in self.partials.values():
            self._admit(p)


class InventoryStore:
    """C++ InventoryStore twin: incremental O(delta) rollups."""

    def __init__(self):
        self.nodes = {}
        self.slices = {}       # slice_id -> [members, degraded, preempting]
        self.capacity = {}     # class -> chips
        self.multislice = {}   # group -> members
        self.preempting_nodes = 0
        self.matmul = Sketch()
        self.hbm = Sketch()
        self.stage = {}        # stage -> merged fleet Sketch
        self.events = 0
        self.full_recomputes = 0

    def _retire(self, c):
        if c["slice_id"]:
            agg = self.slices.get(c["slice_id"])
            if agg is not None:
                agg[0] -= 1
                if c["slice_degraded"]:
                    agg[1] -= 1
                if c["preempting"]:
                    agg[2] -= 1
                if agg[0] <= 0:
                    del self.slices[c["slice_id"]]
        bucket = capacity_bucket(c["perf_class"])
        if bucket in self.capacity:
            self.capacity[bucket] -= c["chips"]
            if self.capacity[bucket] <= 0:
                del self.capacity[bucket]
        if c["multislice_group"]:
            group = c["multislice_group"]
            if group in self.multislice:
                self.multislice[group] -= 1
                if self.multislice[group] <= 0:
                    del self.multislice[group]
        if c["preempting"]:
            self.preempting_nodes -= 1
        if c["matmul_tflops"] >= 0:
            self.matmul.remove(c["matmul_tflops"])
        if c["hbm_gbps"] >= 0:
            self.hbm.remove(c["hbm_gbps"])
        if c["stage_slo"]:
            for stage, sketch in parse_stage_sketches(c["stage_slo"]).items():
                merged = self.stage.get(stage)
                if merged is None:
                    continue
                merged.unmerge(sketch)
                if merged.total <= 0:
                    del self.stage[stage]

    def _admit(self, c):
        if c["slice_id"]:
            agg = self.slices.setdefault(c["slice_id"], [0, 0, 0])
            agg[0] += 1
            if c["slice_degraded"]:
                agg[1] += 1
            if c["preempting"]:
                agg[2] += 1
        bucket = capacity_bucket(c["perf_class"])
        self.capacity[bucket] = self.capacity.get(bucket, 0) + c["chips"]
        if c["multislice_group"]:
            group = c["multislice_group"]
            self.multislice[group] = self.multislice.get(group, 0) + 1
        if c["preempting"]:
            self.preempting_nodes += 1
        if c["matmul_tflops"] >= 0:
            self.matmul.add(c["matmul_tflops"])
        if c["hbm_gbps"] >= 0:
            self.hbm.add(c["hbm_gbps"])
        if c["stage_slo"]:
            for stage, sketch in parse_stage_sketches(c["stage_slo"]).items():
                self.stage.setdefault(stage, Sketch()).merge(sketch)

    def apply(self, node, labels, stage_slo=""):
        """Returns True when the node's contribution changed (a rollup
        moved and a publish is owed)."""
        self.events += 1
        nxt = extract_contribution(labels, stage_slo)
        prev = self.nodes.get(node)
        if prev is not None:
            if prev == nxt:
                return False
            self._retire(prev)
        self.nodes[node] = nxt
        self._admit(nxt)
        return True

    def remove(self, node):
        self.events += 1
        prev = self.nodes.pop(node, None)
        if prev is None:
            return False
        self._retire(prev)
        return True

    def partial(self):
        """C++ InventoryStore::Partial: the store's whole aggregate
        state (live references) — what an L1 shard serializes into its
        partial CR via serialize_partial_labels."""
        return {
            "nodes": len(self.nodes),
            "preempting": self.preempting_nodes,
            "slices": self.slices,
            "capacity": self.capacity,
            "multislice": self.multislice,
            "matmul": self.matmul,
            "hbm": self.hbm,
            "stage": self.stage,
        }

    def build_output_labels(self):
        return build_rollup_labels(self.partial())

    def recompute_all(self):
        """Self-check ONLY: the steady path never rebuilds (the soak
        gates full_recomputes == 0 after sync)."""
        self.full_recomputes += 1
        self.slices = {}
        self.capacity = {}
        self.multislice = {}
        self.preempting_nodes = 0
        self.matmul = Sketch()
        self.hbm = Sketch()
        self.stage = {}
        for c in self.nodes.values():
            self._admit(c)


class FlushController:
    """C++ FlushController twin: the FIRST dirtying event opens a window
    of debounce_s; everything inside it rides the same flush (bounded
    staleness, not a quiet-period timer)."""

    def __init__(self, debounce_s):
        self.debounce_s = debounce_s
        self.dirty_since = None

    def note_dirty(self, now):
        if self.dirty_since is None:
            self.dirty_since = now

    @property
    def dirty(self):
        return self.dirty_since is not None

    def due_at(self):
        if self.dirty_since is None:
            return float("inf")
        return self.dirty_since + self.debounce_s

    def should_flush(self, now):
        return self.dirty and now >= self.due_at()

    def note_flushed(self):
        self.dirty_since = None

    def rearm(self, since):
        """Restore a consumed window after a failed publish: the retry
        owes the ORIGINAL staleness, so an event that dirtied the
        controller mid-publish never shortens it."""
        if self.dirty_since is None or since < self.dirty_since:
            self.dirty_since = since
