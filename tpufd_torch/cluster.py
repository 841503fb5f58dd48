"""The port's own copy of ``tpufd.cluster`` (``tpufd/cluster.py``), kept
equal to it and importing nothing of ``tpufd``.

The cluster-in-a-box placement layer: a label-driven toy
scheduler, the synthetic job/workload model, and the failure-schedule
grammar the end-to-end placement-quality harness
(scripts/cluster_soak.py) drives.

The scheduler is deliberately a TOY — a few hundred lines, no
bin-packing research — but its information diet is the PRODUCT contract
this repo exists to prove: it sees ONLY labels published through the
apiserver (per-node NodeFeature labels and the aggregator's
cluster-inventory object), NEVER the simulation's ground truth. If the
labels are late, wrong, or missing, the scheduler places jobs on dying
hardware and the harness counts it. That makes "the published
google.com/tpu.* labels make placement measurably better under
failure" a number instead of a slogan.

The labels-only contract is structural, not advisory: SimScheduler
holds no reference to any simulation object — state enters exclusively
through on_event()/on_inventory() (the watch-event surface), and the
ground-truth-leak test in tests/test_cluster.py flips sim-internal
state WITHOUT a label change and asserts placement does not move.

Everything here is pure and deterministic (sorted iteration, no wall
clock, no ambient randomness): the same event sequence always yields
the same placements, which is what lets the soak pin byte-identical
metrics across two runs of one seed.
"""

import re

from tpufd_torch import agg as agglib
from tpufd_torch import placement as placementlib

PREFIX = "google.com/"

# The label diet — every key the scheduler is allowed to read. Shared
# with the aggregator twin where the aggregator also consumes them.
SLICE_ID = agglib.SLICE_ID
SLICE_DEGRADED = agglib.SLICE_DEGRADED
SLICE_CLASS = PREFIX + "tpu.slice.class"
SLICE_HEALTHY_HOSTS = PREFIX + "tpu.slice.healthy-hosts"
PERF_CLASS = agglib.PERF_CLASS
TPU_COUNT = agglib.TPU_COUNT
LIFECYCLE_PREEMPT = agglib.LIFECYCLE_PREEMPT
LIFECYCLE_DRAINING = agglib.LIFECYCLE_DRAINING
CAPACITY_PREFIX = agglib.CAPACITY_PREFIX

# The simulation's stand-in for the CR change-id annotation
# (tpufd_torch.sink.CHANGE_ANNOTATION / obs/trace.h): the sim apiserver
# models objects as label dicts, so the causal change-id rides as one
# more key. The scheduler's eligibility diet (below) never reads it —
# the same annotations-not-labels contract the real daemon keeps.
CHANGE_KEY = PREFIX + "tfd.change"

# The stage-SLO annotation analogue (obs/slo.h kSloAnnotation /
# "tfd.google.com/stage-slo"): each sim daemon's serialized windowed
# stage sketches ride this key; the aggregator merges them into the
# fleet view exactly like the real runner. The scheduler never reads
# it either.
SLO_KEY = PREFIX + "tfd.stage-slo"

# How a sim daemon folds a closed causal chain's CHAIN_STAGES durations
# into the node SLO stage vocabulary (tpufd_torch.agg.SLO_STAGES): "hold" is
# the governor/render think-time before the write attempt (the node's
# "plan" window), "fanout" the pure-wire span ("render"'s CPU-bound
# analogue), chain "publish" the attempt-to-landed span, and
# "publish-acked" the landed write plus its delivery tail. The SLO
# budget table (tpufd_torch.agg.SLO_STAGE_BUDGETS_MS) is derived from the
# SAME correspondence — bench_gate --slo cross-checks both.
SLO_STAGE_SOURCES = {
    "plan": ("hold",),
    "render": ("fanout",),
    "publish": ("publish",),
    "publish-acked": ("publish", "fanout"),
}


def slo_stage_durations(chain_stages):
    """Maps one closed chain's per-stage durations (ms, CHAIN_STAGES
    keys) onto the node SLO stages a sim daemon sketches."""
    return {stage: sum(chain_stages[s] for s in sources)
            for stage, sources in sorted(SLO_STAGE_SOURCES.items())}

# Perf-class ordering: the scheduler prefers the best class that still
# clears the job's floor. Absent/unknown ranks 0 (unclassed hardware is
# only placeable by jobs with no class floor), degraded is NEVER
# placeable regardless of floor.
CLASS_RANK = {"gold": 3, "silver": 2, "degraded": 1}

# Job class floors -> minimum acceptable rank.
JOB_CLASS_RANK = {"gold": 3, "silver": 2, "any": 0}

# The closed rejection taxonomy — shared with the serving
# twins so the SimScheduler's explanations are pinned to the exact
# strings the C++ service and tpufd_torch.placement emit.
REJECTION_REASONS = placementlib.REJECTION_REASONS
MAX_EXPLAIN_CHANGE_IDS = placementlib.MAX_EXPLAIN_CHANGE_IDS


def class_rank(labels):
    return CLASS_RANK.get(labels.get(PERF_CLASS, ""), 0)


def preempting(labels):
    return (labels.get(LIFECYCLE_PREEMPT) == "true" or
            labels.get(LIFECYCLE_DRAINING) == "true")


def basic_eligible(labels):
    """Can this node host ANY job, judging purely from its published
    labels? (Capacity is a separate, per-job check.) The transitions of
    this predicate are what the harness timestamps: ground-truth event
    -> basic_eligible flips = label-to-placement latency."""
    if labels is None:
        return False
    if labels.get(PERF_CLASS) == "degraded":
        return False
    if labels.get(SLICE_DEGRADED) == "true":
        return False
    if labels.get(SLICE_CLASS) == "degraded":
        return False
    if preempting(labels):
        return False
    return True


def basic_reason(labels):
    """The FIRST taxonomy reason this node's own labels make it
    basic-ineligible, "" when basic-eligible (None-tolerant wrapper over
    tpufd_torch.placement.basic_reason — the sim view stores None for deleted
    nodes)."""
    if labels is None:
        return ""
    return placementlib.basic_reason(labels)


def node_eligible(labels, min_rank):
    if not basic_eligible(labels):
        return False
    return class_rank(labels) >= min_rank


def slice_blocked_ids(view):
    """Slice ids any member's published labels mark degraded. The
    worst-of-members rule exists because a PARTITIONED member cannot
    write its own demotion (the partition severs its sink — the
    partition tradeoff): its node object holds stale-good labels, and the only
    label evidence that its slice is unsafe is the degraded verdict its
    still-connected peers publish. A labels-only scheduler therefore
    keys slice eligibility on the worst published claim across the
    slice's members, not on each node's own copy."""
    blocked = set()
    for labels in view.values():
        sid = labels.get(SLICE_ID, "")
        if not sid:
            continue
        if (labels.get(SLICE_DEGRADED) == "true" or
                labels.get(SLICE_CLASS) == "degraded"):
            blocked.add(sid)
    return blocked


class Job:
    """One synthetic workload unit: `wanted` names the perf-class floor
    ("gold" / "silver" / "any"), `chips` how much of a node it occupies,
    `duration_s` how long it runs once landed."""

    __slots__ = ("job_id", "wanted", "chips", "duration_s")

    def __init__(self, job_id, wanted, chips, duration_s):
        if wanted not in JOB_CLASS_RANK:
            raise ValueError(f"unknown job class {wanted!r}")
        self.job_id = job_id
        self.wanted = wanted
        self.chips = chips
        self.duration_s = duration_s

    @property
    def min_rank(self):
        return JOB_CLASS_RANK[self.wanted]


class Decision:
    """One placement decision: node is None when nothing placeable
    (reason 'no-capacity' = the inventory admission gate said the
    cluster has no chips of the wanted class; 'no-candidate' = the
    per-node scan found nothing eligible with room). `explain` carries
    the rejection-taxonomy walk (SimScheduler.explain_decision) when the
    caller asked for it, None otherwise."""

    __slots__ = ("job_id", "node", "reason", "at", "explain")

    def __init__(self, job_id, node, reason, at):
        self.job_id = job_id
        self.node = node
        self.reason = reason
        self.at = at
        self.explain = None

    @property
    def placed(self):
        return self.node is not None


class SimScheduler:
    """The label-driven toy scheduler.

    Inputs (the ONLY inputs):
      on_event(node, labels)   — a NodeFeature watch event (labels=None
                                 for DELETED); returns the
                                 basic-eligibility transition tuple.
      on_inventory(labels)     — the aggregator's cluster-inventory
                                 object (capacity-by-class admission).

    place(job, now) scans the view deterministically: among eligible
    nodes with room, prefer the highest perf class, then the emptiest
    node (spread), then lexicographic node name (the determinism
    tiebreak). Jobs whose node turns ineligible are surfaced by
    drain_ineligible() for the caller to re-queue — the
    preemption-aware migration the lifecycle labels exist to drive.
    """

    # The serving ring's default capacity (placement::DecisionRing /
    # --placement-audit-capacity).
    RING_CAPACITY = 256

    def __init__(self):
        self.view = {}         # node -> published labels
        self.inventory = {}    # the rollup object's labels (may be {})
        self.placements = {}   # job_id -> (node, chips)
        self.node_used = {}    # node -> chips allocated
        self.decisions = 0
        self.placed_total = 0
        self.no_candidate_total = 0
        self.no_capacity_total = 0
        # Placement explainability: the decision audit ring
        # (bounded, drop-oldest — the sim analogue of the service's
        # /v1/decisions ring) and the per-reason rejection rollup the
        # soak folds into tfd_placement_rejections_total's twin.
        self.ring = []
        self.ring_capacity = self.RING_CAPACITY
        self.ring_seq = 0
        self.ring_dropped = 0
        self.explained_total = 0
        self.rejections_total = {}  # reason -> rejected-node count
        self.evicted_total = 0
        # Claims severed by a node DELETE, captured at the event so the
        # eviction survives the node re-appearing before the next drain
        # pass (job_id -> change-id of the deleted node object).
        self.deleted_claims = {}

    # ---- label surface ---------------------------------------------------

    def on_event(self, node, labels):
        """One watch event. Returns (was_eligible, now_eligible) so the
        harness can timestamp eligibility transitions without reaching
        into scheduler internals."""
        was = basic_eligible(self.view.get(node))
        if labels is None:
            old = self.view.pop(node, None)
            if old is not None:
                # A claim dies with its node object. Record every
                # placement the delete severed — a re-created node of
                # the same name is NEW hardware and must not inherit
                # the old object's used-chip accounting.
                change = old.get(CHANGE_KEY, "")
                for job_id, (placed_node, _) in self.placements.items():
                    if placed_node == node:
                        self.deleted_claims[job_id] = change
        else:
            self.view[node] = dict(labels)
        now_el = basic_eligible(self.view.get(node))
        return was, now_el

    def on_inventory(self, labels):
        self.inventory = dict(labels or {})

    # ---- bookkeeping -----------------------------------------------------

    def _free_chips(self, node, labels):
        try:
            cap = int(labels.get(TPU_COUNT, "0"))
        except ValueError:
            cap = 0
        return cap - self.node_used.get(node, 0)

    def admit(self, job):
        """Cluster-level admission from the aggregator's capacity-by-
        class rollup: don't scan 10k nodes for a gold job when the
        inventory says the cluster owns zero gold chips. An empty
        inventory (aggregator not synced yet) admits everything — the
        per-node scan stays the source of truth."""
        if not self.inventory:
            return True
        chips = 0
        for bucket, rank in (("gold", 3), ("silver", 2), ("unclassed", 0)):
            if rank >= job.min_rank:
                raw = self.inventory.get(CAPACITY_PREFIX + bucket, "0")
                chips += int(raw) if raw.isdigit() else 0
        return chips >= job.chips

    def placeable(self, node, blocked=None):
        """basic_eligible plus the slice worst-of-members rule; capacity
        is a per-job concern, not part of placeability. The harness
        timestamps transitions of THIS predicate: ground-truth event ->
        placeable() flips = label-to-placement latency.

        `blocked` takes a precomputed slice_blocked_ids(self.view) so a
        caller checking many nodes against one view (drain, latency
        trackers) pays the O(nodes) blocked-set scan once, not per
        node."""
        labels = self.view.get(node)
        if not basic_eligible(labels):
            return False
        sid = labels.get(SLICE_ID, "")
        if not sid:
            return True
        if blocked is None:
            blocked = slice_blocked_ids(self.view)
        return sid not in blocked

    def place(self, job, now, explain=False):
        self.decisions += 1
        if not self.admit(job):
            self.no_capacity_total += 1
            decision = Decision(job.job_id, None, "no-capacity", now)
            return self._close_decision(decision, job, explain)
        blocked = slice_blocked_ids(self.view)
        best = None
        best_key = None
        for node in sorted(self.view):
            labels = self.view[node]
            if not node_eligible(labels, job.min_rank):
                continue
            if labels.get(SLICE_ID, "") in blocked:
                continue
            free = self._free_chips(node, labels)
            if free < job.chips:
                continue
            key = (-class_rank(labels), -free, node)
            if best_key is None or key < best_key:
                best, best_key = node, key
        if best is None:
            self.no_candidate_total += 1
            decision = Decision(job.job_id, None, "no-candidate", now)
            return self._close_decision(decision, job, explain)
        self.placements[job.job_id] = (best, job.chips)
        self.node_used[best] = self.node_used.get(best, 0) + job.chips
        self.placed_total += 1
        decision = Decision(job.job_id, best, "placed", now)
        return self._close_decision(decision, job, explain)

    # ---- placement explainability -----------------------------------------

    def _ring_push(self, record):
        record["seq"] = self.ring_seq
        self.ring_seq += 1
        self.ring.append(record)
        if len(self.ring) > self.ring_capacity:
            self.ring.pop(0)
            self.ring_dropped += 1

    def _close_decision(self, decision, job, explain):
        record = {
            "t": decision.at,
            "outcome": "placed" if decision.placed else "rejected",
            "job": decision.job_id,
            "query": {"class": job.wanted, "chips": job.chips},
            "node": decision.node or "",
            "reason": "" if decision.placed else decision.reason,
        }
        if explain:
            self.explained_total += 1
            decision.explain = self.explain_decision(job, decision)
            for reason in sorted(decision.explain["reasons"]):
                self.rejections_total[reason] = \
                    self.rejections_total.get(reason, 0) + \
                    decision.explain["reasons"][reason]
            record["reasons"] = dict(decision.explain["reasons"])
            record["change_ids"] = list(decision.explain["change_ids"])
        self._ring_push(record)
        return decision

    def _first_claimers(self):
        """slice id -> its lexicographically-first member whose
        published labels claim the slice degraded (the blocking member
        an explanation names — same pick as the serving twins)."""
        first = {}
        for node in sorted(self.view):
            labels = self.view[node]
            sid = labels.get(SLICE_ID, "")
            if not sid or sid in first:
                continue
            if (labels.get(SLICE_DEGRADED) == "true" or
                    labels.get(SLICE_CLASS) == "degraded"):
                first[sid] = node
        return first

    def explain_decision(self, job, decision):
        """The rejection-taxonomy walk for one already-made decision,
        in the serving twins' pinned FIRST-reason precedence
        (tpufd_torch.placement.PlacementIndex.explain): capacity-admission
        (query-wide), the node's own basic_reason, class-floor, a
        peer's degraded-slice claim (naming the blocking member),
        insufficient-chips. Two sim-side deltas from the allocation-free
        index: free chips are allocation-aware (capacity minus
        node_used — the sim owns its bookkeeping), and the rejection
        list is NOT capped at the serving twins' inline sample bound
        (the harness scores attribution fidelity over the full walk).
        `blocking` is the counterfactual's reason name ("" when placed)
        — the queue-wait attribution hook."""
        admitted = decision.reason != "no-capacity"
        blocked = slice_blocked_ids(self.view)
        first_claimer = self._first_claimers()
        reasons = {}
        rejections = []
        change_ids = set()
        best = None  # (rank, free, node, rejection)
        for node in sorted(self.view):
            if node == decision.node:
                continue
            labels = self.view[node]
            free = self._free_chips(node, labels)
            rejection = {"node": node, "reason": ""}
            change = labels.get(CHANGE_KEY, "")
            member = ""
            if not admitted:
                rejection["reason"] = "capacity-admission"
                change = self.inventory.get(CHANGE_KEY, "")
            else:
                reason = basic_reason(labels)
                if reason:
                    rejection["reason"] = reason
                    if reason == "slice-member-degraded":
                        member = node  # its own claim blocks it
                elif class_rank(labels) < job.min_rank:
                    rejection["reason"] = "class-floor"
                else:
                    sid = labels.get(SLICE_ID, "")
                    if sid and sid in blocked:
                        rejection["reason"] = "slice-member-degraded"
                        member = first_claimer.get(sid, "")
                        change = self.view.get(member, {}).get(
                            CHANGE_KEY, "") if member else ""
                    elif free < job.chips:
                        rejection["reason"] = "insufficient-chips"
                    else:
                        continue  # viable, just not preferred
            if member:
                rejection["member"] = member
            if change:
                rejection["change"] = change
                change_ids.add(change)
            reason = rejection["reason"]
            reasons[reason] = reasons.get(reason, 0) + 1
            rejections.append(rejection)
            rank = class_rank(labels)
            if (best is None or (rank, free) > (best[0], best[1]) or
                    ((rank, free) == (best[0], best[1]) and
                     node < best[2])):
                best = (rank, free, node, rejection)
        out = {"reasons": reasons, "rejected": len(rejections),
               "rejections": rejections, "counterfactual": "",
               "change_ids": sorted(change_ids)[:MAX_EXPLAIN_CHANGE_IDS],
               "blocking": ""}
        if decision.placed:
            return out
        if decision.reason == "no-capacity":
            text = (f"capacity-admission: inventory admits fewer than "
                    f"{job.chips} chip(s) at class floor {job.wanted}")
            change = self.inventory.get(CHANGE_KEY, "")
            if change:
                text += f" (change {change})"
            out["counterfactual"] = text
            out["blocking"] = "capacity-admission"
            return out
        if best is None:
            out["counterfactual"] = "no candidate nodes in index"
            out["blocking"] = "no-nodes"
            return out
        _, free, node, rejection = best
        reason = rejection["reason"]
        out["blocking"] = reason
        if reason == "insufficient-chips":
            text = (f"insufficient-chips: needs {job.chips - free} more "
                    f"free chip(s); best node {node} has {free} free")
        elif reason == "class-floor":
            cls = self.view[node].get(PERF_CLASS, "") or "unclassed"
            text = (f"class-floor: needs class >= {job.wanted}; "
                    f"best node {node} is {cls}")
        elif reason == "slice-member-degraded":
            sid = self.view[node].get(SLICE_ID, "")
            text = (f"slice-member-degraded: slice {sid} blocked by "
                    f"member {rejection['member']}'s degraded-slice "
                    f"verdict")
        else:
            # perf-degraded / lifecycle-preempt / lifecycle-draining.
            text = (f"{reason}: best node {node} is blocked by its "
                    f"own labels")
        if rejection.get("change"):
            text += f" (change {rejection['change']})"
        out["counterfactual"] = text
        return out

    def release(self, job_id):
        """Job finished (or failed on bad hardware): free its chips."""
        placed = self.placements.pop(job_id, None)
        if placed is None:
            return None
        self.deleted_claims.pop(job_id, None)
        node, chips = placed
        used = self.node_used.get(node, 0) - chips
        if used > 0:
            self.node_used[node] = used
        else:
            self.node_used.pop(node, None)
        return node

    def node_of(self, job_id):
        placed = self.placements.get(job_id)
        return placed[0] if placed else None

    def drain_ineligible(self, now=0.0):
        """Jobs running on nodes whose published labels now say 'stop':
        released here and returned (sorted) for the caller to re-queue —
        the label-driven eviction path (preempt-imminent, slice
        degraded, perf demotion, node object deleted). Each evicted
        node closes an "evicted" audit-ring record carrying the
        taxonomy reason that doomed it and the change-id of the label
        write that created the condition (the serving ring's
        DecisionRing::EvictNode analogue)."""
        blocked = slice_blocked_ids(self.view)
        severed = {job_id: change
                   for job_id, change in self.deleted_claims.items()
                   if job_id in self.placements}
        doomed = sorted(
            set(severed) | {
                job_id for job_id, (node, _) in self.placements.items()
                if not self.placeable(node, blocked)})
        by_node = {}
        for job_id in doomed:
            by_node.setdefault(self.placements[job_id][0],
                               []).append(job_id)
            self.release(job_id)
        first_claimer = None
        for node in sorted(by_node):
            labels = self.view.get(node)
            # Claims a node DELETE severed are evicted as "deleted"
            # even when the node re-appeared before this drain ran: the
            # claim died with the old node object (change-ids captured
            # at the delete), and only the re-created object's own
            # claims — if any — are judged against its current labels.
            dead = [j for j in by_node[node] if j in severed]
            if dead:
                self.evicted_total += 1
                self._ring_push({
                    "t": now, "outcome": "evicted", "node": node,
                    "reason": "deleted", "jobs": dead,
                    "change_ids": sorted(
                        {severed[j] for j in dead if severed[j]})})
            live = [j for j in by_node[node] if j not in severed]
            if not live:
                continue
            if labels is None:
                reason, change = "deleted", ""
            else:
                reason = basic_reason(labels)
                change = labels.get(CHANGE_KEY, "")
                if not reason:
                    # Basic-eligible but unplaceable: a peer's
                    # degraded-slice claim evicted it.
                    reason = "slice-member-degraded"
                    if first_claimer is None:
                        first_claimer = self._first_claimers()
                    member = first_claimer.get(
                        labels.get(SLICE_ID, ""), "")
                    change = self.view.get(member, {}).get(
                        CHANGE_KEY, "") if member else ""
            self.evicted_total += 1
            self._ring_push({
                "t": now, "outcome": "evicted", "node": node,
                "reason": reason, "jobs": live,
                "change_ids": [change] if change else []})
        return doomed


# ---- causal change tracking (the sim half of obs/trace.h) ------------------

# The placement-critical causal chain, in pipeline order. Each closed
# change's stage durations PARTITION its end-to-end latency exactly:
#   detect   — ground-truth event -> the pipeline first KNOWS (probe
#              round for self-detectable ops; report ageing past the
#              agreement timeout for wedge/partition)
#   agree    — detection -> the slice verdict reflecting it is adopted
#              (includes lease-expiry failover when the leader died)
#   hold     — adoption -> a member's publish ATTEMPT (render/coalesce
#              delay — the sim's governor-hold analogue)
#   publish  — attempt -> the write LANDS in the apiserver store
#              (includes brownout Retry-After deferrals)
#   fanout   — store -> the scheduler's watch delivery
#   schedule — delivery -> the placeable() verdict actually flips
#              (absorbs any unstamped remainder, so the partition sums
#              exactly)
# The aggregator's inventory channel (agg-debounce) is measured
# separately: it parallels this chain rather than gating the flip.
CHAIN_STAGES = ("detect", "agree", "hold", "publish", "fanout",
                "schedule")


class ChangeTracker:
    """Mints one monotone change-id per injected ground-truth failure
    and accumulates the stage timestamps the simulation stamps as the
    change propagates daemon -> apiserver -> scheduler. close() turns
    the stamps into CHAIN_STAGES durations that sum EXACTLY to the
    end-to-end label-to-placement latency (stamps are clamped monotone;
    the terminal stage absorbs any unstamped remainder) — the
    sum-consistency contract bench_gate --cluster enforces.

    Deterministic by construction: ids are minted in event order, all
    state is plain dicts, and serialization sorts — so the soak's
    double-run byte-identity pin covers the tracker too."""

    def __init__(self):
        self.next_change = 1
        self.open_by_node = {}   # victim node -> open change id
        self.records = {}        # change id -> {op, node, t0, stamps}
        self.closed = []         # closed chains, close order
        self.discarded = 0       # heal raced the pipeline; chain dropped
        self.label_events_joined = 0    # watch deliveries carrying a
                                        # known change id (CHANGE_KEY)
        self.inventory_joined = 0       # inventory rollups carrying one

    def mint(self, op, node, t):
        change = self.next_change
        self.next_change += 1
        # A refail over a still-open change replaces it (the harness's
        # note_down already re-tracks the victim from the new t0).
        old = self.open_by_node.get(node)
        if old is not None:
            self.records.pop(old, None)
            self.discarded += 1
        self.records[change] = {"change": change, "op": op, "node": node,
                                "t0": t, "stamps": {}}
        self.open_by_node[node] = change
        return change

    def open_change(self, node):
        return self.open_by_node.get(node)

    def stamp(self, change, stage, t):
        """First-wins stage stamp (a later duplicate — a second member
        republish, a brownout retry — never moves an earlier mark)."""
        record = self.records.get(change)
        if record is None or stage in record["stamps"]:
            return
        record["stamps"][stage] = t

    def stamp_node(self, node, stage, t):
        change = self.open_by_node.get(node)
        if change is not None:
            self.stamp(change, stage, t)

    def known(self, change):
        return change in self.records

    def discard(self, node):
        """The heal raced the label pipeline (the harness dropped its
        down-track entry): the chain can never close — drop it."""
        change = self.open_by_node.pop(node, None)
        if change is not None:
            self.records.pop(change, None)
            self.discarded += 1

    def close(self, node, t_flip):
        """The scheduler's placeable() verdict flipped for the victim:
        convert stamps into CHAIN_STAGES durations (ms). Clamps each
        stamp into [previous stamp, t_flip] so the durations are
        non-negative and sum exactly to t_flip - t0; a missing stamp
        contributes 0 and its budget folds into the next stage."""
        change = self.open_by_node.pop(node, None)
        record = self.records.pop(change, None) if change else None
        if record is None:
            return None
        prev = record["t0"]
        durations = {}
        for stage in CHAIN_STAGES[:-1]:
            ts = record["stamps"].get(stage)
            if ts is None:
                durations[stage] = 0.0
                continue
            ts = min(max(ts, prev), t_flip)
            durations[stage] = (ts - prev) * 1000.0
            prev = ts
        durations[CHAIN_STAGES[-1]] = (t_flip - prev) * 1000.0
        closed = {"change": record["change"], "op": record["op"],
                  "node": node, "e2e_ms": (t_flip - record["t0"]) * 1000.0,
                  "stages": durations}
        self.closed.append(closed)
        return closed

    def active(self):
        return len(self.open_by_node)


def stage_breakdown(closed, percentile, stages=None):
    """Aggregates closed chains into the record's per-failure-class
    stage table: for each op, per-stage p50/p99 (ms) + the
    sum-consistency fields bench_gate checks — stage_p99_sum_ms vs
    e2e_p99_ms per class, and mean_stage_sum_ms == mean_e2e_ms exactly
    (the partition property). `percentile` is injected (the soak's
    helper) so this module stays dependency-light. `stages` defaults to
    the placement CHAIN_STAGES; the remediation scorecard passes
    remedy.REMEDY_STAGES (detect -> decide -> act -> acked) and reuses
    the identical aggregation + sum-consistency contract."""
    stage_names = CHAIN_STAGES if stages is None else tuple(stages)
    by_op = {}
    for chain in closed:
        by_op.setdefault(chain["op"], []).append(chain)
    out = {}
    for op in sorted(by_op):
        chains = by_op[op]
        stages = {}
        p99_sum = 0.0
        mean_sum = 0.0
        for stage in stage_names:
            values = [c["stages"][stage] for c in chains]
            p50 = percentile(values, 50)
            p99 = percentile(values, 99)
            stages[stage] = {"p50_ms": round(p50, 3),
                             "p99_ms": round(p99, 3)}
            p99_sum += p99
            mean_sum += sum(values) / len(values)
        e2e = [c["e2e_ms"] for c in chains]
        out[op] = {
            "n": len(chains),
            "stages": stages,
            "stage_p99_sum_ms": round(p99_sum, 3),
            "e2e_p50_ms": round(percentile(e2e, 50), 3),
            "e2e_p99_ms": round(percentile(e2e, 99), 3),
            "mean_stage_sum_ms": round(mean_sum, 3),
            "mean_e2e_ms": round(sum(e2e) / len(e2e), 3),
        }
    return out


# ---- failure-schedule grammar ---------------------------------------------
#
# One event per line:   <at_seconds> <op> <target> [key=value ...]
# Blank lines and #-comments skipped. Targets:
#   sNN/hMM    one host         (degrade/heal/wedge/unwedge/preempt/
#                                preempt-clear/asym-partition/asym-heal)
#   sNN        one slice        (leader-kill/leader-restart/partition/
#                                heal-partition)
#   apiserver  the control plane (brownout secs=N; slowdown secs=N
#                                 delay=D — every publish ACK in the
#                                 window returns D s late, the SLO
#                                 engine's latency-regression drill)
# partition takes hosts=A-B (the member index range that loses
# connectivity). asym-partition severs ONE host from the apiserver
# while its peers can still reach it (the relay/hedge drill:
# the slice must NOT degrade and the member's labels keep flowing via
# the leader's hedged publish). The full semantics table lives in
# docs/placement-harness.md.
#
# Failure DOMAINS (the remediation controller's domain-cap
# interlock) are declared inline and then targeted as a unit:
#   domain rack-a hosts=s0/h0,s1/h2,s2/h1     # declaration, no time
#   30 domain-fail rack-a                     # every member partitions
#   60 domain-heal rack-a
# A domain must be declared BEFORE the first event that targets it, a
# member must be sNN/hMM, and an undeclared/typo'd name fails the parse
# loudly — a quiet skip would soak nothing and gate everything.

HOST_OPS = {"degrade", "heal", "wedge", "unwedge", "preempt",
            "preempt-clear", "asym-partition", "asym-heal"}
SLICE_OPS = {"leader-kill", "leader-restart", "partition",
             "heal-partition"}
SERVER_OPS = {"brownout", "slowdown"}
DOMAIN_OPS = {"domain-fail", "domain-heal"}

_TARGET_HOST = re.compile(r"^s(\d+)/h(\d+)$")
_TARGET_SLICE = re.compile(r"^s(\d+)$")
_DOMAIN_NAME = re.compile(r"^[A-Za-z][A-Za-z0-9_-]*$")


class ScheduleEvent:
    __slots__ = ("at", "op", "slice_idx", "host_idx", "args", "line")

    def __init__(self, at, op, slice_idx, host_idx, args, line):
        self.at = at
        self.op = op
        self.slice_idx = slice_idx
        self.host_idx = host_idx
        self.args = args
        self.line = line

    def target(self):
        if self.op in SERVER_OPS:
            return "apiserver"
        if self.op in DOMAIN_OPS:
            return self.args["domain"]
        if self.host_idx is not None:
            return f"s{self.slice_idx:02d}/h{self.host_idx:02d}"
        return f"s{self.slice_idx:02d}"


def parse_schedule_with_domains(text):
    """Parses the failure-schedule grammar into (events, domains):
    ScheduleEvents sorted by (time, line order), plus the declared
    failure domains as {name: [(slice_idx, host_idx), ...]}. Raises
    ValueError naming the offending line — a silent skip would turn a
    typo'd chaos schedule into a quiet soak that gates nothing."""
    events = []
    domains = {}
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = raw.split("#", 1)[0].strip()
        if not line:
            continue
        parts = line.split()
        if parts[0] == "domain":
            # Declaration line: domain <name> hosts=s0/h0,s1/h2,...
            if len(parts) != 3 or not parts[2].startswith("hosts="):
                raise ValueError(
                    f"schedule line {lineno}: want 'domain <name> "
                    f"hosts=sA/hB,...', got {raw!r}")
            name = parts[1]
            if not _DOMAIN_NAME.match(name):
                raise ValueError(
                    f"schedule line {lineno}: bad domain name {name!r}")
            if name in domains:
                raise ValueError(
                    f"schedule line {lineno}: duplicate domain {name!r}")
            members = []
            spec = parts[2][len("hosts="):]
            for item in spec.split(",") if spec else []:
                m = _TARGET_HOST.match(item)
                if not m:
                    raise ValueError(
                        f"schedule line {lineno}: domain member "
                        f"{item!r} is not sNN/hMM")
                members.append((int(m.group(1)), int(m.group(2))))
            if not members:
                raise ValueError(
                    f"schedule line {lineno}: domain {name!r} has no "
                    f"members")
            domains[name] = members
            continue
        if len(parts) < 3:
            raise ValueError(
                f"schedule line {lineno}: want '<at> <op> <target>', "
                f"got {raw!r}")
        try:
            at = float(parts[0])
        except ValueError:
            raise ValueError(
                f"schedule line {lineno}: bad time {parts[0]!r}")
        op, target = parts[1], parts[2]
        args = {}
        for extra in parts[3:]:
            key, sep, value = extra.partition("=")
            if not sep:
                raise ValueError(
                    f"schedule line {lineno}: want key=value, "
                    f"got {extra!r}")
            args[key] = value
        slice_idx = host_idx = None
        if op in HOST_OPS:
            m = _TARGET_HOST.match(target)
            if not m:
                raise ValueError(
                    f"schedule line {lineno}: op {op} wants a "
                    f"sNN/hMM target, got {target!r}")
            slice_idx, host_idx = int(m.group(1)), int(m.group(2))
        elif op in SLICE_OPS:
            m = _TARGET_SLICE.match(target)
            if not m:
                raise ValueError(
                    f"schedule line {lineno}: op {op} wants a sNN "
                    f"target, got {target!r}")
            slice_idx = int(m.group(1))
        elif op in SERVER_OPS:
            if target != "apiserver":
                raise ValueError(
                    f"schedule line {lineno}: op {op} wants the "
                    f"'apiserver' target, got {target!r}")
        elif op in DOMAIN_OPS:
            if target not in domains:
                raise ValueError(
                    f"schedule line {lineno}: op {op} targets "
                    f"undeclared domain {target!r} (declare it first "
                    f"with 'domain {target} hosts=...')")
            args["domain"] = target
        else:
            raise ValueError(f"schedule line {lineno}: unknown op {op!r}")
        events.append(ScheduleEvent(at, op, slice_idx, host_idx, args,
                                    lineno))
    events.sort(key=lambda e: (e.at, e.line))
    return events, domains


def parse_schedule(text):
    """Back-compat wrapper: events only, domain declarations allowed
    but discarded."""
    events, _ = parse_schedule_with_domains(text)
    return events


def parse_host_range(args, member_count):
    """partition hosts=A-B -> the sorted member indexes inside the
    slice that lose connectivity (default: the lower half)."""
    spec = args.get("hosts")
    if spec is None:
        return list(range(member_count // 2))
    m = re.match(r"^(\d+)-(\d+)$", spec)
    if not m:
        raise ValueError(f"bad hosts range {spec!r} (want A-B)")
    lo, hi = int(m.group(1)), int(m.group(2))
    if lo > hi or hi >= member_count:
        raise ValueError(
            f"hosts range {spec!r} outside 0-{member_count - 1}")
    return list(range(lo, hi + 1))
