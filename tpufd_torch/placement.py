"""The port's own copy of ``tpufd.placement`` (``tpufd/placement.py``),
kept equal to it and importing nothing of ``tpufd``.

Placement query index — the parity twin of src/tfd/placement/.

The C++ service answers `POST /v1/placements` from an informer-fed
in-memory index over NodeFeature CRs; this module is the same index in
Python, bit-for-bit on the eligibility contract, so the cluster soak can
drive it at fleet scale (100k nodes) on the virtual clock and score
served placements against the SimScheduler ground truth
(tpufd_torch/cluster.py), and so tests can pin the twin against the real
binary's HTTP responses.

The eligibility contract (tpufd_torch.cluster, replicated by both sides):

  - basic eligibility: perf class not "degraded", own slice labels not
    degraded, not preempting/draining;
  - slice worst-of-members: a slice id ANY member marks degraded blocks
    every member;
  - preference order: highest perf class, then most free chips
    (spread), then lexicographic node name;
  - cluster admission: the aggregator's capacity-by-class rollup gates
    a query before any scan ("no-capacity"); an empty inventory admits
    everything.

The index is allocation-free (`free` = published chip capacity): the
caller owns allocation bookkeeping, exactly like SimScheduler.node_used.
Candidate sets are maintained incrementally per rank as bisect-sorted
``(-free, node)`` lists, so a query costs O(answer + filtered), never
O(nodes).
"""

import bisect

from tpufd_torch import agg as agglib

PERF_CLASS = agglib.PERF_CLASS
TPU_COUNT = agglib.TPU_COUNT
SLICE_ID = agglib.SLICE_ID
SLICE_DEGRADED = agglib.SLICE_DEGRADED
SLICE_CLASS = agglib.PREFIX + "tpu.slice.class"
LIFECYCLE_PREEMPT = agglib.LIFECYCLE_PREEMPT
LIFECYCLE_DRAINING = agglib.LIFECYCLE_DRAINING
CAPACITY_PREFIX = agglib.CAPACITY_PREFIX

CLASS_RANK = {"gold": 3, "silver": 2, "degraded": 1}
JOB_CLASS_RANK = {"gold": 3, "silver": 2, "any": 0}

MAX_LIMIT = 64  # PlacementIndex::kMaxLimit

# The closed rejection taxonomy (placement::kRejectionReasons): the
# FIRST gating reason recorded per rejected node when a query asks
# "explain": true. Pinned — both sides and the SimScheduler emit
# exactly these strings.
REJECTION_REASONS = (
    "perf-degraded",
    "slice-member-degraded",
    "lifecycle-preempt",
    "lifecycle-draining",
    "class-floor",
    "insufficient-chips",
    "capacity-admission",
)

MAX_EXPLAIN_REJECTIONS = 32  # PlacementExplanation::kMaxRejections
MAX_EXPLAIN_CHANGE_IDS = 16  # PlacementExplanation::kMaxChangeIds


def class_rank(perf_class):
    return CLASS_RANK.get(perf_class or "", 0)


def job_min_rank(wanted):
    """-1 flags an unknown floor (the C++ side serves HTTP 400)."""
    return JOB_CLASS_RANK.get(wanted, -1)


def preempting(labels):
    return (labels.get(LIFECYCLE_PREEMPT) == "true" or
            labels.get(LIFECYCLE_DRAINING) == "true")


def basic_eligible(labels):
    if labels.get(PERF_CLASS) == "degraded":
        return False
    if labels.get(SLICE_DEGRADED) == "true":
        return False
    if labels.get(SLICE_CLASS) == "degraded":
        return False
    if preempting(labels):
        return False
    return True


def slice_degraded_claim(labels):
    return (labels.get(SLICE_DEGRADED) == "true" or
            labels.get(SLICE_CLASS) == "degraded")


def basic_reason(labels):
    """The FIRST reason this node's own labels make it basic-ineligible,
    "" when basic-eligible (placement::BasicReason, bit-for-bit).
    Precedence mirrors basic_eligible's check order."""
    if labels.get(PERF_CLASS) == "degraded":
        return "perf-degraded"
    if slice_degraded_claim(labels):
        return "slice-member-degraded"
    if labels.get(LIFECYCLE_PREEMPT) == "true":
        return "lifecycle-preempt"
    if labels.get(LIFECYCLE_DRAINING) == "true":
        return "lifecycle-draining"
    return ""


def _chips(labels):
    raw = labels.get(TPU_COUNT, "")
    try:
        value = int(raw)
    except ValueError:
        return 0
    return max(0, value)


class PlacementIndex:
    """Twin of placement::PlacementIndex."""

    def __init__(self):
        self.nodes = {}      # node -> entry tuple
        self.by_rank = {}    # rank -> bisect-sorted [(-free, node), ...]
        self.claims = {}     # slice id -> degraded-claim member count
        self.blocked = set() # claims keys with count > 0
        self.inventory_capacity = {}
        self.have_inventory = False
        self.inventory_change = ""
        self.events = 0

    # entry = (perf_class, rank, chips, slice_id, basic, claim,
    #          basic_reason, change)

    def _insert(self, node, entry):
        rank, chips, slice_id, basic, claim = entry[1:6]
        if basic:
            bisect.insort(self.by_rank.setdefault(rank, []),
                          (-chips, node))
        if claim and slice_id:
            self.claims[slice_id] = self.claims.get(slice_id, 0) + 1
            self.blocked.add(slice_id)

    def _erase(self, node, entry):
        rank, chips, slice_id, basic, claim = entry[1:6]
        if basic:
            ranked = self.by_rank.get(rank)
            if ranked is not None:
                idx = bisect.bisect_left(ranked, (-chips, node))
                if idx < len(ranked) and ranked[idx] == (-chips, node):
                    ranked.pop(idx)
                if not ranked:
                    del self.by_rank[rank]
        if claim and slice_id:
            count = self.claims.get(slice_id, 0) - 1
            if count <= 0:
                self.claims.pop(slice_id, None)
                self.blocked.discard(slice_id)
            else:
                self.claims[slice_id] = count

    def apply_node(self, node, labels, change=""):
        """`change` is the CR's change-id annotation; retained only when
        the write actually moved the index — a no-op rewrite keeps the
        change-id that created the current condition."""
        perf_class = labels.get(PERF_CLASS, "")
        entry = (perf_class, class_rank(perf_class), _chips(labels),
                 labels.get(SLICE_ID, ""), basic_eligible(labels),
                 slice_degraded_claim(labels), basic_reason(labels),
                 change)
        old = self.nodes.get(node)
        if old is not None and old[:7] == entry[:7]:
            return False
        if old is not None:
            self._erase(node, old)
        self.nodes[node] = entry
        self._insert(node, entry)
        self.events += 1
        return True

    def remove_node(self, node):
        old = self.nodes.pop(node, None)
        if old is None:
            return False
        self._erase(node, old)
        self.events += 1
        return True

    def apply_inventory(self, labels, change=""):
        """Pass {} (or None) when the inventory object is deleted."""
        labels = labels or {}
        self.inventory_capacity = {}
        self.have_inventory = bool(labels)
        self.inventory_change = change
        for key, value in labels.items():
            if not key.startswith(CAPACITY_PREFIX):
                continue
            bucket = key[len(CAPACITY_PREFIX):]
            # SimScheduler.admit: int(raw) if raw.isdigit() else 0.
            self.inventory_capacity[bucket] = (
                int(value) if value.isdigit() else 0)
        self.events += 1

    def admit(self, min_rank, chips):
        if not self.have_inventory:
            return True
        total = 0
        for bucket, rank in (("gold", 3), ("silver", 2), ("unclassed", 0)):
            if rank >= min_rank:
                total += self.inventory_capacity.get(bucket, 0)
        return total >= chips

    def eligible(self):
        return sum(len(ranked) for ranked in self.by_rank.values())

    def node_change(self, node):
        entry = self.nodes.get(node)
        return entry[7] if entry is not None else ""

    def node_basic_reason(self, node):
        entry = self.nodes.get(node)
        return entry[6] if entry is not None else ""

    def query(self, wanted="any", chips=1, slice=False, limit=1,
              explain=False):
        """Returns the same document RenderPlacementResult emits:
        {"status": ..., "candidates": [{"node","class","free","slice"}]}
        plus an "explain" section (the rejection-taxonomy walk) when
        asked — the non-explain answer is untouched."""
        min_rank = job_min_rank(wanted)
        if min_rank < 0:
            raise ValueError(f"unknown class {wanted!r}")
        limit = max(1, min(int(limit), MAX_LIMIT))
        if not self.admit(min_rank, chips):
            result = {"status": "no-capacity", "candidates": []}
            if explain:
                result["explain"] = self.explain(wanted, chips, slice,
                                                 result)
            return result
        candidates = []
        for rank in sorted(self.by_rank, reverse=True):
            if rank < min_rank:
                break
            for neg_free, node in self.by_rank[rank]:
                free = -neg_free
                if free < chips:
                    break  # free descends within a rank
                entry = self.nodes[node]
                slice_id = entry[3]
                if not slice_id:
                    if slice:
                        continue  # multislice job needs a member
                elif slice_id in self.blocked:
                    continue  # worst-of-members: a peer blocks it
                candidates.append({"node": node, "class": entry[0],
                                   "free": free, "slice": slice_id})
                if len(candidates) >= limit:
                    break
            if len(candidates) >= limit:
                break
        result = {"status": "placed" if candidates else "no-candidate",
                  "candidates": candidates}
        if explain:
            result["explain"] = self.explain(wanted, chips, slice, result)
        return result

    def explain(self, wanted, chips, slice, result):
        """The rejection-taxonomy walk for one already-computed answer
        (placement::PlacementIndex::Explain, bit-for-bit): the FIRST
        gating reason per rejected node in the pinned precedence —
        capacity-admission (query-wide), the node's own basic_reason,
        class-floor, a peer's slice claim (naming the lexicographically
        first claiming member), insufficient-chips. Non-members of any
        slice are structurally out of scope for a multislice query (not
        rejections). Must run against the same index state that
        computed `result`."""
        min_rank = job_min_rank(wanted)
        admitted = self.admit(min_rank, chips)
        placed = {c["node"] for c in result["candidates"]}

        first_claimer = {}
        for node in sorted(self.nodes):
            entry = self.nodes[node]
            if entry[5] and entry[3] and entry[3] not in first_claimer:
                first_claimer[entry[3]] = node

        reasons = {}
        rejections = []
        rejected = 0
        change_ids = set()
        best = None  # (rank, chips, node, rejection dict, entry)
        for node in sorted(self.nodes):
            entry = self.nodes[node]
            if node in placed:
                continue
            if slice and not entry[3]:
                continue  # never a candidate shape for a multislice job
            rejection = {"node": node, "reason": ""}
            change = entry[7]
            member = ""
            if not admitted:
                rejection["reason"] = "capacity-admission"
                change = self.inventory_change
            elif entry[6]:
                rejection["reason"] = entry[6]
                if entry[6] == "slice-member-degraded":
                    member = node  # the node's own claim blocks it
            elif entry[1] < min_rank:
                rejection["reason"] = "class-floor"
            elif entry[3] and entry[3] in self.blocked:
                rejection["reason"] = "slice-member-degraded"
                member = first_claimer.get(entry[3], "")
                change = self.node_change(member) if member else ""
            elif entry[2] < chips:
                rejection["reason"] = "insufficient-chips"
            else:
                continue  # viable, just beyond the limit — not rejected
            if member:
                rejection["member"] = member
            if change:
                rejection["change"] = change
            reason = rejection["reason"]
            reasons[reason] = reasons.get(reason, 0) + 1
            rejected += 1
            if change:
                change_ids.add(change)
            if len(rejections) < MAX_EXPLAIN_REJECTIONS:
                rejections.append(rejection)
            if (best is None or entry[1] > best[4][1] or
                    (entry[1] == best[4][1] and
                     (entry[2] > best[4][2] or
                      (entry[2] == best[4][2] and node < best[2])))):
                best = (entry[1], entry[2], node, rejection, entry)

        out = {"reasons": reasons, "rejected": rejected,
               "rejections": rejections,
               "counterfactual": "",
               "change_ids": sorted(change_ids)[:MAX_EXPLAIN_CHANGE_IDS]}
        if result["status"] == "placed":
            return out
        if result["status"] == "no-capacity":
            text = (f"capacity-admission: inventory admits fewer than "
                    f"{chips} chip(s) at class floor {wanted}")
            if self.inventory_change:
                text += f" (change {self.inventory_change})"
            out["counterfactual"] = text
            return out
        if best is None:
            out["counterfactual"] = ("no slice-member nodes in index"
                                     if slice else
                                     "no candidate nodes in index")
            return out
        _, _, node, rejection, entry = best
        reason = rejection["reason"]
        if reason == "insufficient-chips":
            text = (f"insufficient-chips: needs {chips - entry[2]} more "
                    f"free chip(s); best node {node} has {entry[2]} free")
        elif reason == "class-floor":
            cls = entry[0] or "unclassed"
            text = (f"class-floor: needs class >= {wanted}; "
                    f"best node {node} is {cls}")
        elif reason == "slice-member-degraded":
            text = (f"slice-member-degraded: slice {entry[3]} blocked by "
                    f"member {rejection['member']}'s degraded-slice "
                    f"verdict")
        else:
            # perf-degraded / lifecycle-preempt / lifecycle-draining.
            text = f"{reason}: best node {node} is blocked by its own labels"
        if rejection.get("change"):
            text += f" (change {rejection['change']})"
        out["counterfactual"] = text
        return out
