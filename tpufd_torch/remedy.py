"""The port's own copy of ``tpufd.remedy`` (``tpufd/remedy.py``), kept
equal to it and importing nothing of ``tpufd``.

Python twin of the closed-loop remediation engine (src/tfd/remedy/).

The engine is the PURE half of `--mode=remedy`: it consumes the same
label streams the aggregator and placement view consume (NodeFeature
CRs + the inventory CR) plus a queued-demand signal from the decision
audit stream, derives remediation verdicts from sliding-window
evidence, and emits a CLOSED action vocabulary:

  cordon            node `spec.unschedulable` patch — crash-loop flap
                    history (>= flap_threshold eligibility down-flips
                    inside window_s) or gray degradation (a
                    `tpu.perf.chip<N>.class=degraded` label while the
                    node still *looks* placeable)
  uncordon          automatic rollback once the triggering evidence is
                    retracted and stays retracted for heal_dwell_s
  drain-recommend   preempt-imminent lifecycle — journal + label only,
                    never an eviction
  rebuild-recommend predicted eligible capacity (chips on nodes with no
                    active evidence) dropped below queued demand

Safety interlocks (evaluated in this order, first hit wins):
  node-rate-limit    per-node cooldown + exponential backoff with
                     deterministic fnv1a64 jitter after failed writes
  slo-burn           a burning tpu.slo.*.burn stage on the inventory CR
                     defers NEW cordons (the fleet is already hurting;
                     don't remove capacity mid-burn)
  disruption-budget  fleet-wide max concurrent cordons
  domain-cap         per-failure-domain concurrent-cordon cap (the
                     `tpu.topology.domain` label names the rack/power
                     group)

The engine is deliberately side-effect-free and clock-free: callers
feed observations and a `now`, and execute the returned actions (or
journal them untouched under --remedy-dry-run). Dry-run vs enforce is
therefore a *runner* property — the engine's state machine is identical
in both, which is what makes the dry-run journal a faithful preview.

Parity: src/tfd/tests/unit_tests.cc TestRemedyParityGolden and
tests/test_remedy.py run the same scripted scenario through both
implementations and compare render_json() against one shared literal.
"""

from tpufd_torch import agg as agglib
from tpufd_torch import sink as sinklib

PREFIX = agglib.PREFIX
PERF_CLASS = agglib.PERF_CLASS
SLICE_DEGRADED = agglib.SLICE_DEGRADED
SLICE_CLASS = PREFIX + "tpu.slice.class"
LIFECYCLE_PREEMPT = agglib.LIFECYCLE_PREEMPT
LIFECYCLE_DRAINING = agglib.LIFECYCLE_DRAINING
TPU_COUNT = agglib.TPU_COUNT
SLO_BURN_PREFIX = agglib.SLO_BURN_PREFIX
# Failure-domain membership (rack/power group). Published by the
# operator/provisioner, consumed by the domain-cap interlock.
DOMAIN_LABEL = PREFIX + "tpu.topology.domain"
# The drain recommendation is a label, not an eviction: schedulers and
# operators act on it; the controller never deletes a pod.
DRAIN_LABEL = PREFIX + "tpu.remedy.drain-recommended"

# Per-chip gray degradation: `google.com/tpu.perf.chip<N>.class`.
CHIP_CLASS_PREFIX = PREFIX + "tpu.perf.chip"
CHIP_CLASS_SUFFIX = ".class"

# Remediation latency decomposes into the same budget-gated stage shape
# as placement (cluster.CHAIN_STAGES): ground-truth fault -> the engine
# SEES the evidence (detect) -> the tick emits an action (decide) -> the
# write is attempted (act) -> the apiserver acks it (acked).
REMEDY_STAGES = ("detect", "decide", "act", "acked")

# Closed vocabularies — gates iterate these, so a new action/interlock
# must be added HERE (and to the C++ twin) or it fails loudly.
ACTION_KINDS = ("cordon", "uncordon", "drain-recommend",
                "rebuild-recommend")
INTERLOCKS = ("node-rate-limit", "slo-burn", "disruption-budget",
              "domain-cap")
# Evidence classes that justify a cordon, in deterministic priority
# order (crash-loop wins when both are active).
CORDON_EVIDENCE = ("crash-loop", "gray")


def eligible(labels):
    """The scheduler's-eye view of a node (cluster.basic_eligible):
    crash-loop flips are DOWN-flips of this predicate."""
    if labels is None:
        return False
    if labels.get(PERF_CLASS) == "degraded":
        return False
    if labels.get(SLICE_DEGRADED) == "true":
        return False
    if labels.get(SLICE_CLASS) == "degraded":
        return False
    if labels.get(LIFECYCLE_PREEMPT) == "true":
        return False
    if labels.get(LIFECYCLE_DRAINING) == "true":
        return False
    return True


def gray_degraded(labels):
    """A chip-level degraded verdict on a node whose headline class is
    NOT degraded: the node still looks placeable, so nothing else in
    the stack will fence it — exactly the case remediation exists for."""
    if labels.get(PERF_CLASS) == "degraded":
        return False
    for key, value in labels.items():
        if (key.startswith(CHIP_CLASS_PREFIX)
                and key.endswith(CHIP_CLASS_SUFFIX)
                and value == "degraded"):
            return True
    return False


def backoff_jitter_unit(node, fail_count):
    """Deterministic jitter in [0, 1): both twins hash the same key, so
    a seeded soak reproduces byte-identically across languages."""
    return (sinklib.fnv1a64("%s:%d" % (node, fail_count)) % 1000) / 1000.0


class RemedyConfig:
    """Knobs, each wired through flags/env/helm/static in the C++ twin
    (--remedy-*; TFD_REMEDY_*; remedy.* helm values)."""

    def __init__(self, window_s=60.0, flap_threshold=3, heal_dwell_s=10.0,
                 cooldown_s=5.0, backoff_base_s=1.0, backoff_max_s=30.0,
                 max_concurrent_cordons=3, domain_cap=1,
                 rebuild_cooldown_s=30.0):
        self.window_s = window_s
        self.flap_threshold = flap_threshold
        self.heal_dwell_s = heal_dwell_s
        self.cooldown_s = cooldown_s
        self.backoff_base_s = backoff_base_s
        self.backoff_max_s = backoff_max_s
        self.max_concurrent_cordons = max_concurrent_cordons
        self.domain_cap = domain_cap
        self.rebuild_cooldown_s = rebuild_cooldown_s


class Action:
    __slots__ = ("kind", "node", "evidence", "detected_at", "reason")

    def __init__(self, kind, node, evidence, detected_at, reason):
        self.kind = kind
        self.node = node
        self.evidence = evidence
        self.detected_at = detected_at
        self.reason = reason

    def __repr__(self):
        return ("Action(%r, %r, %r, %r, %r)"
                % (self.kind, self.node, self.evidence, self.detected_at,
                   self.reason))


class _Node:
    __slots__ = ("labels", "eligible", "flips", "evidence", "clear_since",
                 "cordoned", "cordon_class", "cordon_at", "pending",
                 "last_action_at", "fail_count", "backoff_until",
                 "drain_recommended", "domain")

    def __init__(self):
        self.labels = {}
        self.eligible = None       # unknown until the first observation
        self.flips = []            # eligibility down-flip times (window)
        self.evidence = {}         # class -> active_since
        self.clear_since = None    # when cordon evidence last all-cleared
        self.cordoned = False
        self.cordon_class = ""
        self.cordon_at = None
        self.pending = None        # action kind in flight (no re-emit)
        self.last_action_at = None
        self.fail_count = 0
        self.backoff_until = None
        self.drain_recommended = False
        self.domain = ""


class RemedyEngine:
    def __init__(self, config=None):
        self.config = config or RemedyConfig()
        self.nodes = {}
        self.slo_burning = False      # inventory-CR burn damper
        self.queued_demand_chips = 0  # decision-audit-stream signal
        self.last_rebuild_at = None
        self.counters = {"actions": {k: 0 for k in ACTION_KINDS},
                         "blocked": {i: 0 for i in INTERLOCKS},
                         "rollbacks": 0, "write_failures": 0}
        self._blocked_live = set()    # (node, interlock) currently blocked

    # ---- observations ----------------------------------------------------

    def observe_node(self, node, labels, now):
        """One NodeFeature CR state (None = deleted). Returns True when
        any evidence class TRANSITIONED to active (the detect edge)."""
        if labels is None:
            self.nodes.pop(node, None)
            return False
        n = self.nodes.setdefault(node, _Node())
        n.labels = dict(labels)
        n.domain = labels.get(DOMAIN_LABEL, n.domain)
        el = eligible(labels)
        if n.eligible is True and not el:
            n.flips.append(now)
        n.eligible = el
        return self._refresh_evidence(node, n, now)

    def observe_inventory(self, labels, now):
        """The aggregator's inventory CR: a burning tpu.slo.<stage>.burn
        stage arms the slo-burn interlock."""
        del now
        self.slo_burning = any(
            key.startswith(SLO_BURN_PREFIX) and key.endswith(".burn")
            and value == "true" for key, value in (labels or {}).items())

    def observe_demand(self, chips, now):
        """Queued demand (chips) from the decision audit stream — the
        rebuild trigger's right-hand side."""
        del now
        self.queued_demand_chips = int(chips)

    # ---- evidence --------------------------------------------------------

    def _refresh_evidence(self, node, n, now):
        cfg = self.config
        floor = now - cfg.window_s
        n.flips = [t for t in n.flips if t > floor]
        active = {}
        if len(n.flips) >= cfg.flap_threshold:
            active["crash-loop"] = n.flips[cfg.flap_threshold - 1]
        if gray_degraded(n.labels):
            active["gray"] = now
        if n.labels.get(LIFECYCLE_PREEMPT) == "true":
            active["preempt"] = now
        detected = False
        for cls, since in active.items():
            if cls not in n.evidence:
                n.evidence[cls] = since if cls == "crash-loop" else now
                detected = True
        for cls in [c for c in n.evidence if c not in active]:
            del n.evidence[cls]
        if any(c in n.evidence for c in CORDON_EVIDENCE):
            n.clear_since = None
        elif n.clear_since is None:
            n.clear_since = now
        if "preempt" not in n.evidence:
            n.drain_recommended = False
        return detected

    def _cordon_evidence(self, n):
        for cls in CORDON_EVIDENCE:
            if cls in n.evidence:
                return cls
        return None

    def _rate_limited(self, n, now):
        if n.backoff_until is not None and now < n.backoff_until:
            return True
        if (n.last_action_at is not None
                and now - n.last_action_at < self.config.cooldown_s):
            return True
        return False

    def predicted_capacity_chips(self, now):
        """Chips on nodes the fleet can actually count on: eligible,
        not cordoned (or being cordoned), no active cordon evidence."""
        del now
        total = 0
        for n in self.nodes.values():
            if not n.eligible or n.cordoned or n.pending == "cordon":
                continue
            if self._cordon_evidence(n) is not None:
                continue
            try:
                total += int(n.labels.get(TPU_COUNT, "0"))
            except ValueError:
                pass
        return total

    # ---- the decision tick -----------------------------------------------

    def tick(self, now):
        """One decision pass. Returns (actions, blocked) where blocked
        lists (node, interlock) pairs that TRANSITIONED into blocked this
        tick (the journal/metric edge; steady blockage is not re-counted).
        Deterministic: nodes are visited in sorted order, interlocks
        evaluated in the documented order."""
        cfg = self.config
        actions = []
        blocked_now = set()
        # Re-age crash-loop windows even without fresh observations.
        for node in sorted(self.nodes):
            self._refresh_evidence(node, self.nodes[node], now)
        active_cordons = sum(
            1 for n in self.nodes.values()
            if n.cordoned or n.pending == "cordon")
        domain_cordons = {}
        for n in self.nodes.values():
            if (n.cordoned or n.pending == "cordon") and n.domain:
                domain_cordons[n.domain] = \
                    domain_cordons.get(n.domain, 0) + 1
        for node in sorted(self.nodes):
            n = self.nodes[node]
            if n.pending is not None:
                continue
            ev = self._cordon_evidence(n)
            if n.cordoned:
                if (ev is None and n.clear_since is not None
                        and now - n.clear_since >= cfg.heal_dwell_s
                        and not self._rate_limited(n, now)):
                    n.pending = "uncordon"
                    actions.append(Action(
                        "uncordon", node, n.cordon_class, n.clear_since,
                        "evidence retracted for %gs"
                        % round(now - n.clear_since, 3)))
            elif ev is not None:
                if self._rate_limited(n, now):
                    blocked_now.add((node, "node-rate-limit"))
                elif self.slo_burning:
                    blocked_now.add((node, "slo-burn"))
                elif active_cordons >= cfg.max_concurrent_cordons:
                    blocked_now.add((node, "disruption-budget"))
                elif (n.domain and domain_cordons.get(n.domain, 0)
                        >= cfg.domain_cap):
                    blocked_now.add((node, "domain-cap"))
                else:
                    n.pending = "cordon"
                    n.cordon_class = ev
                    active_cordons += 1
                    if n.domain:
                        domain_cordons[n.domain] = \
                            domain_cordons.get(n.domain, 0) + 1
                    actions.append(Action(
                        "cordon", node, ev, n.evidence[ev],
                        "evidence %s active since %g" %
                        (ev, round(n.evidence[ev], 3))))
            if ("preempt" in n.evidence and not n.drain_recommended
                    and not self._rate_limited(n, now)):
                n.drain_recommended = True
                actions.append(Action(
                    "drain-recommend", node, "preempt",
                    n.evidence["preempt"], "preempt-imminent lifecycle"))
                self.counters["actions"]["drain-recommend"] += 1
        if self.queued_demand_chips > 0:
            capacity = self.predicted_capacity_chips(now)
            if capacity < self.queued_demand_chips and (
                    self.last_rebuild_at is None
                    or now - self.last_rebuild_at >= cfg.rebuild_cooldown_s):
                self.last_rebuild_at = now
                actions.append(Action(
                    "rebuild-recommend", "", "capacity", now,
                    "predicted capacity %d chips < queued demand %d"
                    % (capacity, self.queued_demand_chips)))
                self.counters["actions"]["rebuild-recommend"] += 1
        newly_blocked = blocked_now - self._blocked_live
        for _, interlock in sorted(newly_blocked):
            self.counters["blocked"][interlock] += 1
        self._blocked_live = blocked_now
        return actions, sorted(newly_blocked)

    # ---- action results (the write loop reports back) --------------------

    def note_action_result(self, node, kind, ok, now):
        """The runner executed (or dry-ran) an action. Failed writes arm
        exponential backoff with deterministic jitter; the action stays
        un-applied and the next tick re-emits it once the backoff
        expires."""
        n = self.nodes.get(node)
        if n is None:
            return
        n.pending = None
        n.last_action_at = now
        if ok:
            n.fail_count = 0
            n.backoff_until = None
            if kind == "cordon":
                n.cordoned = True
                n.cordon_at = now
                self.counters["actions"]["cordon"] += 1
            elif kind == "uncordon":
                n.cordoned = False
                n.cordon_at = None
                self.counters["actions"]["uncordon"] += 1
                self.counters["rollbacks"] += 1
        else:
            n.fail_count += 1
            self.counters["write_failures"] += 1
            backoff = min(cfg_backoff(self.config, n.fail_count),
                          self.config.backoff_max_s)
            jitter = backoff_jitter_unit(node, n.fail_count)
            n.backoff_until = now + backoff * (1.0 + 0.5 * jitter)

    def abandon_pending(self):
        """Epoch-fenced step-down mid-batch: the lease is gone, so every
        in-flight intent is dropped without state change — the next
        leader re-derives it from the same evidence."""
        dropped = 0
        for n in self.nodes.values():
            if n.pending is not None:
                n.pending = None
                dropped += 1
        return dropped

    def cordoned_nodes(self):
        return sorted(node for node, n in self.nodes.items() if n.cordoned)

    # ---- parity surface --------------------------------------------------

    def render_json(self):
        """Deterministic compact JSON of the engine state — the parity
        golden surface (identical literal in unit_tests.cc). All times
        as integer milliseconds so the two languages cannot diverge on
        float formatting."""
        parts = []
        blocked = ",".join(
            '"%s":%d' % (i, self.counters["blocked"][i])
            for i in sorted(INTERLOCKS))
        actions = ",".join(
            '"%s":%d' % (k, self.counters["actions"][k])
            for k in sorted(ACTION_KINDS))
        nodes = []
        for node in sorted(self.nodes):
            n = self.nodes[node]
            evidence = ",".join('"%s"' % c for c in sorted(n.evidence))
            nodes.append(
                '"%s":{"cordoned":%s,"domain":"%s","evidence":[%s],'
                '"flips":%d}'
                % (node, "true" if n.cordoned else "false", n.domain,
                   evidence, len(n.flips)))
        parts.append('"actions":{%s}' % actions)
        parts.append('"blocked":{%s}' % blocked)
        parts.append('"cordoned":[%s]' % ",".join(
            '"%s"' % c for c in self.cordoned_nodes()))
        parts.append('"nodes":{%s}' % ",".join(nodes))
        parts.append('"rollbacks":%d' % self.counters["rollbacks"])
        parts.append('"write_failures":%d'
                     % self.counters["write_failures"])
        return "{%s}" % ",".join(parts)


def cfg_backoff(config, fail_count):
    return config.backoff_base_s * (2 ** (fail_count - 1))


class RemedyTracker:
    """Change-id minting for remediation actions: the same monotone
    change-id discipline as cluster.ChangeTracker, with the remedy stage
    chain (detect -> decide -> act -> acked). One chain per executed
    action; stages stamp first-wins and close() clamps them monotone
    into [t0, t_acked] exactly like the placement tracker."""

    def __init__(self, stages=REMEDY_STAGES):
        self.stages = stages
        self.next_change = 1
        self.open = {}    # change -> {"op","node","t0","stamps"}
        self.closed = []

    def mint(self, op, node, t0):
        change = self.next_change
        self.next_change += 1
        self.open[change] = {"op": op, "node": node, "t0": t0,
                             "stamps": {}}
        return change

    def stamp(self, change, stage, t):
        entry = self.open.get(change)
        if entry is not None and stage not in entry["stamps"]:
            entry["stamps"][stage] = t

    def close(self, change, t_final):
        entry = self.open.pop(change, None)
        if entry is None:
            return None
        prev = entry["t0"]
        stages = {}
        for stage in self.stages[:-1]:
            t = min(max(entry["stamps"].get(stage, prev), prev), t_final)
            stages[stage] = round((t - prev) * 1000.0, 3)
            prev = t
        stages[self.stages[-1]] = round((t_final - prev) * 1000.0, 3)
        record = {"change": change, "op": entry["op"],
                  "node": entry["node"],
                  "e2e_ms": round((t_final - entry["t0"]) * 1000.0, 3),
                  "stages": stages}
        self.closed.append(record)
        return record

    def discard(self, change):
        self.open.pop(change, None)
