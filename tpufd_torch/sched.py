"""Probe scheduling primitives: the port's own copy of ``tpufd/sched.py``,
itself the Python twin of the daemon's ``src/tfd/sched/``.

  - staleness tiers: the tier names, :class:`TierPolicy`,
    :func:`device_policy` (the policy ``sched/sources.cc`` registers for
    a device source) and :func:`tier_of` (``sched::TierForAge``), so the
    daemon's scraped ``tfd_snapshot_age_seconds`` and its ``tier-change``
    journal records read in the daemon's own vocabulary;
  - :class:`SnapshotStore`, the per-source latest-result cache with the
    store's read-side view (age, tier, consecutive failures);
  - :func:`backoff_with_jitter` and :class:`ProbeScheduler`: base =
    min(max, initial * 2^(n-1)), stretched by up to +25% jitter.

The tests pin this copy against ``tpufd.sched``, so the two cannot drift.
It imports neither ``torch`` nor ``numpy``: ``health`` imports it on the
exec's start-up path.
"""

import time

from tpufd_torch import metrics

FRESH = "fresh"
STALE_USABLE = "stale-usable"
EXPIRED = "expired"
NONE = "none"


class TierPolicy:
    """Ages <= fresh_for_s are fresh; <= usable_for_s stale-usable;
    beyond, expired — same rule as sched::TierForAge."""

    def __init__(self, fresh_for_s, usable_for_s):
        self.fresh_for_s = fresh_for_s
        self.usable_for_s = usable_for_s


def device_policy(sleep_interval_s, deadline_s=0, usable_override_s=0):
    """The policy sched/sources.cc registers for a device source: 4
    ticks of slack plus the probe's deadline budget before ``fresh``
    lapses; servable for 6 more ticks (or the --snapshot-usable-for
    override)."""
    fresh = 4 * sleep_interval_s + deadline_s
    usable = usable_override_s if usable_override_s > 0 else (
        fresh + 6 * sleep_interval_s)
    return TierPolicy(fresh, usable)


def tier_of(age_s, policy):
    if age_s is None or age_s < 0:
        return NONE
    if age_s <= policy.fresh_for_s:
        return FRESH
    if age_s <= policy.usable_for_s:
        return STALE_USABLE
    return EXPIRED


def backoff_with_jitter(consecutive_failures, initial_s, max_s,
                        unit_random):
    """sched::BackoffWithJitter: base = min(max, initial * 2^(n-1)),
    stretched by up to +25% jitter; inputs clamped the same way."""
    initial_s = max(1, initial_s)
    max_s = max(max_s, initial_s)
    exponent = max(0, consecutive_failures - 1)
    if exponent >= 31:
        base = float(max_s)
    else:
        base = min(float(max_s), float(initial_s) * (1 << exponent))
    jitter = min(max(unit_random, 0.0), 1.0)
    return base * (1.0 + 0.25 * jitter)


class SnapshotStore:
    """Per-source latest-result cache with the same read-side view the
    C++ store exposes (age, tier, consecutive failures)."""

    def __init__(self):
        self._states = {}
        self._order = []

    def register(self, source, policy):
        if source not in self._states:
            self._order.append(source)
        self._states[source] = {
            "policy": policy, "value": None, "taken_at": None,
            "error": None, "consecutive_failures": 0, "settled": False,
        }

    def put_ok(self, source, value, now=None):
        state = self._states[source]
        state.update(value=value, taken_at=now or time.monotonic(),
                     error=None, consecutive_failures=0, settled=True)

    def put_error(self, source, error):
        state = self._states[source]
        state["error"] = str(error)
        state["consecutive_failures"] += 1
        state["settled"] = True

    def sources(self):
        return list(self._order)

    def view(self, source, now=None):
        state = self._states[source]
        age = None
        if state["taken_at"] is not None:
            age = (now or time.monotonic()) - state["taken_at"]
        return {
            "settled": state["settled"],
            "value": state["value"],
            "age_s": age,
            "tier": tier_of(age, state["policy"]),
            "error": state["error"],
            "consecutive_failures": state["consecutive_failures"],
        }


class ProbeScheduler:
    """Runs named probes with a per-probe retry budget and the shared
    backoff rule, recording ``tpufd_probe_attempts_total`` /
    ``tpufd_probe_retries_total`` (per probe) into a metrics registry.

    Synchronous by design: the probes are batch work, and what this
    shares with the daemon's broker is the retry/backoff/telemetry
    contract, not the threads.
    """

    def __init__(self, registry=None, retry_budget=2,
                 backoff_initial_s=0.5, backoff_max_s=4.0,
                 unit_random=0.5, sleep=time.sleep):
        self.registry = (metrics.default_registry() if registry is None
                         else registry)
        self.retry_budget = retry_budget
        self.backoff_initial_s = backoff_initial_s
        self.backoff_max_s = backoff_max_s
        self.unit_random = unit_random
        self.sleep = sleep

    def run(self, name, fn):
        """Runs ``fn`` with up to retry_budget re-attempts, sleeping the
        jittered backoff between failures. Returns fn's value; re-raises
        the last failure once the budget is spent."""
        failures = 0
        while True:
            self.registry.counter(
                "tpufd_probe_attempts_total",
                "Probe invocations, per probe (retries included).",
                labels={"probe": name}).inc()
            try:
                return fn()
            except Exception:
                failures += 1
                if failures > self.retry_budget:
                    raise
                self.registry.counter(
                    "tpufd_probe_retries_total",
                    "Probe re-attempts after a raise, per probe.",
                    labels={"probe": name}).inc()
                # Sub-second backoff: the daemon's rule with seconds
                # scaled down, so a retry never stalls the exec past the
                # daemon's health budget.
                scale = self.backoff_initial_s
                delay = backoff_with_jitter(
                    failures, 1, max(1, int(self.backoff_max_s / scale)),
                    self.unit_random) * scale
                self.sleep(min(delay, self.backoff_max_s))
