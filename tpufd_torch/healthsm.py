"""Health state machine vocabulary: the port's own copy of
``tpufd/healthsm.py``, the Python twin of ``src/tfd/healthsm/``.

The daemon debounces every health-bearing fact through a per-source
(and per-chip) state machine — healthy -> suspect -> unhealthy ->
quarantined -> recovering — journaling each transition
(``health-transition``) and gauging the state
(``tfd_health_state{source}``). This module mirrors the transition
rules 1:1 so the harnesses classify with the daemon's own vocabulary:

  - :data:`LEGAL_TRANSITIONS` + :func:`health_transitions` /
    :func:`illegal_transitions` — the soak/chaos check that every
    journaled transition is one the machine can actually make;
  - :class:`HealthStateMachine` — the pure transition function
    (caller-supplied clock, no sleeps), held step by step against the
    reference's by tests/test_torch_healthsm.py;
  - :func:`state_name` / :data:`STATE_GAUGE_VALUES` — the
    ``tfd_health_state`` gauge encoding (0 healthy .. 4 recovering).

Formula parity: flap counting is a sliding window of transition times
(plus unstable observations); ``flap_threshold`` events inside
``flap_window_s`` quarantine; recovery needs the cooldown plus
``recover_after`` consecutive clean probes.
"""

from tpufd_torch.journal import events_of_type

HEALTHY = "healthy"
SUSPECT = "suspect"
UNHEALTHY = "unhealthy"
QUARANTINED = "quarantined"
RECOVERING = "recovering"

STATES = (HEALTHY, SUSPECT, UNHEALTHY, QUARANTINED, RECOVERING)
STATE_GAUGE_VALUES = {name: i for i, name in enumerate(STATES)}

# Every edge the C++ machine can journal. Quarantine is reachable from
# any non-quarantined state (the flap window fills wherever you are);
# it exits only through recovering.
LEGAL_TRANSITIONS = {
    (HEALTHY, SUSPECT),
    (SUSPECT, HEALTHY),
    (SUSPECT, UNHEALTHY),
    (UNHEALTHY, RECOVERING),
    (RECOVERING, HEALTHY),
    (RECOVERING, UNHEALTHY),
    (HEALTHY, QUARANTINED),
    (SUSPECT, QUARANTINED),
    (UNHEALTHY, QUARANTINED),
    (RECOVERING, QUARANTINED),
    (QUARANTINED, RECOVERING),
}


def state_name(gauge_value):
    """State name for a scraped tfd_health_state gauge value."""
    return STATES[int(gauge_value)]


def health_transitions(events):
    """[(key, from, to)] from journaled health-transition events, seq
    order (events: a list or the seq->event dict journal.merge_events
    accumulates)."""
    return [(e["fields"].get("key"), e["fields"].get("from"),
             e["fields"].get("to"))
            for e in events_of_type(events, "health-transition")]


def illegal_transitions(events):
    """Journaled transitions the machine cannot legally make — a
    non-empty result is a daemon bug, the soak/chaos failure shape."""
    return [(key, src, dst) for key, src, dst in health_transitions(events)
            if (src, dst) not in LEGAL_TRANSITIONS]


def flap_suppressions(events):
    """[(key, reason)] from journaled flap-suppressed events, seq order
    — the governor's record of label flips it held back."""
    return [(e["fields"].get("key"), e["fields"].get("reason"))
            for e in events_of_type(events, "flap-suppressed")]


class Policy:
    """Mirror of healthsm::Policy (same clamps)."""

    def __init__(self, flap_window_s=300, flap_threshold=6,
                 quarantine_cooldown_s=600, unhealthy_after=2,
                 recover_after=3):
        self.flap_window_s = max(1, flap_window_s)
        self.flap_threshold = max(2, flap_threshold)
        self.quarantine_cooldown_s = max(1, quarantine_cooldown_s)
        self.unhealthy_after = max(1, unhealthy_after)
        self.recover_after = max(1, recover_after)


class _Entry:
    def __init__(self):
        self.state = HEALTHY
        self.consecutive_failures = 0
        self.consecutive_clean = 0
        self.last_fingerprint = None
        self.quarantine_until = 0.0
        self.from_quarantine = False
        self.flap_times = []


class HealthStateMachine:
    """Pure mirror of healthsm::HealthTracker::Observe. Time is always
    caller-supplied (seconds); observations are (ok, fingerprint)."""

    def __init__(self, policy=None):
        self.policy = policy or Policy()
        self._entries = {}
        self.transitions = []  # [(key, from, to)], for legality checks

    def state_of(self, key):
        entry = self._entries.get(key)
        return entry.state if entry else HEALTHY

    def quarantined(self, key):
        return self.state_of(key) == QUARANTINED

    def observe(self, key, ok, fingerprint, now):
        entry = self._entries.setdefault(key, _Entry())
        self._prune(entry, now)

        unstable = (ok and fingerprint is not None
                    and entry.last_fingerprint is not None
                    and fingerprint != entry.last_fingerprint)
        if ok and fingerprint is not None:
            entry.last_fingerprint = fingerprint
        clean = ok and not unstable

        if clean:
            entry.consecutive_failures = 0
            entry.consecutive_clean += 1
            if entry.state == SUSPECT:
                self._transition(key, entry, HEALTHY, now)
            elif entry.state == UNHEALTHY:
                entry.consecutive_clean = 1
                entry.from_quarantine = False
                self._transition(key, entry, RECOVERING, now)
            elif entry.state == RECOVERING:
                if entry.consecutive_clean >= self.policy.recover_after:
                    entry.from_quarantine = False
                    entry.quarantine_until = 0.0
                    self._transition(key, entry, HEALTHY, now)
            elif entry.state == QUARANTINED:
                if now < entry.quarantine_until:
                    entry.consecutive_clean = 0
                else:
                    entry.from_quarantine = True
                    self._transition(key, entry, RECOVERING, now)
        else:
            entry.consecutive_clean = 0
            entry.consecutive_failures += 1
            if entry.state == HEALTHY:
                entry.consecutive_failures = 1
                self._transition(key, entry, SUSPECT, now)
            elif entry.state == SUSPECT:
                if entry.consecutive_failures >= self.policy.unhealthy_after:
                    self._transition(key, entry, UNHEALTHY, now)
                elif unstable:
                    self._note_flap(key, entry, now)
            elif entry.state == UNHEALTHY:
                if unstable:
                    self._note_flap(key, entry, now)
            elif entry.state == RECOVERING:
                if entry.from_quarantine:
                    # A failure midway through an EARNED recovery re-arms
                    # the cooldown (mirrors healthsm.cc): straight back
                    # to quarantined, not down to unhealthy where a fresh
                    # flap threshold would be needed.
                    entry.quarantine_until = (
                        now + self.policy.quarantine_cooldown_s)
                    self._transition(key, entry, QUARANTINED, now)
                else:
                    self._transition(key, entry, UNHEALTHY, now)
            elif entry.state == QUARANTINED:
                entry.quarantine_until = (
                    now + self.policy.quarantine_cooldown_s)
        return entry.state

    def note_flap_evidence(self, key, now):
        """Mirror of healthsm::HealthTracker::NoteFlapEvidence — the
        plugin supervisor's containment hook: one unit of flap evidence
        from OUTSIDE the probe-verdict stream (a crash round, a
        contract-violation round). flap_threshold of these inside the
        window quarantine the key even though the state machine itself
        would park in `unhealthy` on identical failures."""
        entry = self._entries.setdefault(key, _Entry())
        self._prune(entry, now)
        self._note_flap(key, entry, now)
        return entry.state

    def _prune(self, entry, now):
        cutoff = now - self.policy.flap_window_s
        entry.flap_times = [t for t in entry.flap_times if t >= cutoff]

    def _note_flap(self, key, entry, now):
        entry.flap_times.append(now)
        self._prune(entry, now)
        if entry.state == QUARANTINED:
            return
        if len(entry.flap_times) < self.policy.flap_threshold:
            return
        entry.quarantine_until = now + self.policy.quarantine_cooldown_s
        entry.consecutive_clean = 0
        # Consumed by the quarantine they caused (mirrors the C++): the
        # exit transition must not land in a still-populated window.
        entry.flap_times = []
        self._transition(key, entry, QUARANTINED, now)

    def _transition(self, key, entry, to, now):
        if entry.state == to:
            return
        src = entry.state
        self.transitions.append((key, src, to))
        entry.state = to
        # Earned-recovery edges (quarantine exit, recovery completion)
        # are not flap evidence — mirrors the C++: counting them would
        # re-quarantine a clean key forever at flap_threshold=2.
        earned_recovery = (src == QUARANTINED
                           or (src == RECOVERING and to == HEALTHY))
        if to != QUARANTINED and not earned_recovery:
            self._note_flap(key, entry, now)
