"""The port's health state machine against the reference's:
`tpufd_torch.healthsm` against `tpufd.healthsm` on observation sequences
drawn from a numpy seed (flap evidence included), over several keys and
policies (the clamps included), and the journal readers on generated
events."""

import numpy as np
import pytest

from tpufd import healthsm as ref
from tpufd_torch import healthsm

KEYS = ("health", "mock", "plugin.device-health", "health/chip-0")
FINGERPRINTS = (None, 0x11, 0x22, 0x33)
# (flap_window_s, flap_threshold, quarantine_cooldown_s, unhealthy_after,
# recover_after): the defaults, a tight policy that quarantines and
# recovers within a few steps, and two that every clamp rewrites.
POLICIES = {
    "default": None,
    "tight": (6, 2, 3, 1, 1),
    "slow": (40, 4, 15, 3, 2),
    "clamped-zero": (0, 0, 0, 0, 0),
    "clamped-negative": (-5, 1, -1, -2, -7),
}


def machines(policy):
    if policy is None:
        return healthsm.HealthStateMachine(), ref.HealthStateMachine()
    return (healthsm.HealthStateMachine(healthsm.Policy(*policy)),
            ref.HealthStateMachine(ref.Policy(*policy)))


def steps(seed, n=400):
    """(op, key, ok, fingerprint, now) from a numpy seed: observations
    and, one in eight, flap evidence; the clock advances by 0 to 4 s a
    step and now and then jumps past every cooldown."""
    rng = np.random.default_rng(seed)
    now = 1000.0
    for _ in range(n):
        now += float(rng.choice([0.0, 0.5, 1.0, 2.0, 4.0]))
        if rng.random() < 0.03:
            now += 700.0
        key = KEYS[int(rng.integers(len(KEYS)))]
        if rng.random() < 0.125:
            yield "evidence", key, None, None, now
        else:
            yield ("observe", key, bool(rng.random() < 0.6),
                   FINGERPRINTS[int(rng.integers(len(FINGERPRINTS)))], now)


@pytest.mark.parametrize("policy", list(POLICIES), ids=list(POLICIES))
@pytest.mark.parametrize("seed", range(4))
def test_machines_step_alike(policy, seed):
    port, want = machines(POLICIES[policy])
    assert vars(port.policy) == vars(want.policy)
    for op, key, ok, fingerprint, now in steps(seed * 31 + len(policy)):
        if op == "evidence":
            got = port.note_flap_evidence(key, now)
            expected = want.note_flap_evidence(key, now)
        else:
            got = port.observe(key, ok, fingerprint, now)
            expected = want.observe(key, ok, fingerprint, now)
        assert got == expected
        for k in KEYS:
            assert port.state_of(k) == want.state_of(k)
            assert port.quarantined(k) == want.quarantined(k)
    assert port.transitions == want.transitions
    assert not [t for t in port.transitions
                if t[1:] not in healthsm.LEGAL_TRANSITIONS]


def test_sequences_reach_every_state():
    """The drawn sequences drive each machine through all five states
    and quarantine under the tight policy."""
    port, _ = machines(POLICIES["tight"])
    for op, key, ok, fingerprint, now in steps(0):
        if op == "evidence":
            port.note_flap_evidence(key, now)
        else:
            port.observe(key, ok, fingerprint, now)
    assert {dst for _, _, dst in port.transitions} == set(healthsm.STATES)


@pytest.mark.parametrize("policy", [p for p in POLICIES.values() if p],
                         ids=[k for k, p in POLICIES.items() if p])
def test_policy_clamps_equal_the_reference(policy):
    assert vars(healthsm.Policy(*policy)) == vars(ref.Policy(*policy))


def test_vocabulary_equals_the_reference():
    assert healthsm.STATES == ref.STATES
    assert healthsm.STATE_GAUGE_VALUES == ref.STATE_GAUGE_VALUES
    assert healthsm.LEGAL_TRANSITIONS == ref.LEGAL_TRANSITIONS
    for value in (0, 1, 2, 3, 4, 2.0, "3"):
        assert healthsm.state_name(value) == ref.state_name(value)


def journal_events(seed):
    """Journal events from a numpy seed: health transitions (some not
    legal), flap suppressions and other types, as a list and as the
    seq->event dict merge_events builds (in shuffled insertion order)."""
    rng = np.random.default_rng(seed)
    events = []
    for seq in range(1, 60):
        kind = ("health-transition", "flap-suppressed", "probe-ok")[
            int(rng.integers(3))]
        if kind == "health-transition":
            src, dst = rng.choice(healthsm.STATES, size=2)
            fields = {"key": KEYS[int(rng.integers(len(KEYS)))],
                      "from": str(src), "to": str(dst), "reason": "drawn"}
        elif kind == "flap-suppressed":
            fields = {"key": "google.com/tpu.count", "reason": "hold-down"}
        else:
            fields = {"duration_s": "1.5"}
        events.append({"seq": seq, "ts": 1.7e9 + seq, "generation": 1,
                       "change": 0, "type": kind, "fields": fields})
    order = rng.permutation(len(events))
    return events, {events[i]["seq"]: events[i] for i in order}


@pytest.mark.parametrize("seed", range(3))
def test_journal_readers_equal_the_reference(seed):
    for events in journal_events(seed):
        got = healthsm.illegal_transitions(events)
        assert got == ref.illegal_transitions(events)
        assert got  # the drawn pairs include illegal ones
        assert (healthsm.health_transitions(events)
                == ref.health_transitions(events))
        assert (healthsm.flap_suppressions(events)
                == ref.flap_suppressions(events))
