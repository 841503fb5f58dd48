"""The port's remediation engine twin against the reference's:
`tpufd_torch.remedy.RemedyEngine` against `tpufd.remedy.RemedyEngine`
over node, inventory and demand streams drawn from a numpy seed, under
several configurations. Each `tick` must emit the same actions and the
same newly blocked interlocks, each reported result (a write that fails
now and then) must leave the same state, and `render_json` must give the
same bytes; so must the change tracker and the helpers."""

import numpy as np
import pytest

from tpufd import remedy as ref
from tpufd_torch import remedy

OK = {"google.com/tpu.count": "4", "google.com/tpu.perf.class": "silver"}
VARIANTS = (
    {},
    {"google.com/tpu.perf.class": "degraded"},
    {"google.com/tpu.perf.chip1.class": "degraded"},
    {"google.com/tpu.lifecycle.preempt-imminent": "true"},
    {"google.com/tpu.lifecycle.draining": "true"},
    {"google.com/tpu.slice.degraded": "true"},
    {"google.com/tpu.slice.class": "degraded"},
    {"google.com/tpu.count": "junk"},
)
# (window_s, flap_threshold, heal_dwell_s, cooldown_s, backoff_base_s,
# backoff_max_s, max_concurrent_cordons, domain_cap, rebuild_cooldown_s)
CONFIGS = {
    "default": None,
    "tight": (10.0, 2, 2.0, 1.0, 0.5, 4.0, 2, 1, 5.0),
    "wide": (120.0, 4, 20.0, 0.0, 2.0, 60.0, 8, 3, 60.0),
}


def engines(config):
    if config is None:
        return remedy.RemedyEngine(), ref.RemedyEngine()
    return (remedy.RemedyEngine(remedy.RemedyConfig(*config)),
            ref.RemedyEngine(ref.RemedyConfig(*config)))


def stream(seed, nodes=10, n=500):
    rng = np.random.default_rng(1800 + seed)
    now = 100.0
    for _ in range(n):
        now += float(rng.choice([0.0, 0.3, 1.0, 2.5, 7.0]))
        pick = rng.random()
        if pick < 0.65:
            node = f"node-{int(rng.integers(nodes))}"
            if rng.random() < 0.05:
                yield "node", (node, None, now)
                continue
            labels = dict(OK)
            labels.update(VARIANTS[int(rng.integers(len(VARIANTS)))]
                          if rng.random() < 0.5 else {})
            if rng.random() < 0.6:
                labels[ref.DOMAIN_LABEL] = f"rack-{int(rng.integers(3))}"
            yield "node", (node, labels, now)
        elif pick < 0.72:
            burning = rng.random() < 0.3
            yield "inventory", ({"google.com/tpu.slo.publish.burn":
                                 "true" if burning else "false",
                                 "google.com/tpu.fleet.nodes": "10"}, now)
        elif pick < 0.77:
            yield "demand", (int(rng.integers(0, 48)), now)
        else:
            yield "tick", (now, rng.random() < 0.15)


def actions_of(actions):
    return [(a.kind, a.node, a.evidence, a.detected_at, a.reason)
            for a in actions]


@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("seed", range(3))
def test_engines_act_alike(config, seed):
    port, want = engines(CONFIGS[config])
    kinds = set()
    for op, args in stream(seed * 7 + len(config)):
        if op == "node":
            assert port.observe_node(*args) == want.observe_node(*args)
        elif op == "inventory":
            port.observe_inventory(*args)
            want.observe_inventory(*args)
        elif op == "demand":
            port.observe_demand(*args)
            want.observe_demand(*args)
        else:
            now, fail = args
            (got, got_blocked), (exp, exp_blocked) = (port.tick(now),
                                                      want.tick(now))
            assert actions_of(got) == actions_of(exp)
            assert repr(got) == repr(exp)
            assert got_blocked == exp_blocked
            for action in got:
                kinds.add(action.kind)
                ok = not fail
                port.note_action_result(action.node, action.kind, ok, now)
                want.note_action_result(action.node, action.kind, ok, now)
            if fail and port.nodes:
                assert port.abandon_pending() == want.abandon_pending()
        assert port.render_json() == want.render_json()
        assert port.cordoned_nodes() == want.cordoned_nodes()
        assert port.predicted_capacity_chips(0) == \
            want.predicted_capacity_chips(0)
    assert port.counters == want.counters
    assert "cordon" in kinds


def test_tracker_closes_alike():
    rng = np.random.default_rng(1900)
    port, want = remedy.RemedyTracker(), ref.RemedyTracker()
    open_changes = []
    for _ in range(300):
        t = float(rng.uniform(0, 100))
        op = int(rng.integers(4))
        if op == 0 or not open_changes:
            node = f"node-{int(rng.integers(5))}"
            kind = str(rng.choice(ref.ACTION_KINDS))
            change = port.mint(kind, node, t)
            assert change == want.mint(kind, node, t)
            open_changes.append(change)
        elif op == 1:
            change = open_changes[int(rng.integers(len(open_changes)))]
            stage = str(rng.choice(ref.REMEDY_STAGES + ("bogus",)))
            port.stamp(change, stage, t)
            want.stamp(change, stage, t)
        elif op == 2:
            change = open_changes.pop(int(rng.integers(len(open_changes))))
            assert port.close(change, t) == want.close(change, t)
        else:
            change = open_changes.pop()
            port.discard(change)
            want.discard(change)
    assert port.closed == want.closed and port.open == want.open


def test_helpers_and_vocabularies_equal():
    rng = np.random.default_rng(2000)
    for labels in [None, {}] + [dict(OK, **v) for v in VARIANTS]:
        assert remedy.eligible(labels) == ref.eligible(labels)
        if labels is not None:
            assert remedy.gray_degraded(labels) == ref.gray_degraded(labels)
    for _ in range(300):
        node, fails = f"node-{int(rng.integers(10 ** 6))}", int(
            rng.integers(0, 20))
        assert remedy.backoff_jitter_unit(node, fails) == \
            ref.backoff_jitter_unit(node, fails)
    config = ref.RemedyConfig()
    for fails in range(1, 12):
        assert remedy.cfg_backoff(config, fails) == ref.cfg_backoff(
            config, fails)
    assert vars(remedy.RemedyConfig()) == vars(ref.RemedyConfig())
    for name in ("ACTION_KINDS", "INTERLOCKS", "CORDON_EVIDENCE",
                 "REMEDY_STAGES", "DOMAIN_LABEL", "DRAIN_LABEL",
                 "CHIP_CLASS_PREFIX", "CHIP_CLASS_SUFFIX", "SLO_BURN_PREFIX"):
        assert getattr(remedy, name) == getattr(ref, name), name
