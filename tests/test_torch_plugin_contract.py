"""The port's probe-plugin contract logic against the reference's:
`tpufd_torch.plugin` against `tpufd.plugin` on the grids the C++ unit
suite pins (tests/test_plugin.py's TestTwinParity), on handshakes, rounds,
conf stanzas and journal events drawn from a numpy seed, and on the
port's own `health --device cpu` labels wrapped as one round by the
in-tree device-health plugin."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from conftest import REPO
from tpufd import plugin as ref
from tpufd_torch import plugin

PLUGIN = REPO / "deployments" / "plugins" / "device-health"
LABEL_BUDGET = 32  # the daemon's --plugin-label-budget default

V1 = "tfd.probe/v1"
X = "google.com/tpu.plugin.x."


def handshake(**fields):
    return json.dumps({"contract": V1, "name": "x", "label_prefix": X,
                       **fields})


# tests/test_plugin.py TestTwinParity.test_handshake_grid's inputs.
HANDSHAKES = [
    handshake(name="libtpu-caps",
              label_prefix="google.com/tpu.plugin.libtpu.",
              interval_s=300, deadline_s=20),
    handshake(name="device-health", label_prefix="google.com/tpu.health."),
    handshake(contract="tfd.probe/v2", name="future",
              label_prefix="google.com/tpu.plugin.future."),
    "not json", "[1,2]",
    *[handshake(name=bad) for bad in (
        "", "Upper", "has_underscore", "-lead", "trail-",
        "waaaaaaaaaaaaaaaaaaaaaaaaaay-too-long-plugin-name")],
    *[handshake(label_prefix=bad) for bad in (
        "", "nvidia.com/gpu.", "google.com/", "google.com/tpu.plugin.x",
        "google.com/bad prefix.", "google.com/-lead.")],
    handshake(interval_s=86401),
]

HS = {"name": "x", "label_prefix": X}
# tests/test_plugin.py TestTwinParity.test_round_validation_grid's inputs.
ROUNDS = [
    (json.dumps({"labels": {X + "ok": "true", X + "version": "1.2.3"},
                 "facts": {"free": "form", "n": "2"}}), 32),
    (json.dumps({"facts": {"a": "b"}}), 32),
    ("}{ not json", 32),
    ("x" * (ref.MAX_ROUND_OUTPUT_BYTES + 1), 32),
    (json.dumps({"labels": {X + "a": "1", X + "b": "2",
                            "google.com/evil.escape": "3"}}), 2),
    (json.dumps({"labels": {X + "good": "1",
                            "google.com/tpu.perf.class": "gold",
                            "google.com/tpu.plugin.other.key": "2"}}), 32),
    (json.dumps({"labels": {X + "bad key": "1", X: "bare", X + "num": 7,
                            X + "val": "@@@", X + "ok": "fine value"}}), 32),
]

# tests/test_plugin.py TestTwinParity.test_conf_and_schedule_rules' inputs.
CONFS = ["# operator stanza\nenabled = true\ninterval = 5m\ndeadline = 45s\n",
         "enabled=false\n", "", "nonsense\n", "interval = soon\n",
         "color = red\n"]
NO_CONF = {"enabled": True, "interval_s": 0, "deadline_s": 0}
DEADLINES = [({"deadline_s": 5}, NO_CONF, 30),
             ({"deadline_s": 120}, NO_CONF, 30),
             ({"deadline_s": 0}, NO_CONF, 30),
             ({"deadline_s": 0}, {**NO_CONF, "deadline_s": 120}, 30),
             ({"deadline_s": 600}, {**NO_CONF, "deadline_s": 120}, 30)]
INTERVALS = [({"interval_s": 3600}, NO_CONF, 60),
             ({"interval_s": 1}, NO_CONF, 60),
             ({"interval_s": 1}, {**NO_CONF, "interval_s": 10}, 60),
             ({"interval_s": 86400}, {**NO_CONF, "interval_s": 300}, 60)]


@pytest.mark.parametrize("text", HANDSHAKES)
def test_handshake_grid_equals_the_reference(text):
    assert plugin.parse_handshake(text) == ref.parse_handshake(text)


@pytest.mark.parametrize("text, budget", ROUNDS)
def test_round_grid_equals_the_reference(text, budget):
    assert (plugin.parse_round_output(text, HS, budget)
            == ref.parse_round_output(text, HS, budget))


@pytest.mark.parametrize("text", CONFS)
def test_conf_grid_equals_the_reference(text):
    assert plugin.parse_plugin_conf(text) == ref.parse_plugin_conf(text)


@pytest.mark.parametrize("hs, conf, default", DEADLINES + INTERVALS)
def test_schedule_rules_equal_the_reference(hs, conf, default):
    for name in ("effective_deadline_s", "effective_interval_s"):
        assert (getattr(plugin, name)(hs, conf, default)
                == getattr(ref, name)(hs, conf, default)), name


def test_constants_equal_the_reference():
    for name in ("CONTRACT_V1", "SOURCE_PREFIX", "LABEL_DOMAIN",
                 "MAX_HANDSHAKE_BYTES", "MAX_ROUND_OUTPUT_BYTES",
                 "STATE_ACTIVE", "STATE_FAILING", "STATE_QUARANTINED",
                 "STATE_REJECTED"):
        assert getattr(plugin, name) == getattr(ref, name), name


# Pieces the drawn documents are made of: valid and invalid names,
# prefixes, keys and values, hints of every JSON type.
NAMES = ["x", "device-health", "a1", "", "Upper", "has_underscore", "-x",
         "x-", "é", "a" * 32, "a" * 33, 7, None]
PREFIXES = [X, "google.com/tpu.health.", "google.com/", "google.com/x",
            "nvidia.com/gpu.", "google.com/a b.", "google.com/" + "a" * 62
            + ".", 3, None]
HINTS = [0, 1, 30, 86400, 86401, -1, 2.5, "60", None, True]
LEAVES = ["ok", "version", "bad key", "", "a" * 70, "dé", "x.y_z-1", "-a",
          "a-"]
VALUES = ["true", "1.2.3", "fine value", "@@@", "", " pad ", "a" * 80,
          "ünï", "-x-", 7, None, ["l"], {"d": 1}]


def drawn_handshake(rng):
    """Each field absent now and then, else its pool's first (valid)
    entry two times in three, else any entry of the pool."""
    doc = {}
    for key, pool in (("contract", [V1, "tfd.probe/v2", "", None]),
                      ("name", NAMES), ("label_prefix", PREFIXES),
                      ("interval_s", HINTS), ("deadline_s", HINTS)):
        if rng.random() < 0.95:
            doc[key] = pool[0 if rng.random() < 0.67
                            else int(rng.integers(len(pool)))]
    return json.dumps(doc)


def drawn_round(rng, prefix):
    """A round's stdout: mostly a labels object under, beside or outside
    `prefix`, sometimes facts only, garbage, a non-object or truncated."""
    shape = rng.random()
    if shape < 0.05:
        return "}{ not json"
    if shape < 0.1:
        return json.dumps([1, 2])
    labels = {}
    for _ in range(int(rng.integers(0, 40))):
        base = [prefix, "google.com/tpu.perf.", "google.com/",
                "nvidia.com/"][int(rng.choice(4, p=[0.7, 0.1, 0.1, 0.1]))]
        labels[base + LEAVES[int(rng.integers(len(LEAVES)))]
               + str(int(rng.integers(3)))] = VALUES[
                   int(rng.integers(len(VALUES)))]
    doc = {"facts": {"n": "1"}} if shape < 0.15 else {
        "labels": labels if shape > 0.2 else "not an object"}
    text = json.dumps(doc, ensure_ascii=bool(rng.random() < 0.5))
    return text[:-1] if rng.random() < 0.05 else text


@pytest.mark.parametrize("seed", range(6))
def test_drawn_handshakes_and_rounds_equal_the_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(150):
        text = drawn_handshake(rng)
        got = plugin.parse_handshake(text)
        assert got == ref.parse_handshake(text), text
        hs = got[0] or HS
        budget = int(rng.choice([0, 1, 5, LABEL_BUDGET]))
        text = drawn_round(rng, hs["label_prefix"])
        assert (plugin.parse_round_output(text, hs, budget)
                == ref.parse_round_output(text, hs, budget)), text


@pytest.mark.parametrize("seed", range(3))
def test_drawn_validators_equal_the_reference(seed):
    rng = np.random.default_rng(seed)
    alphabet = list("abzAZ09-._ /é \t@")
    for _ in range(400):
        text = "".join(rng.choice(alphabet, size=int(rng.integers(0, 70))))
        for name in ("valid_label_name", "valid_plugin_name",
                     "strict_label_value"):
            assert (getattr(plugin, name)(text)
                    == getattr(ref, name)(text)), (name, text)
        prefix = "google.com/" + text
        assert (plugin.validate_label_prefix(prefix)
                == ref.validate_label_prefix(prefix)), prefix


@pytest.mark.parametrize("seed", range(3))
def test_drawn_confs_equal_the_reference(seed):
    rng = np.random.default_rng(seed)
    lines = ["enabled = true", "enabled=no", "enabled = maybe",
             "interval = 5m", "interval=1h30m", "interval = 90",
             "deadline = 45s", "deadline = soon", "deadline = 1m5",
             "# comment", "", "nonsense", "color = red", "interval = -3"]
    for _ in range(200):
        text = "\n".join(rng.choice(lines, size=int(rng.integers(0, 5))))
        assert plugin.parse_plugin_conf(text) == ref.parse_plugin_conf(text)


def test_drawn_violation_events_equal_the_reference():
    rng = np.random.default_rng(7)
    events = []
    for seq in range(1, 80):
        kind = ["plugin-violation", "plugin-kill", "probe-ok"][
            int(rng.integers(3))]
        fields = {}
        if rng.random() < 0.8:
            fields["plugin"] = ["device-health", "chaos", ""][
                int(rng.integers(3))]
        if rng.random() < 0.8:
            fields["kinds"] = ",".join(rng.choice(
                ["garbage", "namespace", "schema", "label-budget"],
                size=int(rng.integers(1, 3))))
        if rng.random() < 0.7:
            fields["round_rejected"] = ["true", "false"][
                int(rng.integers(2))]
        events.append({"seq": seq, "type": kind, "fields": fields})
    order = rng.permutation(len(events))
    as_dict = {events[i]["seq"]: events[i] for i in order}
    for given in (events, as_dict):
        got = plugin.plugin_violations(given)
        assert got == ref.plugin_violations(given)
        assert got  # the draw holds violations
    assert plugin.plugin_violations(as_dict) == plugin.plugin_violations(
        events)


def run_plugin(op, health_exec=None):
    env = {**os.environ, "PYTHONPATH": str(REPO), "TFD_PLUGIN_OP": op}
    if health_exec:
        env["TFD_PLUGIN_HEALTH_EXEC"] = health_exec
    proc = subprocess.run([sys.executable, str(PLUGIN)], cwd=str(REPO),
                          env=env, capture_output=True, text=True,
                          timeout=240)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


def test_port_health_round_meets_the_contract():
    """The port's `health --device cpu` labels, wrapped as one round by
    the in-tree device-health plugin under its own handshake, pass
    parse_round_output whole, on both sides, with no violation."""
    hs, err = plugin.parse_handshake(run_plugin("handshake"))
    assert err is None and hs["name"] == "device-health"
    text = run_plugin(
        "probe", f"{sys.executable} -m tpufd_torch health --device cpu")
    labels, violations, ok = plugin.parse_round_output(text, hs,
                                                       LABEL_BUDGET)
    assert (labels, violations, ok) == ref.parse_round_output(
        text, hs, LABEL_BUDGET)
    assert ok and violations == []
    assert labels == json.loads(text)["labels"]
    assert labels[hs["label_prefix"] + "ok"] == "true"
    assert float(labels[hs["label_prefix"] + "matmul-tflops"]) > 0
