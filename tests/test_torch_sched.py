"""The port's snapshot tiers and store against the reference's, and the
real daemon's staleness read through them.

`tpufd_torch.sched` is held to `tpufd.sched`: the tier names,
`device_policy` and `tier_of` on a grid of policies and ages (each
boundary and 1e-9 either side of it), and `SnapshotStore` on sequences of
register / put_ok / put_error / view drawn from a numpy seed, with the
reference's `now or time.monotonic()` (an explicit now of 0 reads as
"now") pinned as it is.

Then the real daemon on the v5e-4 mock at a 1 s cadence, its mock probe
failed by --fault-spec long enough to age past 4 s and 10 s: its
tier-change journal records for `mock` must walk none -> fresh ->
stale-usable -> expired -> fresh, each record's `to` equal to
`tpufd_torch.sched.tier_of(age_s, device_policy(1))`. The daemon prints
age_s with std::to_string, 6 decimals (src/tfd/sched/snapshot.cc:300), so
a record whose printed age lies within 1e-6 of a tier boundary may carry
the tier of either side; that case alone is accepted
(chip_smoke.tier_within_rounding). Last, the checks chip_smoke.py phase 8
runs on the card, on daemons whose execs are `echo`: under
--device-health=full with --perf-characterize, and behind the in-tree
device-health plugin."""

import itertools
import os
import shutil
import time

import numpy as np
import pytest

import chip_smoke
from conftest import FIXTURES, REPO, wait_for
from tpufd import sched as ref
from tpufd_torch import sched
from tpufd_torch.fakes import free_loopback_port

SLEEPS = (1, 5, 60)
DEADLINES = (0, 10, 270)
OVERRIDES = (0, 600)
POLICY_ARGS = list(itertools.product(SLEEPS, DEADLINES, OVERRIDES))


def ages_around(policy):
    """None, -1, 0, each boundary and 1e-9 either side of it, and 1e9."""
    ages = [None, -1, 0, 1e9]
    for edge in (policy.fresh_for_s, policy.usable_for_s):
        ages += [edge - 1e-9, edge, edge + 1e-9]
    return ages


TIER_CASES = [(args, age) for args in POLICY_ARGS
              for age in ages_around(sched.device_policy(*args))]


def test_tier_names_equal_the_reference():
    assert ((sched.FRESH, sched.STALE_USABLE, sched.EXPIRED, sched.NONE)
            == (ref.FRESH, ref.STALE_USABLE, ref.EXPIRED, ref.NONE)
            == ("fresh", "stale-usable", "expired", "none"))


@pytest.mark.parametrize("args", POLICY_ARGS, ids=str)
def test_device_policy_equals_the_reference(args):
    port, want = sched.device_policy(*args), ref.device_policy(*args)
    assert isinstance(port, sched.TierPolicy)
    assert ((port.fresh_for_s, port.usable_for_s)
            == (want.fresh_for_s, want.usable_for_s))


@pytest.mark.parametrize("args,age", TIER_CASES, ids=str)
def test_tier_of_equals_the_reference(args, age):
    got = sched.tier_of(age, sched.device_policy(*args))
    assert got == ref.tier_of(age, ref.device_policy(*args))
    assert got in (sched.FRESH, sched.STALE_USABLE, sched.EXPIRED,
                   sched.NONE)


SOURCES = ("mock", "health", "perf", "plugin.device-health")


def store_ops(seed, n=300):
    """(op, source, args) from a numpy seed: registrations (re-registering
    resets a source), results and errors at an explicit clock that
    advances by 0 to 6 s a step, and views at that clock."""
    rng = np.random.default_rng(seed)
    now = 1000.0
    for _ in range(n):
        now += float(rng.uniform(0, 6))
        source = SOURCES[int(rng.integers(len(SOURCES)))]
        op = ("register", "put_ok", "put_error", "view", "view")[
            int(rng.integers(5))]
        if op == "register":
            args = tuple(int(rng.choice(values)) for values in
                         (SLEEPS, DEADLINES, OVERRIDES))
        elif op == "put_ok":
            args = ({"labels": int(rng.integers(1 << 30))}, now)
        elif op == "put_error":
            args = (f"probe failed ({int(rng.integers(100))})",)
        else:
            args = (now,)
        yield op, source, args


def apply(store, module, op, source, args):
    if op == "register":
        return store.register(source, module.device_policy(*args))
    return getattr(store, op)(source, *args)


@pytest.mark.parametrize("seed", range(6))
def test_snapshot_store_equals_the_reference(seed):
    port, want = sched.SnapshotStore(), ref.SnapshotStore()
    registered, views = set(), 0
    for op, source, args in store_ops(seed):
        if op != "register" and source not in registered:
            with pytest.raises(KeyError):
                apply(port, sched, op, source, args)
            with pytest.raises(KeyError):
                apply(want, ref, op, source, args)
            continue
        registered.add(source)
        got = apply(port, sched, op, source, args)
        assert got == apply(want, ref, op, source, args)
        views += op == "view"
        assert port.sources() == want.sources()
    assert views > 50
    assert {port.view(s, 1e6)["tier"] for s in port.sources()} <= {
        sched.EXPIRED, sched.NONE}


@pytest.mark.parametrize("zero", [0, 0.0])
def test_now_zero_reads_as_now_as_in_the_reference(monkeypatch, zero):
    """`put_ok(now=0)` and `view(now=0)` take `now or time.monotonic()`,
    so 0 is "now", not time zero: a question on the reference, pinned."""
    assert sched.time is ref.time
    monkeypatch.setattr(sched.time, "monotonic", lambda: 500.0)
    views = []
    for module in (sched, ref):
        store = module.SnapshotStore()
        store.register("mock", module.device_policy(1))
        store.put_ok("mock", "v", now=zero)
        views.append((store.view("mock", now=zero),
                      store.view("mock", now=503.0),
                      store.view("mock", now=520.0)))
    assert views[0] == views[1]
    at_zero, at_503, at_520 = views[0]
    assert (at_zero["age_s"], at_zero["tier"]) == (0.0, sched.FRESH)
    assert (at_503["age_s"], at_503["tier"]) == (3.0, sched.FRESH)
    assert (at_520["age_s"], at_520["tier"]) == (20.0, sched.EXPIRED)


# ---- the checks phase 8 runs, on records made up here ----------------------

def record(source, frm, to, age):
    return {"type": "tier-change", "source": source,
            "fields": {"from": frm, "to": to, "age_s": f"{age:.6f}"}}


MOCK = {"mock": sched.device_policy(1)}


def test_tier_walks_accept_the_daemons_rounding_at_a_boundary():
    walks = chip_smoke.tier_walks([
        record("mock", "none", "fresh", 0.0),
        # 4.0000004 s prints as 4.000000: stale-usable, printed fresh-side.
        record("mock", "fresh", "stale-usable", 4.0000004),
        record("mock", "stale-usable", "fresh", 0.1)], MOCK)
    assert walks == {"mock": ["none", "fresh", "stale-usable", "fresh"]}


@pytest.mark.parametrize("events", [
    [record("mock", "none", "stale-usable", 3.9)],
    [record("mock", "none", "fresh", 4.000002)],
    [record("mock", "none", "fresh", 0.0),
     record("mock", "none", "fresh", 0.0)],
    [record("mock", "fresh", "expired", 11.0)],
    [record("health", "none", "fresh", 0.0)],
], ids=["wrong tier", "past the rounding", "from not the last to",
        "from not none first", "no policy"])
def test_tier_walks_refuse(events):
    with pytest.raises(SystemExit):
        chip_smoke.tier_walks(events, MOCK)


# ---- the real daemon --------------------------------------------------------

def run_daemon(binary, tmp_path, *flags, env=None):
    """chip_smoke.daemon on the v5e-4 mock at a 1 s cadence; returns
    (context manager, port, environment, stderr path)."""
    port = free_loopback_port()
    env = {**os.environ, "GCE_METADATA_HOST": "127.0.0.1:1",
           "PYTHONPATH": str(REPO), chip_smoke.DAEMON_TAG: str(tmp_path),
           **(env or {})}
    argv = [str(binary), "--sleep-interval=1s", "--backend=mock",
            f"--mock-topology-file={FIXTURES / 'v5e-4.yaml'}",
            "--machine-type-file=/dev/null", "--no-timestamp",
            f"--output-file={tmp_path / 'tfd'}",
            f"--introspection-addr=127.0.0.1:{port}",
            "--journal-capacity=4096", *flags]
    stderr_path = tmp_path / "daemon.stderr"
    return chip_smoke.daemon(argv, env, stderr_path), port, env, stderr_path


def tier_changes(env, port):
    status, _ = chip_smoke.debug_get(port, "/metrics")
    if status != 200:
        return []
    return chip_smoke.journal_events(env, port, "tier-change")


def test_daemon_mock_tiers_walk_as_the_port_classifies(tfd_binary,
                                                       tmp_path):
    # Three probes pass, then four fail: backoff 1, 2, 4 and 8 s (+25%
    # jitter at most) leaves the snapshot 17-21 s old before the next
    # success, past 4 s (stale-usable) and 10 s (expired).
    fault = "probe.mock:hang=1ms:count=3,probe.mock:fail:count=4"
    started, port, env, stderr_path = run_daemon(
        tfd_binary, tmp_path, f"--fault-spec={fault}")
    walk = ["none", "fresh", "stale-usable", "expired", "fresh"]
    t0 = time.monotonic()
    with started:
        assert wait_for(lambda: len(tier_changes(env, port)) >= 4,
                        timeout=40, interval=0.5), (
            f"tier-change records: {tier_changes(env, port)}")
        events = tier_changes(env, port)
        policies = chip_smoke.source_policies(
            chip_smoke.daemon_flags(stderr_path))
    assert time.monotonic() - t0 < 40
    assert set(policies) == {"mock"}
    want = sched.device_policy(1)
    assert ((policies["mock"].fresh_for_s, policies["mock"].usable_for_s)
            == (want.fresh_for_s, want.usable_for_s) == (4, 10))
    assert chip_smoke.tier_walks(events, policies) == {"mock": walk}
    for event in events:
        age = float(event["fields"]["age_s"])
        assert (event["fields"]["to"] == sched.tier_of(age, want)
                or chip_smoke.tier_within_rounding(
                    event["fields"]["to"], age, want)
                and min(abs(age - 4), abs(age - 10)) <= 1e-6), event


def journaled(say):
    return lambda text: say.append(text)


def test_phase8_tier_checks_under_full_health_and_perf(tfd_binary,
                                                       tmp_path):
    said = []
    started, port, env, stderr_path = run_daemon(
        tfd_binary, tmp_path, "--device-health=full",
        "--health-exec=echo google.com/tpu.health.ok=true",
        "--perf-characterize",
        "--perf-exec=printf 'matmul-tflops=100\\nhbm-gbps=500\\n'")
    with started:
        assert wait_for(lambda: {e["source"] for e in tier_changes(env, port)}
                        >= {"mock", "health", "perf"}, timeout=40,
                        interval=0.5), tier_changes(env, port)
        flags = chip_smoke.daemon_flags(stderr_path)
        policies = chip_smoke.source_policies(flags)
        chip_smoke.check_snapshot_tiers(env, port, policies, "here",
                                        journaled(said))
    # sources.cc:724-727 and :785-788 at the flag defaults of config.h.
    assert {s: (p.fresh_for_s, p.usable_for_s) for s, p in policies.items()
            } == {"mock": (4, 10), "health": (3844, 3850),
                  "perf": (21904, 43504)}
    lifecycle = chip_smoke.source_policies({**flags, "lifecycleWatch": True})
    assert (lifecycle["lifecycle"].fresh_for_s,
            lifecycle["lifecycle"].usable_for_s) == (14, 20)
    for source in ("mock", "health", "perf"):
        assert any(line.startswith(f"snapshot {source}: ") and "fresh" in line
                   for line in said), said
        assert f"tier-change {source}: 1 record(s), none -> fresh, each " \
               "equal to sched.tier_of of its age_s" in said


def test_phase8_tier_checks_behind_the_plugin(tfd_binary, tmp_path):
    said = []
    plugin_dir = tmp_path / "plugins"
    plugin_dir.mkdir()
    path = plugin_dir / chip_smoke.PLUGIN.name
    shutil.copyfile(chip_smoke.PLUGIN, path)
    path.chmod(0o755)
    started, port, env, stderr_path = run_daemon(
        tfd_binary, tmp_path, "--device-health=off",
        f"--plugin-dir={plugin_dir}", "--plugin-timeout=180s",
        env={"TFD_PLUGIN_HEALTH_EXEC":
             "echo google.com/tpu.health.ok=true"})
    with started:
        assert wait_for(lambda: "plugin.device-health" in {
            e["source"] for e in tier_changes(env, port)}, timeout=40,
                        interval=0.5), tier_changes(env, port)
        flags = chip_smoke.daemon_flags(stderr_path)
        resolved = chip_smoke.plugin_source(path, env, flags)
        discovered = chip_smoke.journal_events(env, port,
                                               "plugin-discovered")
        policies = chip_smoke.source_policies(flags, [resolved])
        chip_smoke.check_snapshot_tiers(env, port, policies, "here",
                                        journaled(said))
    # The handshake's 3600 s interval hint, and --plugin-timeout.
    assert resolved == ("plugin.device-health", 3600, 180)
    assert (discovered[-1]["fields"]["interval_s"],
            discovered[-1]["fields"]["deadline_s"]) == ("3600", "180")
    policy = policies["plugin.device-health"]
    assert (policy.fresh_for_s, policy.usable_for_s) == (3784, 3790)
    assert ("tier-change plugin.device-health: 1 record(s), none -> fresh, "
            "each equal to sched.tier_of of its age_s") in said
