"""The real daemon judging the port's execs, held to the port's own twins.

The perf labels: the daemon on the v5e-4 mock runs `tpufd_torch perfmodel
--device cpu` as its perf exec, with a --rated-specs-file that rates
family v5e and a --perf-fleet-floor-source file. Its tpu.perf.* labels
must equal perfmodel.expected_labels of the perf-measure event's readings,
classed by perfmodel.apply_fleet_floor(perfmodel.classify(...)), a floor
above the host's reading (class degraded) included.

The health ladder: the daemon runs the port's health command as its
health exec, switched per round by a file between `--device cpu` and no
device, which on this card-less host exits 1, so the daemon publishes
ok=false. The daemon feeds its state machine each round's verdict and the
fingerprint of the round's structural labels (src/tfd/sched/broker.cc
ObserveProbeHealth, src/tfd/sched/snapshot.cc FingerprintedLabel). The
port's healthsm, fed the same observations, must journal the same
transitions, reach `unhealthy`, and find every journaled transition
legal."""

import json
import os
import signal
import subprocess
import sys

import pytest

from conftest import FIXTURES, REPO, http_get, labels_of, wait_for
from tpufd.fakes import free_loopback_port
from tpufd_torch import healthsm, journal, perfmodel

PERF = "google.com/tpu.perf."
HEALTH = "google.com/tpu.health."
FAMILY = "v5e"  # the v5e-4 mock's family
# Rated near the host's reading (0.1-0.4 TFLOP/s, 200-320 GB/s here,
# lower under load), so the class turns on the host's speed; the test
# asserts equality with the twin, whatever the class.
SPECS = {FAMILY: {"matmul_tflops": 0.2, "hbm_gbps": 200.0}}
WAIT_S = 90


def start_daemon(binary, tmp_path, *flags):
    """The daemon on the v5e-4 mock at a 1 s cadence, its journal and
    feature file in `tmp_path`; returns (process, port, feature file)."""
    port = free_loopback_port()
    out_file = tmp_path / "tfd"
    argv = [str(binary), "--sleep-interval=1s", "--backend=mock",
            f"--mock-topology-file={FIXTURES / 'v5e-4.yaml'}",
            "--machine-type-file=/dev/null", "--no-timestamp",
            f"--output-file={out_file}",
            f"--introspection-addr=127.0.0.1:{port}",
            "--journal-capacity=4096", *flags]
    env = {**os.environ, "GCE_METADATA_HOST": "127.0.0.1:1",
           "PYTHONPATH": str(REPO)}
    proc = subprocess.Popen(argv, env=env, stderr=subprocess.DEVNULL)
    return proc, port, out_file


def stop(proc):
    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=10)


def feature_labels(out_file):
    try:
        return labels_of(out_file.read_text())
    except (OSError, ValueError):
        return {}


def journal_events(port):
    """The daemon's whole journal; [] while its server is not up."""
    status, body = http_get(port, "/debug/journal?n=0&type=")
    return journal.parse_journal(body)["events"] if status == 200 else []


FLOORS = {
    "below the reading": {"matmul_p10_tflops": 0.001, "hbm_p10_gbps": 1.0},
    "above the reading": {"matmul_p10_tflops": 1e6},
    "unset": {},
}


@pytest.mark.parametrize("floor", list(FLOORS), ids=list(FLOORS))
def test_daemon_perf_labels_equal_the_port_twin(tfd_binary, tmp_path,
                                                floor):
    specs_file = tmp_path / "rated_specs.json"
    specs_file.write_text(json.dumps({"families": SPECS}))
    floor_file = tmp_path / "floor.json"
    floor_file.write_text(json.dumps(FLOORS[floor]))
    proc, port, out_file = start_daemon(
        tfd_binary, tmp_path, "--perf-characterize",
        f"--perf-exec={sys.executable} -m tpufd_torch perfmodel "
        "--device cpu",
        f"--rated-specs-file={specs_file}",
        f"--perf-fleet-floor-source={floor_file}")
    try:
        assert wait_for(lambda: PERF + "class" in feature_labels(out_file),
                        timeout=WAIT_S), "no perf class published"
        labels = feature_labels(out_file)
        events = journal_events(port)
    finally:
        stop(proc)
    measured = journal.events_of_type(events, "perf-measure")
    assert len(measured) == 1
    fields = measured[0]["fields"]
    matmul, hbm, ici = (float(fields[k]) for k in
                        ("matmul_tflops", "hbm_gbps", "ici_gbps"))
    raw = perfmodel.classify(
        perfmodel.pct_of_rated(matmul, SPECS[FAMILY]["matmul_tflops"]),
        perfmodel.pct_of_rated(hbm, SPECS[FAMILY]["hbm_gbps"]))
    class_name = perfmodel.apply_fleet_floor(
        raw, matmul, hbm,
        perfmodel.parse_fleet_floor(floor_file.read_text()))
    want = perfmodel.expected_labels(matmul, hbm, ici, FAMILY, class_name,
                                     specs=SPECS)
    assert {k: v for k, v in labels.items() if k.startswith(PERF)} == want
    # The event's raw_class is the class after the floor, before the
    # ladder's debounce, which lets a first characterization through.
    assert fields["raw_class"] == fields["class"] == class_name
    assert PERF + "pct-of-rated" in want
    # The daemon journals a demotion only where the floor moved the class.
    demoted = journal.events_of_type(events, "perf-fleet-floor")
    assert len(demoted) == (class_name != raw)
    if floor == "above the reading":
        assert class_name == "degraded"
    else:
        assert class_name == raw


# The health exec, switched per round by PATTERN's character at the
# round's index (the last character once the pattern runs out): c runs
# the port on the host, f asks it for a card, which this host lacks. Each
# round leaves its stdout and exit code beside the counter.
EXEC = """\
n=$(cat {dir}/count 2>/dev/null || echo 0)
echo $((n + 1)) > {dir}/count
mode=$(cut -c$((n + 1)) {dir}/pattern)
[ -n "$mode" ] || mode=$(tail -c 2 {dir}/pattern | head -c 1)
if [ "$mode" = c ]; then device="--device cpu"; else device=""; fi
{python} -m tpufd_torch health $device > {dir}/round-$n.out
rc=$?
echo $rc > {dir}/round-$n.rc
cat {dir}/round-$n.out
exit $rc
"""
# No device, the host, no device: the two card-less rounds each move the
# fingerprint away from the host round's, the second after the first
# demoted the source, so the ladder reaches unhealthy at unhealthy_after
# (2) failing observations.
PATTERN = "fcf"


def fingerprinted(key):
    """src/tfd/sched/snapshot.cc FingerprintedLabel for the keys a health
    exec publishes: only the structural health facts count."""
    if not key.startswith(HEALTH):
        return True
    fact = key[len(HEALTH):]
    if fact.startswith("device-"):
        return False
    return (fact in ("ok", "devices", "devices-consistent")
            or fact.endswith("-ok") or fact.endswith("-degraded"))


def round_fingerprint(directory, n):
    """The fingerprint of round n's snapshot, as the daemon builds it
    (src/tfd/lm/health_exec.cc): a failed exec publishes ok=false alone,
    else its google.com/tpu.health.* lines."""
    rc = int((directory / f"round-{n}.rc").read_text())
    labels = {HEALTH + "ok": "false"}
    if rc == 0:
        labels = {k: v for k, v in labels_of(
            (directory / f"round-{n}.out").read_text()).items()
            if k.startswith(HEALTH)} or labels
    return tuple(sorted((k, v) for k, v in labels.items()
                        if fingerprinted(k)))


def test_daemon_health_ladder_follows_the_port_twin(tfd_binary, tmp_path):
    rounds = tmp_path / "rounds"
    rounds.mkdir()
    (rounds / "pattern").write_text(PATTERN + "\n")
    script = tmp_path / "health-exec.sh"
    script.write_text(EXEC.format(dir=rounds, python=sys.executable))
    proc, port, _ = start_daemon(
        tfd_binary, tmp_path, "--device-health=full",
        f"--health-exec=sh {script}", "--health-exec-interval=1s",
        "--health-exec-timeout=120s")

    def probes():
        return [e for e in journal_events(port)
                if e["type"] in ("probe-ok", "probe-fail")
                and e.get("source") == "health"]

    try:
        assert wait_for(
            lambda: sum(e["type"] == "probe-ok" for e in probes())
            >= len(PATTERN), timeout=WAIT_S), "the exec rounds never ran"
        events = journal_events(port)
    finally:
        stop(proc)

    assert not healthsm.illegal_transitions(events)
    # The twin takes what the daemon observed, in journal order: a failed
    # probe (no device snapshot yet) as a failure, each exec round as a
    # success carrying its snapshot's fingerprint.
    twin = healthsm.HealthStateMachine()
    seen, last_seq = 0, None
    for event in events:
        if event["type"] not in ("probe-ok", "probe-fail") or event.get(
                "source") != "health":
            continue
        if event["type"] == "probe-fail":
            twin.observe("health", False, None, event["ts"])
        else:
            twin.observe("health", True, round_fingerprint(rounds, seen),
                         event["ts"])
            seen += 1
        last_seq = event["seq"]
        if seen == len(PATTERN):
            break
    journaled = [t for t in healthsm.health_transitions(
        [e for e in events if e["seq"] <= last_seq]) if t[0] == "health"]
    assert journaled == twin.transitions
    assert twin.state_of("health") == healthsm.UNHEALTHY
    assert ("health", healthsm.SUSPECT, healthsm.UNHEALTHY) in journaled
    assert [int((rounds / f"round-{n}.rc").read_text())
            for n in range(len(PATTERN))] == [1, 0, 1]
