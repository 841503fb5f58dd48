"""The port behind the in-tree `device-health` probe plugin, on the host.

The real daemon runs with --device-health=off and --plugin-dir holding a
byte-for-byte copy of deployments/plugins/device-health, which execs
$TFD_PLUGIN_HEALTH_EXEC and keeps its google.com/tpu.health.* lines. The
plugin's deadline is --plugin-timeout (30 s by default), raised here past
the exec's wall time. With `tpufd_torch health --device cpu` as the exec
the daemon publishes the same health keys as with `tpufd health` on JAX's
CPU backend; with the port asked for a card on this card-less host the
exec fails loudly and the plugin publishes `ok=false` alone, so the exec
neither fell back to the host nor published a measurement."""

import json
import os
import shutil
import subprocess
import sys

from conftest import FIXTURES, REPO, http_get, labels_of, wait_for
from tpufd import journal as tpufd_journal
from tpufd.fakes import free_loopback_port

PREFIX = "google.com/tpu.health."
PLUGIN = REPO / "deployments" / "plugins" / "device-health"
PLUGIN_TIMEOUT_S = 240
WAIT_S = 180


def plugin_health_labels(binary, tmp_path, name, health_exec, env=None,
                         exec_key=PREFIX + "matmul-tflops"):
    """The daemon's tpu.health.* labels (probe-ms aside) once the plugin
    published `exec_key`, and the journal's events then. The daemon runs
    in `env` (default: this process's environment)."""
    plugin_dir = tmp_path / f"plugins-{name}"
    plugin_dir.mkdir()
    shutil.copyfile(PLUGIN, plugin_dir / PLUGIN.name)
    (plugin_dir / PLUGIN.name).chmod(0o755)
    out_file = tmp_path / f"labels-{name}"
    port = free_loopback_port()
    env = {**(os.environ if env is None else env),
           "GCE_METADATA_HOST": "127.0.0.1:1", "PYTHONPATH": str(REPO),
           "TFD_PLUGIN_HEALTH_EXEC": health_exec}
    argv = [str(binary), "--sleep-interval=1s", "--backend=mock",
            f"--mock-topology-file={FIXTURES / 'v2-8.yaml'}",
            "--machine-type-file=/dev/null", "--no-timestamp",
            f"--output-file={out_file}",
            f"--introspection-addr=127.0.0.1:{port}",
            # Room for every event of the run: the mock source alone
            # journals a probe each second.
            "--journal-capacity=4096",
            "--device-health=off", f"--plugin-dir={plugin_dir}",
            f"--plugin-timeout={PLUGIN_TIMEOUT_S}s"]
    daemon = subprocess.Popen(argv, env=env, stderr=subprocess.DEVNULL)

    def labels():
        try:
            return labels_of(out_file.read_text())
        except (OSError, ValueError):
            return {}

    try:
        assert wait_for(lambda: exec_key in labels(), timeout=WAIT_S), (
            f"no {exec_key} from the plugin within {WAIT_S} s: {labels()}")
        health = {k: v for k, v in labels().items()
                  if k.startswith(PREFIX) and k != PREFIX + "probe-ms"}
        status, body = http_get(port, "/debug/journal")
        assert status == 200
        events = tpufd_journal.parse_journal(json.loads(body))["events"]
        return health, events
    finally:
        daemon.kill()
        daemon.wait()


def plugin_events(events, kind):
    return [e for e in events if e["type"] == kind
            and e["fields"].get("plugin") == "device-health"]


def test_port_behind_the_plugin_publishes_the_reference_keys(tfd_binary,
                                                            tmp_path):
    python = sys.executable
    port, port_events = plugin_health_labels(
        tfd_binary, tmp_path, "port",
        f"{python} -m tpufd_torch health --device cpu")
    # One host device for the reference, as the port sees one host: with
    # JAX's virtual devices it would add the all-reduce's label.
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    ref, _ = plugin_health_labels(
        tfd_binary, tmp_path, "ref", f"{python} -m tpufd health",
        env={**env, "JAX_PLATFORMS": "cpu"})
    assert port[PREFIX + "ok"] == ref[PREFIX + "ok"] == "true"
    assert set(port) == set(ref)
    for leaf in ("matmul-tflops", "hbm-gbps"):
        assert float(port[PREFIX + leaf]) > 0
    # The v2-8 mock enumerates 4 chips against one host device.
    assert port[PREFIX + "devices-consistent"] == "false"
    assert port[PREFIX + "devices-jax"] == "1"
    assert plugin_events(port_events, "plugin-discovered")
    assert not [e for e in port_events if e["type"] == "plugin-kill"]


def test_port_behind_the_plugin_without_a_card_publishes_only_ok_false(
        tfd_binary, tmp_path):
    health, events = plugin_health_labels(
        tfd_binary, tmp_path, "no-card",
        f"{sys.executable} -m tpufd_torch health",
        exec_key=PREFIX + "ok")
    assert health == {PREFIX + "ok": "false"}
    assert plugin_events(events, "plugin-discovered")
    assert not [e for e in events if e["type"] == "plugin-kill"]
