"""`python -m tpufd_torch` as the daemon runs it: the health command's
label lines and metrics textfile, the perfmodel command's bare lines, and
the real daemon merging the port's labels into its feature file."""

import os
import re
import subprocess
import sys

from conftest import FIXTURES, REPO, labels_of

PREFIX = "google.com/tpu.health."


def run_port(*args, timeout=240):
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    env.pop("TFD_CHIP_COUNT", None)
    return subprocess.run([sys.executable, "-m", "tpufd_torch", *args],
                          cwd=str(REPO), env=env, capture_output=True,
                          text=True, timeout=timeout)


def test_health_cli_labels_and_metrics(tmp_path):
    from tpufd import metrics as ref_metrics

    metrics_out = tmp_path / "probe.prom"
    proc = run_port("health", "--device", "cpu", "--extended",
                    "--metrics-out", str(metrics_out))
    assert proc.returncode == 0, proc.stderr
    labels = labels_of(proc.stdout)
    assert labels[PREFIX + "ok"] == "true"
    assert all(k.startswith(PREFIX) for k in labels)
    for leaf in ("matmul-tflops", "hbm-gbps", "dma-copy-gbps"):
        assert float(labels[PREFIX + leaf]) > 0
    text = metrics_out.read_text()
    ref_metrics.validate_exposition(text)
    for probe in ("matmul-tflops", "hbm-gbps", "dma-copy-gbps"):
        assert ref_metrics.sample_value(
            text, "tpufd_probe_duration_seconds_count",
            labels={"probe": probe}) == 1
    assert ref_metrics.sample_value(text, "tpufd_health_ok") == 1


def test_perfmodel_cli_prints_only_bare_measurements():
    proc = run_port("perfmodel", "--device", "cpu")
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert [line.split("=")[0] for line in lines] == [
        "matmul-tflops", "hbm-gbps"]
    for line in lines:  # the grammar src/tfd/perf/perf.cc accepts
        assert re.fullmatch(r"(matmul-tflops|hbm-gbps)=\d+\.\d{3}", line)
        assert float(line.split("=")[1]) > 0


def test_cli_without_a_card_fails_loudly():
    proc = run_port("health", timeout=60)
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "no CUDA device" in proc.stderr


def test_daemon_merges_port_health_labels(tfd_binary, tmp_path):
    """The real daemon with --device-health=full execs the port and
    merges its labels into the feature file. The v2-8 mock enumerates 4
    chips against the port's one CPU device: the cross-check flags the
    mismatch without downgrading ok."""
    out_file = tmp_path / "tfd"
    env = {**os.environ, "PYTHONPATH": str(REPO),
           "GCE_METADATA_HOST": "127.0.0.1:1"}
    proc = subprocess.run(
        [str(tfd_binary), "--oneshot", f"--output-file={out_file}",
         "--backend=mock", f"--mock-topology-file={FIXTURES / 'v2-8.yaml'}",
         "--machine-type-file=/dev/null", "--device-health=full",
         "--health-exec=python3 -m tpufd_torch health --device cpu"],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    labels = labels_of(out_file.read_text())
    assert labels[PREFIX + "ok"] == "true"
    assert float(labels[PREFIX + "matmul-tflops"]) > 0
    assert float(labels[PREFIX + "hbm-gbps"]) > 0
    assert labels[PREFIX + "devices-consistent"] == "false"
    assert labels[PREFIX + "devices-jax"] == "1"
