"""`python -m tpufd_torch` as the daemon and operators run it: the health
command's label lines and metrics textfile, the perfmodel command's bare
lines, the burnin command's report, and the real daemon merging the
port's health labels and perf measurements into its feature file."""

import os
import re
import subprocess
import sys

import pytest

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


def test_burnin_cli_on_cpu_prints_the_reference_lines(tmp_path):
    from tpufd import metrics as ref_metrics

    metrics_out = tmp_path / "burnin.prom"
    proc = run_port("burnin", "--device", "cpu", "--steps", "2",
                    "--skip-ring", "--metrics-out", str(metrics_out))
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[:2] == ["devices: 1 x cpu", "mesh: data=1 model=1"]
    match = re.fullmatch(r"final loss after 2 steps: (\S+) \(ok\)",
                         lines[2])
    assert match and float(match.group(1)) > 0 and len(lines) == 3
    text = metrics_out.read_text()
    ref_metrics.validate_exposition(text)
    for phase in ("compile", "steady"):
        assert ref_metrics.sample_value(
            text, "tpufd_burnin_step_duration_seconds_count",
            labels={"phase": phase}) == 1
    assert ref_metrics.sample_value(
        text, "tpufd_burnin_final_loss") == pytest.approx(
            float(match.group(1)), abs=1e-6)


def test_burnin_cli_without_a_card_fails_loudly():
    proc = run_port("burnin", timeout=60)
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "no CUDA device" in proc.stderr


def test_burnin_cli_model_parallelism_error_matches_jax(cpu_jax):
    """--model-parallelism 2 on one device: the reference's error."""
    from tpufd import mesh as ref_mesh

    with pytest.raises(ValueError) as want:
        ref_mesh.data_model_mesh(cpu_jax.devices("cpu")[:1],
                                 model_parallelism=2)
    proc = run_port("burnin", "--device", "cpu", "--model-parallelism", "2",
                    timeout=60)
    assert proc.returncode != 0 and proc.stdout == ""
    assert f"ValueError: {want.value}" in proc.stderr


def test_burnin_cli_rejects_non_positive_steps():
    proc = run_port("burnin", "--device", "cpu", "--steps", "0", timeout=60)
    assert proc.returncode == 2 and "must be >= 1" in proc.stderr


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


def daemon_perf_labels(binary, out_file, perf_exec, env):
    """The google.com/tpu.perf.* labels of one oneshot daemon pass that
    characterizes through `perf_exec` (v5e-4 mock: family v5e, whose
    rating is in the daemon's baked table)."""
    proc = subprocess.run(
        [str(binary), "--oneshot", f"--output-file={out_file}",
         "--backend=mock", f"--mock-topology-file={FIXTURES / 'v5e-4.yaml'}",
         "--machine-type-file=/dev/null", "--perf-characterize",
         f"--perf-exec={perf_exec}"],
        env={**env, "GCE_METADATA_HOST": "127.0.0.1:1"},
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    return {k: v for k, v in labels_of(out_file.read_text()).items()
            if k.startswith("google.com/tpu.perf.")}


def test_daemon_takes_port_perf_exec_like_the_reference(tfd_binary,
                                                        tmp_path):
    """The real daemon with --perf-characterize execs the port's
    perfmodel and publishes the same perf label keys as with the
    reference's, each run on one host device."""
    env = {**os.environ, "PYTHONPATH": str(REPO), "JAX_PLATFORMS": "cpu"}
    # One CPU device for the reference, as the port sees one host: with
    # several, it would add the all-reduce's ici-gbps.
    env.pop("XLA_FLAGS", None)
    port = daemon_perf_labels(
        tfd_binary, tmp_path / "port", "python3 -m tpufd_torch perfmodel "
        "--device cpu", env)
    ref = daemon_perf_labels(tfd_binary, tmp_path / "ref",
                             "python3 -m tpufd perfmodel", env)
    assert set(port) == set(ref) == {
        "google.com/tpu.perf." + leaf for leaf in
        ("matmul-tflops", "hbm-gbps", "pct-of-rated", "class")}
    for labels in (port, ref):
        assert float(labels["google.com/tpu.perf.matmul-tflops"]) > 0
        assert float(labels["google.com/tpu.perf.hbm-gbps"]) > 0


class FakeSpawn:
    """launch.spawn_ranks stand-in for the multi-card burnin command: the
    sharded step's call returns a loss; the ring call returns both modes,
    the causal one failed with `ring_error`, or raises `ring_raises`."""

    def __init__(self, ring_error=None, ring_raises=None):
        self.calls = []
        self.ring_error = ring_error
        self.ring_raises = ring_raises

    def __call__(self, fn, world, device_type, args=(), **kwargs):
        self.calls.append((fn.__name__, world, device_type, args))
        if fn.__name__ == "sharded_loss":
            return {"loss": 1.25, "metrics": ""}
        if self.ring_raises is not None:
            raise self.ring_raises
        return {"ring": [
            ("bidirectional", 2.5e-7, None),
            ("causal", None if self.ring_error else 3.5e-7, self.ring_error)],
            "metrics": ""}


RANK_DIED = RuntimeError("rank 1 of 2 failed:\nTraceback (most recent call "
                         "last):\n  File ...\nRuntimeError: NCCL error: "
                         "remote process exited")


@pytest.mark.parametrize("argv, ring, error, raises", [
    ([], True, None, None),
    (["--skip-ring"], False, None, None),
    (["--model-parallelism", "1"], True, "causal ring attention diverged",
     None),
    ([], True, None, RANK_DIED),
])
def test_burnin_cli_spawns_one_nccl_rank_per_card(monkeypatch, capsys, argv,
                                                  ring, error, raises):
    """With two visible cards the command runs the sharded step on one
    NCCL rank per card, prints the loss, then runs both ring modes in a
    second process group and prints the reference's lines; a failed ring
    mode, or a ring call that raised, prints FAILED and exits 1."""
    import torch

    from tpufd_torch import __main__ as cli
    from tpufd_torch import health, launch

    monkeypatch.setattr(health, "resolve_device",
                        lambda device: torch.device("cuda", 0))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "NVIDIA H100 80GB HBM3")
    spawn = FakeSpawn(ring_error=error, ring_raises=raises)
    monkeypatch.setattr(launch, "spawn_ranks", spawn)
    rc = cli.main(["burnin", "--steps", "3", *argv])
    mp = 1 if "--model-parallelism" in argv else None
    assert spawn.calls == [("sharded_loss", 2, "cuda", ("cuda", 3, mp))] + (
        [("ring_acceptance", 2, "cuda", ("cuda",))] if ring else [])
    lines = capsys.readouterr().out.splitlines()
    assert lines[:3] == [
        "devices: 2 x NVIDIA H100 80GB HBM3",
        f"mesh: data={2 if mp == 1 else 1} model={1 if mp == 1 else 2}",
        "final loss after 3 steps: 1.250000 (ok)"]
    if not ring:
        assert len(lines) == 3 and rc == 0
    elif raises is not None:
        assert lines[3:] == [
            f"{mode} ring attention FAILED: rank 1 of 2 failed: "
            f"RuntimeError: NCCL error: remote process exited"
            for mode in ("bidirectional", "causal")] and rc == 1
    elif error is None:
        assert lines[3:] == [
            "bidirectional ring attention over context=2: max abs err "
            "2.50e-07 vs full attention (ok)",
            "causal ring attention over context=2: max abs err 3.50e-07 vs "
            "full attention (ok)"] and rc == 0
    else:
        assert lines[4] == f"causal ring attention FAILED: {error}"
        assert rc == 1


def test_dryrun_multichip_hermetic_in_a_fresh_interpreter():
    """dryrun_multichip(4) in a fresh interpreter, as
    test_graft_dryrun_hermetic_subprocess runs the reference's: 4 gloo
    ranks run the sharded step and both ring modes, each rank checking
    that it never initialised CUDA."""
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run(
        [sys.executable, "-c",
         "import torch\n"
         "from tpufd_torch import graft_entry as g\n"
         "g.dryrun_multichip(4)\n"
         "assert not torch.cuda.is_initialized()\n"
         "print('DRYRUN_OK')"],
        cwd=str(REPO), env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.splitlines() == ["DRYRUN_OK"]
