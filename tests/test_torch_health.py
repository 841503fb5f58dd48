"""The port's probes, timer, rated context, label set and probe
scheduler, held against the JAX package on the CPU."""

import time

import numpy as np
import pytest
import torch

from tpufd_torch import health, metrics, sched

PREFIX = "google.com/tpu.health."
MULTI_DEVICE_LEAVES = ("allreduce-gbps",)


def normal(shape, seed, scale=1.0):
    return np.random.default_rng(seed).standard_normal(
        shape, dtype=np.float32) * scale


# ---- the probes' arithmetic ------------------------------------------------

def test_matmul_chain_float32_matches_jax(cpu_jax):
    """float32, where the point is the algorithm: rtol 1e-5."""
    from tpufd import health as ref

    x = normal((64, 64), seed=1, scale=0.1)
    want = np.asarray(ref._matmul_chain(cpu_jax.numpy.asarray(x),
                                        cpu_jax.numpy.int32(3)))
    got = health._matmul_chain(torch.from_numpy(x), 3).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


def test_matmul_chain_bf16_matches_jax(cpu_jax):
    """bf16: the two round at other places (XLA on the CPU rounds after
    each elementwise op, the port's fused tail once, in float32), so the
    bound is a few bf16 ulps: rtol 2e-2."""
    from tpufd import health as ref

    jnp = cpu_jax.numpy
    x = normal((64, 64), seed=2, scale=0.1)
    want = np.asarray(ref._matmul_chain(jnp.asarray(x, dtype=jnp.bfloat16),
                                        jnp.int32(3)), dtype=np.float32)
    got = health._matmul_chain(torch.from_numpy(x).to(torch.bfloat16), 3)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2,
                               atol=1e-3)


@pytest.mark.parametrize("n", [1, 2, 5])
def test_stream_matches_jax_exactly(cpu_jax, n):
    from tpufd import health as ref

    jnp = cpu_jax.numpy
    x = normal((4096,), seed=n)
    want = np.asarray(ref._stream(jnp.asarray(x, dtype=jnp.bfloat16),
                                  jnp.int32(n))).view(np.uint16)
    got = health._stream(torch.from_numpy(x).to(torch.bfloat16), n)
    np.testing.assert_array_equal(
        got.view(torch.int16).numpy().view(np.uint16), want)


def test_stream_works_in_place():
    x = torch.ones(8, dtype=torch.bfloat16)
    assert health._stream(x, 3) is x and float(x[0]) == -1.0


# ---- the differential timer ------------------------------------------------

class FakeClock:
    """perf_counter stand-in: a probe call advances it by a fixed
    overhead plus `per_iter` seconds per loop iteration."""

    def __init__(self, per_iter, overhead=0.5):
        self.now = 0.0
        self.per_iter = per_iter
        self.overhead = overhead

    def __call__(self):
        return self.now

    def probe(self, n, salt):
        self.now += self.overhead + int(n) * self.per_iter
        return np.array([float(salt)])


@pytest.mark.parametrize("per_iter", [1e-3, 1e-4, 2.0])
def test_time_iters_matches_jax_timer(cpu_jax, monkeypatch, per_iter):
    """Same calibration and normalisation as tpufd's timer: with a cost
    linear in n the fixed overhead cancels and both return iters *
    per_iter."""
    from tpufd import health as ref

    results = []
    for module in (ref, health):
        clock = FakeClock(per_iter)
        monkeypatch.setattr(time, "perf_counter", clock)
        results.append(module._time_iters(clock.probe, 4, settle_s=0.02))
        monkeypatch.undo()
    assert results[0] == results[1] == pytest.approx(4 * per_iter)


def test_time_iters_raises_when_device_time_never_grows(monkeypatch):
    clock = FakeClock(per_iter=0.0)
    monkeypatch.setattr(time, "perf_counter", clock)
    with pytest.raises(RuntimeError, match="unmeasurable"):
        health._time_iters(clock.probe, 4, settle_s=0.02)


def test_settle_and_device_resolution():
    assert health._settle_s(torch.device("cpu")) == 0.02
    assert health._settle_s(torch.device("cuda", 0)) == 0.15
    assert health.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        health.resolve_device("meta")


@pytest.mark.parametrize("device", [None, "cuda", "cuda:0"])
def test_card_request_raises_without_a_card(device):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        health.resolve_device(device)


def test_health_labels_without_a_device_raises_here():
    """No card and no explicit CPU request: raise, never carry on quietly
    on the host."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        health.health_labels()


# ---- rated context ---------------------------------------------------------

@pytest.mark.parametrize("name, family", [
    ("NVIDIA H100 80GB HBM3", "h100-sxm"),
    ("NVIDIA H100 SXM5 80GB", "h100-sxm"),
    ("NVIDIA H100 PCIe", "h100-pcie"),
    ("NVIDIA H100 NVL", None),
    ("NVIDIA H200", None),
    ("NVIDIA A100-SXM4-80GB", None),
    ("", None),
])
def test_family_of_name(name, family):
    assert health.family_of_name(name) == family


def test_family_of_cpu_is_none():
    assert health.family_of("cpu") is None


def test_rated_tables_are_h100_data_sheet_figures():
    assert health.RATED_MATMUL_TFLOPS == {"h100-sxm": 989.0,
                                          "h100-pcie": 756.0}
    assert health.RATED_HBM_GBPS == {"h100-sxm": 3350.0, "h100-pcie": 2000.0}
    assert health.DEGRADED_PCT == 50


def test_pct_of_rated_matches_jax(cpu_jax):
    from tpufd import health as ref

    table = {"a": 200.0}
    for measured in (0.0, 13.3, 150.0, 250.0):
        for family in ("a", "b", None):
            assert (health.pct_of_rated(measured, family, table)
                    == ref.pct_of_rated(measured, family, table))


# ---- the label set ---------------------------------------------------------

def stub_probes(monkeypatch, module, share, family, rated):
    """Probe results at `share` of the family's rating (1.0 when unrated),
    so both packages publish the same pct-of-rated labels."""
    def value(table):
        return share * table[family] if family else 42.0

    monkeypatch.setattr(module, "family_of", lambda device: family)
    monkeypatch.setattr(module, "matmul_tflops",
                        lambda **kw: value(rated[0]))
    monkeypatch.setattr(module, "hbm_gbps", lambda **kw: value(rated[1]))
    monkeypatch.setattr(module, "dma_copy_gbps", lambda **kw: value(rated[1]))


def leaves(labels):
    return {k[len(PREFIX):] for k in labels}


@pytest.mark.parametrize("share", [0.3, 0.9])
@pytest.mark.parametrize("extended", [False, True])
def test_label_keys_equal_jax_at_one_device(cpu_jax, monkeypatch, share,
                                            extended):
    """The port's label set equals tpufd's, multi-device labels aside,
    with and without rated context (degraded or not) and the DMA probe."""
    from tpufd import health as ref

    stub_probes(monkeypatch, ref, share, "v5e",
                (ref.RATED_MATMUL_TFLOPS, ref.RATED_HBM_GBPS))
    monkeypatch.setattr(ref, "allreduce_gbps", lambda mesh, mib: 1.0)
    want = leaves(ref.health_labels(extended=extended))
    want -= set(MULTI_DEVICE_LEAVES)
    stub_probes(monkeypatch, health, share, "h100-sxm",
                (health.RATED_MATMUL_TFLOPS, health.RATED_HBM_GBPS))
    got = leaves(health.health_labels(extended=extended, device="cpu"))
    assert got == want
    assert ("matmul-tflops-degraded" in got) == (share < 0.5)


def test_health_labels_real_probes_on_cpu(cpu_jax, monkeypatch):
    """Unstubbed: every probe runs (the DMA copy through its plain
    version) and the key set equals tpufd's at one device."""
    from tpufd import health as ref

    monkeypatch.setattr(ref, "matmul_tflops", lambda **kw: 1.0)
    monkeypatch.setattr(ref, "hbm_gbps", lambda **kw: 1.0)
    monkeypatch.setattr(ref, "dma_copy_gbps", lambda **kw: 1.0)
    monkeypatch.setattr(ref, "allreduce_gbps", lambda mesh, mib: 1.0)
    want = leaves(ref.health_labels(extended=True)) - set(MULTI_DEVICE_LEAVES)

    labels = health.health_labels(extended=True, device="cpu")
    assert leaves(labels) == want
    assert labels[PREFIX + "ok"] == "true"
    for leaf in ("matmul-tflops", "hbm-gbps", "dma-copy-gbps"):
        assert float(labels[PREFIX + leaf]) > 0
    assert not any(k.endswith("-rated") for k in labels)  # CPU: unrated


@pytest.mark.parametrize("count, consistent, devices_label", [
    ("1", "true", None),
    ("4", "false", "1"),
    ("bogus", None, None),
    ("", None, None),
])
def test_chip_count_cross_check(monkeypatch, count, consistent,
                                devices_label):
    """TFD_CHIP_COUNT (exported by the daemon around the exec): match ->
    consistent only; mismatch -> false plus this process's count, ok
    untouched; garbage -> no labels."""
    stub_probes(monkeypatch, health, 1.0, None, (None, None))
    monkeypatch.setenv("TFD_CHIP_COUNT", count)
    labels = health.health_labels(device="cpu")
    assert labels[PREFIX + "ok"] == "true"
    assert labels.get(PREFIX + "devices-consistent") == consistent
    assert labels.get(PREFIX + "devices-jax") == devices_label


def test_extended_probe_failure_keeps_ok(monkeypatch, capsys):
    """A failing DMA-copy probe is an opt-in diagnostic: stderr note,
    no label, ok stays true."""
    stub_probes(monkeypatch, health, 1.0, None, (None, None))

    def boom(**kwargs):
        raise RuntimeError("kernel build failed")

    monkeypatch.setattr(health, "dma_copy_gbps", boom)
    labels = health.health_labels(extended=True, device="cpu")
    assert labels[PREFIX + "ok"] == "true"
    assert PREFIX + "dma-copy-gbps" not in labels
    assert "dma-copy probe skipped: kernel build failed" in (
        capsys.readouterr().err)


def test_core_probe_failure_sets_ok_false(monkeypatch):
    stub_probes(monkeypatch, health, 1.0, None, (None, None))
    monkeypatch.setenv("TPUFD_PROBE_RETRIES", "0")

    def boom(**kwargs):
        raise RuntimeError("unmeasurable")

    monkeypatch.setattr(health, "hbm_gbps", boom)
    labels = health.health_labels(device="cpu")
    assert labels == {PREFIX + "matmul-tflops": "42", PREFIX + "ok": "false"}


def test_custom_prefix(monkeypatch):
    stub_probes(monkeypatch, health, 1.0, None, (None, None))
    labels = health.health_labels(prefix="x.", device="cpu")
    assert set(labels) == {"x.matmul-tflops", "x.hbm-gbps", "x.ok"}


# ---- probe scheduling and metrics, against tpufd's twins -------------------

def test_backoff_with_jitter_matches_jax_grid():
    from tpufd import sched as ref

    for failures in (0, 1, 2, 5, 31, 40):
        for initial in (0, 1, 3):
            for cap in (0, 2, 60):
                for unit in (-1.0, 0.0, 0.5, 1.0, 2.0):
                    args = (failures, initial, cap, unit)
                    assert (sched.backoff_with_jitter(*args)
                            == ref.backoff_with_jitter(*args)), args


@pytest.mark.parametrize("fail_times, budget", [(0, 1), (1, 1), (2, 3),
                                                (3, 2), (5, 0)])
def test_probe_scheduler_matches_jax(fail_times, budget):
    """Same retries, sleeps, result or raise, and the same exposition
    text from the two registries."""
    from tpufd import metrics as ref_metrics, sched as ref

    outcomes = []
    for sched_mod, registry in ((ref, ref_metrics.Registry()),
                                (sched, metrics.Registry())):
        sleeps, calls = [], []

        def probe():
            calls.append(1)
            if len(calls) <= fail_times:
                raise RuntimeError("transient")
            return 7

        scheduler = sched_mod.ProbeScheduler(
            registry=registry, retry_budget=budget, sleep=sleeps.append)
        try:
            result = scheduler.run("p", probe)
        except RuntimeError:
            result = "raised"
        outcomes.append((result, sleeps, len(calls), registry.render()))
    assert outcomes[0] == outcomes[1]


def test_metrics_render_matches_jax_and_validates():
    from tpufd import metrics as ref

    texts = []
    for module in (ref, metrics):
        reg = module.Registry()
        reg.counter("c_total", "help \\ text\n", labels={"a": 'q"v'}).inc(2)
        reg.gauge("g", "gauge").set(1.5)
        h = reg.histogram("h", "hist", labels={"le": "x"}, buckets=(0.1, 1))
        for v in (0.05, 0.5, 5.0, float("nan")):
            h.observe(v)
        reg.counter("h_bucket", "collides with h's samples").inc()
        texts.append(reg.render())
    assert texts[0] == texts[1]
    ref.validate_exposition(texts[1])
