"""Measurement half of ``tpufd/perfmodel.py`` on the GPU.

``python -m tpufd_torch perfmodel`` runs the matmul and HBM probes of
``tpufd_torch.health`` (median of 3 differential runs) and prints bare
measurement lines

    matmul-tflops=<float>
    hbm-gbps=<float>

which the daemon's ``--perf-exec`` consumes (``src/tfd/perf/perf.cc``
accepts nothing else). Classification stays in the daemon. The ICI
all-reduce measurement (``ici-gbps=``) is not ported yet: with several
cards visible it is left out and a note goes to stderr.

Quarantined cards are excluded: the daemon exports
TFD_PERF_EXCLUDE_CHIPS=<id,id,...>, matched here against CUDA ordinals.
"""

import json
import os
import sys
from pathlib import Path

import torch


def load_rated_specs(path=None):
    """The checked-in per-SKU rated peaks (tpufd_torch/rated_specs.json) as
    {family: {"matmul_tflops": float, "hbm_gbps": float}}."""
    if path is None:
        path = Path(__file__).resolve().parent / "rated_specs.json"
    with open(path) as f:
        doc = json.load(f)
    families = doc.get("families")
    if not isinstance(families, dict) or not families:
        raise ValueError(f"{path} has no 'families' object")
    out = {}
    for family, spec in families.items():
        matmul = float(spec["matmul_tflops"])
        hbm = float(spec["hbm_gbps"])
        if matmul <= 0 or hbm <= 0:
            raise ValueError(f"rated spec for {family} must be positive")
        out[family] = {"matmul_tflops": matmul, "hbm_gbps": hbm}
    return out


def excluded_chip_ids(env=None):
    """Chip ids named by TFD_PERF_EXCLUDE_CHIPS (the daemon's
    healthsm-quarantined set), as a set of strings."""
    env = os.environ if env is None else env
    raw = env.get("TFD_PERF_EXCLUDE_CHIPS", "")
    return {part.strip() for part in raw.split(",") if part.strip()}


def measurement_devices(devices, excluded):
    """Every device whose CUDA ordinal is not quarantined; ALL devices
    when exclusion would leave none (an all-quarantined node still
    deserves a measurement, and its class will be degraded on merit)."""
    kept = [d for d in devices if str(d.index) not in excluded]
    return kept or list(devices)


def measure(excluded=None, device=None):
    """Runs the probes (median of 3) on the first non-excluded card and
    returns {"matmul-tflops": float, "hbm-gbps": float, "ici-gbps": None}.
    `device` picks the platform: every visible card for "cuda" (the
    default; raises without one), the host for "cpu"."""
    from tpufd_torch import health

    device = health.resolve_device(device)
    if device.type == "cuda":
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    else:
        devices = [device]
    excluded = excluded_chip_ids() if excluded is None else excluded
    usable = measurement_devices(devices, excluded)
    device = usable[0]
    on_card = device.type == "cuda"
    size = 4096 if on_card else 512
    mib = 512 if on_card else 32
    out = {
        "matmul-tflops": health.median_probe(
            lambda: health.matmul_tflops(device=device, size=size)),
        "hbm-gbps": health.median_probe(
            lambda: health.hbm_gbps(device=device, mib=mib)),
        "ici-gbps": None,
    }
    if len(usable) > 1:
        sys.stderr.write(f"ici probe not measured: {len(usable)} cards "
                         f"visible, the multi-card probe is not ported\n")
    return out


def main(device=None):
    measured = measure(device=device)
    for key in ("matmul-tflops", "hbm-gbps", "ici-gbps"):
        value = measured.get(key)
        if value is not None:
            print(f"{key}={value:.3f}")
    return 0
