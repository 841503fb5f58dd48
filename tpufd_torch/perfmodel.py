"""The port of ``tpufd/perfmodel.py``: the perf class model, and its
measurement half on the GPU.

The model is the daemon's classification (src/tfd/perf/perf.cc), copied
from the reference's twin: the class names and ranks, the thresholds,
:func:`pct_of_rated`, :func:`classify` with its hysteresis, the fleet
floor (:func:`parse_fleet_floor`, :func:`apply_fleet_floor`) and
:func:`expected_labels`, the five labels the daemon publishes for a
measurement. The tests hold each against the reference and against the
real daemon.

``python -m tpufd_torch perfmodel`` runs the matmul and HBM probes of
``tpufd_torch.health`` (median of 3 differential runs) and prints bare
measurement lines

    matmul-tflops=<float>
    hbm-gbps=<float>

which the daemon's ``--perf-exec`` consumes (``src/tfd/perf/perf.cc``
accepts nothing else), and with several usable cards

    ici-gbps=<float>

the all-reduce probe of ``tpufd_torch.health`` over them, one rank per
card. The command prints no class: the daemon classifies, so the exec
can never publish a class the daemon would not.

Quarantined cards are excluded: the daemon exports
TFD_PERF_EXCLUDE_CHIPS=<id,id,...>, matched here against CUDA ordinals.
"""

import json
import os
import sys
from pathlib import Path

import torch

# Class names and ranks (larger = worse), mirroring perf.h.
CLASS_GOLD = "gold"
CLASS_SILVER = "silver"
CLASS_DEGRADED = "degraded"
_RANKS = {CLASS_GOLD: 0, CLASS_SILVER: 1, CLASS_DEGRADED: 2}
_NAMES = {rank: name for name, rank in _RANKS.items()}

# Thresholds in percent of rated, mirroring perf.h (kGoldMatmulPct /
# kGoldHbmPct / kDegradedPct / kHysteresisPct), which perf.cc's
# ClassifyPct applies. The daemon has one set for every family.
GOLD_MATMUL_PCT = 90.0
GOLD_HBM_PCT = 70.0
DEGRADED_PCT = 50.0
HYSTERESIS_PCT = 3.0


def class_rank(name):
    """Rank of a class name (gold=0, silver=1, degraded=2); None for
    unknown names."""
    return _RANKS.get(name)


def rank_name(rank):
    return _NAMES.get(rank, CLASS_SILVER)


def pct_of_rated(measured, rated):
    """measured/rated*100, or None when unmeasured/unrated: the twin of
    perf::PctOfRated (which uses -1 for the same sentinel)."""
    if rated is None or rated <= 0 or measured is None or measured < 0:
        return None
    return 100.0 * measured / rated


def _raw_class(matmul_pct, hbm_pct):
    if matmul_pct is not None and matmul_pct < DEGRADED_PCT:
        return _RANKS[CLASS_DEGRADED]
    if hbm_pct is not None and hbm_pct < DEGRADED_PCT:
        return _RANKS[CLASS_DEGRADED]
    if (matmul_pct is not None and matmul_pct >= GOLD_MATMUL_PCT
            and (hbm_pct is None or hbm_pct >= GOLD_HBM_PCT)):
        return _RANKS[CLASS_GOLD]
    return _RANKS[CLASS_SILVER]


def classify(matmul_pct, hbm_pct, prev=None):
    """Class name for the measured percentages (None = unknown),
    mirroring perf::ClassifyPct with its hysteresis margin: to leave
    `prev`, the margin-shifted reading must still cross the boundary in
    the same direction, so a card sitting on a threshold keeps its
    class."""
    rank = _raw_class(matmul_pct, hbm_pct)
    prev_rank = _RANKS.get(prev) if prev else None
    if prev_rank is None or rank == prev_rank:
        return _NAMES[rank]
    toward = HYSTERESIS_PCT if rank > prev_rank else -HYSTERESIS_PCT
    confirmed = _raw_class(
        None if matmul_pct is None else matmul_pct + toward,
        None if hbm_pct is None else hbm_pct + toward)
    still_crosses = (confirmed > prev_rank if rank > prev_rank
                     else confirmed < prev_rank)
    return _NAMES[rank] if still_crosses else _NAMES[prev_rank]


def parse_fleet_floor(text):
    """Twin of perf::ParseFleetFloor: the --perf-fleet-floor-source
    document ({"matmul_p10_tflops": N, "hbm_p10_gbps": N}, either key
    optional). Returns {matmul_p10_tflops, hbm_p10_gbps} with None for
    an absent floor; raises ValueError on garbage."""
    doc = json.loads(text)
    if not isinstance(doc, dict):
        raise ValueError("fleet floor: not a JSON object")
    floor = {"matmul_p10_tflops": None, "hbm_p10_gbps": None}
    for key in floor:
        value = doc.get(key)
        if isinstance(value, (int, float)) and value >= 0:
            floor[key] = float(value)
    return floor


def apply_fleet_floor(class_name, matmul_tflops, hbm_gbps, floor):
    """Twin of perf::ApplyFleetFloor: a measured value below either
    fleet p10 floor demotes the class to degraded; unmeasured values and
    unset floors never trigger."""
    matmul_floor = floor.get("matmul_p10_tflops")
    hbm_floor = floor.get("hbm_p10_gbps")
    if (matmul_floor is not None and matmul_tflops is not None
            and matmul_tflops >= 0 and matmul_tflops < matmul_floor):
        return CLASS_DEGRADED
    if (hbm_floor is not None and hbm_gbps is not None
            and hbm_gbps >= 0 and hbm_gbps < hbm_floor):
        return CLASS_DEGRADED
    return class_name


def expected_labels(matmul_tflops, hbm_gbps, ici_gbps, family,
                    class_name, specs=None,
                    prefix="google.com/tpu.perf."):
    """The labels the daemon publishes for these measurements (value
    formatting mirrors perf::BuildLabels); `specs` defaults to
    :func:`load_rated_specs`."""
    def fmt(v):
        return str(int(v)) if v >= 10 else f"{v:.2g}"

    specs = specs if specs is not None else load_rated_specs()
    labels = {}
    if matmul_tflops is not None and matmul_tflops >= 0:
        labels[prefix + "matmul-tflops"] = fmt(matmul_tflops)
    if hbm_gbps is not None and hbm_gbps >= 0:
        labels[prefix + "hbm-gbps"] = fmt(hbm_gbps)
    if ici_gbps is not None and ici_gbps >= 0:
        labels[prefix + "ici-gbps"] = fmt(ici_gbps)
    rated = specs.get(family, {}).get("matmul_tflops") if family else None
    pct = pct_of_rated(matmul_tflops, rated)
    if pct is not None:
        labels[prefix + "pct-of-rated"] = str(int(pct + 0.5))
    labels[prefix + "class"] = class_name
    return labels


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
    """Runs the probes (median of 3) on the first non-excluded card, plus
    the all-reduce over all non-excluded cards when there are several,
    and returns {"matmul-tflops": float, "hbm-gbps": float, "ici-gbps":
    float|None}. `device` picks the platform: every visible card for
    "cuda" (the default; raises without one), the host for "cpu"."""
    from tpufd_torch import health, launch

    device = health.resolve_device(device)
    if device.type == "cuda":
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    else:
        devices = [device]
    excluded = excluded_chip_ids() if excluded is None else excluded
    usable = measurement_devices(devices, excluded)
    device = usable[0]
    size, mib, allreduce_mib = health.probe_sizes(device)
    out = {
        "matmul-tflops": health.median_probe(
            lambda: health.matmul_tflops(device=device, size=size)),
        "hbm-gbps": health.median_probe(
            lambda: health.hbm_gbps(device=device, mib=mib)),
        "ici-gbps": None,
    }
    if len(usable) > 1:
        try:
            out["ici-gbps"] = launch.spawn_ranks(
                health._allreduce_rank, len(usable), device.type,
                args=(device.type, allreduce_mib),
                cards=[d.index for d in usable])
        except Exception as e:  # noqa: BLE001 — optional context; it must
            # not fail the matmul/HBM characterization it rides along with.
            sys.stderr.write(f"ici probe skipped: {e}\n")
    return out


def main(device=None):
    measured = measure(device=device)
    for key in ("matmul-tflops", "hbm-gbps", "ici-gbps"):
        value = measured.get(key)
        if value is not None:
            print(f"{key}={value:.3f}")
    return 0
