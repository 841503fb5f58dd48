"""The port's slice-coherence twin against the reference's:
`tpufd_torch.slicecoord` against `tpufd.slicecoord`, each public
function on inputs drawn from a numpy seed, with exact equality (the
blackboard documents byte for byte)."""

import numpy as np
import pytest

from tpufd import slicecoord as ref
from tpufd_torch import slicecoord

CHARS = list("abcXYZ019-_. /:") + ["é", "\"", "\\", "\n", "\t", "\x01"]


def text(rng, longest=48):
    return "".join(CHARS[int(i)] for i in
                   rng.integers(0, len(CHARS), int(rng.integers(0, longest))))


@pytest.mark.parametrize("seed", range(3))
def test_ids_and_quoting_equal(seed):
    rng = np.random.default_rng(2100 + seed)
    for _ in range(400):
        raw = text(rng)
        assert slicecoord.sanitize_slice_id(raw) == ref.sanitize_slice_id(
            raw)
        assert slicecoord.json_quote(raw) == ref.json_quote(raw)
        bounds = ",".join(str(int(v)) for v in rng.integers(
            -1, 5, int(rng.integers(0, 4))))
        assert slicecoord._bounds_product(bounds) == ref._bounds_product(
            bounds)


def identity_inputs(rng):
    pick = lambda *options: options[int(rng.integers(len(options)))]  # noqa
    tpu_env = {k: v for k, v in {
        "WORKER_ID": pick("", "0", "3", "x", " 2 "),
        "HOST_BOUNDS": pick("", "1,1,1", "2,2,4", "2,x"),
        "CHIPS_PER_HOST_BOUNDS": pick("", "2,2,1", "0"),
        "ACCELERATOR_TYPE": pick("", "v5p-128", "v5litepod-16", "v4-8",
                                 "v6e-256", "weird"),
        "TPU_NAME": pick("", "my-tpu", "Pod_7"),
        "NODE_ID": pick("", "node-id-1"),
        "MEGASCALE_SLICE_ID": pick("", "0", "2"),
    }.items() if rng.random() < 0.7}
    env = {k: v for k, v in {
        "TFD_SLICE_WORKER_ID": pick("", "1", "7"),
        "TPU_WORKER_ID": pick("", "2"),
        "TFD_SLICE_HOSTS": pick("", "0", "4", "16"),
        "TFD_SLICE_ID": pick("", "forced-id"),
        "TPU_WORKER_HOSTNAMES": pick("", "h0,h1,h2,h3"),
        "MEGASCALE_SLICE_ID": pick("", "5"),
    }.items() if rng.random() < 0.4}
    family = pick(None, {"v5litepod": 8, "v5p": 4, "v4": 4, "v6e": 8})
    return tpu_env, pick("", "v5p-16", "v5litepod-8"), env, family


@pytest.mark.parametrize("seed", range(3))
def test_derive_slice_identity_equal(seed):
    rng = np.random.default_rng(2200 + seed)
    valid = 0
    for _ in range(600):
        args = identity_inputs(rng)
        got = slicecoord.derive_slice_identity(*args)
        assert got == ref.derive_slice_identity(*args), args
        valid += got["valid"]
    assert valid


def lease(rng):
    if rng.random() < 0.1:
        return {}
    return {"holder": str(rng.choice(["", "h0", "h1"])),
            "epoch": int(rng.integers(5)),
            "renewed_at": float(rng.uniform(0, 100)),
            "duration_s": int(rng.choice([-1, 0, 3, 15, 30]))}


def reports(rng, hosts):
    out = []
    for _ in range(int(rng.integers(0, hosts + 3))):
        report = {"host": f"h{int(rng.integers(hosts + 1))}",
                  "worker": int(rng.integers(-1, hosts)),
                  "healthy": bool(rng.random() < 0.8),
                  "preempting": bool(rng.random() < 0.1),
                  "shape": str(rng.choice(["", "2x2", "4x4x4"])),
                  "class": str(rng.choice(["", "gold", "silver",
                                           "degraded", "bronze"])),
                  "at": float(rng.choice([0.0, rng.uniform(0, 100)]))}
        if rng.random() < 0.3:
            report["addr"] = f"10.0.0.{int(rng.integers(255))}:8081"
        if rng.random() < 0.2:
            report["relayed_by"] = "h0"
        out.append(report)
    return out


@pytest.mark.parametrize("seed", range(3))
def test_leases_merges_and_documents_equal(seed):
    rng = np.random.default_rng(2300 + seed)
    for _ in range(500):
        now = float(rng.uniform(0, 130))
        held = lease(rng)
        cadence = int(rng.choice([0, 1, 5]))
        assert slicecoord.lease_expired(held, now) == ref.lease_expired(
            held, now)
        assert slicecoord.succession_due(held, now, cadence) == \
            ref.succession_due(held, now, cadence)
        duration = int(rng.integers(0, 40))
        assert slicecoord.renew_cadence(duration, cadence) == \
            ref.renew_cadence(duration, cadence)
        hosts = int(rng.integers(1, 6))
        rep = reports(rng, hosts)
        for report in rep:
            assert slicecoord.serialize_report(report) == \
                ref.serialize_report(report)
        departed = {f"h{i}": float(rng.uniform(0, 130))
                    for i in range(hosts) if rng.random() < 0.3}
        args = (hosts, rep, float(rng.choice([5.0, 30.0])), now, departed,
                float(rng.choice([0.0, 10.0])), str(rng.choice(["", "h0"])))
        verdict = slicecoord.merge_verdict(*args)
        assert verdict == ref.merge_verdict(*args)
        verdict.update(seq=int(rng.integers(9)), leader=args[-1],
                       computed_at=now,
                       change=int(rng.choice([0, 0, 17])))
        assert slicecoord.serialize_verdict(verdict) == \
            ref.serialize_verdict(verdict)
        assert slicecoord.verdict_change(verdict) == ref.verdict_change(
            verdict)
        sid = slicecoord.sanitize_slice_id(f"slice-{seed}")
        labels = slicecoord.build_slice_labels(sid, verdict)
        assert labels == ref.build_slice_labels(sid, verdict)
        labels["google.com/tpu.count"] = "4"
        assert slicecoord.slice_labels_of(labels) == ref.slice_labels_of(
            labels)
        successors = verdict["successors"]
        assert slicecoord.first_successor(successors, "h1", rep, 30.0,
                                          now) == \
            ref.first_successor(successors, "h1", rep, 30.0, now)
    for doc in ({}, {"change": "x"}, {"change": None}, None, {"change": 5}):
        assert slicecoord.verdict_change(doc) == ref.verdict_change(doc)


def test_constants_equal():
    for name in ("SLICE_KEYS", "CLASS_RANKS", "RANK_NAMES", "SLICE_ID",
                 "SLICE_CLASS"):
        assert getattr(slicecoord, name) == getattr(ref, name), name
