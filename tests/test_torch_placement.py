"""The port's placement index twin against the reference's:
`tpufd_torch.placement.PlacementIndex` against
`tpufd.placement.PlacementIndex` fed the same fleet, inventory and churn
drawn from a numpy seed. `query` (with and without `explain`) must give
equal answers over a grid of class floor, chips, slice scope and limit
after every batch of events; so must the eligibility helpers."""

import numpy as np
import pytest

from tpufd import placement as ref
from tpufd_torch import placement

QUERY_CLASSES = ("any", "silver", "gold")
CHIPS = (1, 4, 8, 16, 17, 200)
LIMITS = (1, 3, 64, 500, 0)


def random_labels(rng):
    labels = {}
    if rng.random() < 0.9:
        labels[ref.TPU_COUNT] = str(rng.choice(["4", "8", "16", "-4",
                                                "junk", ""]))
    if rng.random() < 0.85:
        labels[ref.PERF_CLASS] = str(rng.choice(
            ["gold", "silver", "degraded", "bronze", ""]))
    if rng.random() < 0.7:
        labels[ref.SLICE_ID] = f"s-{int(rng.integers(6))}"
        labels[ref.SLICE_DEGRADED] = str(rng.choice(
            ["true", "false", "false", "false"]))
        if rng.random() < 0.2:
            labels[ref.SLICE_CLASS] = str(rng.choice(["degraded", "gold"]))
    if rng.random() < 0.1:
        labels[ref.LIFECYCLE_PREEMPT] = "true"
    if rng.random() < 0.1:
        labels[ref.LIFECYCLE_DRAINING] = "true"
    return labels


def inventory(rng):
    if rng.random() < 0.25:
        return {}
    out = {ref.CAPACITY_PREFIX + b: str(int(rng.integers(0, 64)))
           for b in ("gold", "silver", "degraded", "unclassed")
           if rng.random() < 0.8}
    if rng.random() < 0.2:
        out[ref.CAPACITY_PREFIX + "gold"] = "many"
    out["google.com/tpu.fleet.nodes"] = "9"
    return out


def grid(port, want):
    statuses = set()
    for wanted in QUERY_CLASSES:
        for chips in CHIPS:
            for slice_scope in (False, True):
                for limit in LIMITS:
                    for explain in (False, True):
                        args = dict(wanted=wanted, chips=chips,
                                    slice=slice_scope, limit=limit,
                                    explain=explain)
                        got = port.query(**args)
                        assert got == want.query(**args), args
                        statuses.add(got["status"])
    return statuses


@pytest.mark.parametrize("seed", range(4))
def test_query_and_explain_grid_equal_through_churn(seed):
    rng = np.random.default_rng(1600 + seed)
    port, want = placement.PlacementIndex(), ref.PlacementIndex()
    nodes = [f"n{i:02d}" for i in range(int(rng.integers(8, 40)))]
    statuses = set()
    for batch in range(6):
        for _ in range(int(rng.integers(5, 25))):
            node = nodes[int(rng.integers(len(nodes)))]
            if rng.random() < 0.1:
                assert port.remove_node(node) == want.remove_node(node)
                continue
            labels = random_labels(rng)
            change = f"ch-{int(rng.integers(1000))}" if rng.random() < 0.7 \
                else ""
            assert port.apply_node(node, labels, change) == want.apply_node(
                node, labels, change)
        if rng.random() < 0.6:
            inv = inventory(rng)
            change = f"inv-{batch}" if rng.random() < 0.5 else ""
            port.apply_inventory(inv, change)
            want.apply_inventory(inv, change)
        assert port.eligible() == want.eligible()
        assert (port.nodes, port.by_rank, port.claims, port.blocked) == (
            want.nodes, want.by_rank, want.claims, want.blocked)
        for node in nodes:
            assert port.node_change(node) == want.node_change(node)
            assert port.node_basic_reason(node) == \
                want.node_basic_reason(node)
        statuses |= grid(port, want)
    assert port.events == want.events
    assert statuses == {"placed", "no-candidate", "no-capacity"}


def test_unknown_class_refused_alike():
    for index in (placement.PlacementIndex(), ref.PlacementIndex()):
        with pytest.raises(ValueError, match="unknown class 'bronze'"):
            index.query(wanted="bronze")


@pytest.mark.parametrize("seed", range(2))
def test_contract_helpers_equal(seed):
    rng = np.random.default_rng(1700 + seed)
    for _ in range(500):
        labels = random_labels(rng)
        for fn in ("basic_eligible", "slice_degraded_claim", "basic_reason",
                   "preempting", "_chips"):
            assert getattr(placement, fn)(labels) == getattr(ref, fn)(
                labels), fn
        cls = labels.get(ref.PERF_CLASS)
        assert placement.class_rank(cls) == ref.class_rank(cls)
    for wanted in QUERY_CLASSES + ("bronze", ""):
        assert placement.job_min_rank(wanted) == ref.job_min_rank(wanted)
    for name in ("CLASS_RANK", "JOB_CLASS_RANK", "MAX_LIMIT",
                 "REJECTION_REASONS", "MAX_EXPLAIN_REJECTIONS",
                 "MAX_EXPLAIN_CHANGE_IDS", "SLICE_CLASS", "CAPACITY_PREFIX"):
        assert getattr(placement, name) == getattr(ref, name), name
