"""The port's aggregator twin against the reference's: `tpufd_torch.agg`
against `tpufd.agg` on inputs drawn from a numpy seed, with exact
equality. The sketch's bucket index and value, bit for bit, on 10^4
doubles across its range and on every bucket edge; sketch quantiles
after adds, removes, merges and unmerges; the inventory store and the
shard-merge store fed the same event stream, their output labels equal
after every event; the partial, sketch and stage-sketch serializations
and their tolerant parsers; the burn evaluator; the flush controller."""

import math

import numpy as np
import pytest

from tpufd import agg as ref
from tpufd_torch import agg

CLASSES = ("gold", "silver", "degraded", "bronze", "")
STAGES = ref.SLO_STAGES + ("govern", "bogus")


def sketch_state(sketch):
    return (sketch.total, list(sketch.counts))


def state_of(value):
    """A rollup state (or any nesting of its parts) with each Sketch
    replaced by its (total, counts): comparable across packages."""
    if isinstance(value, (agg.Sketch, ref.Sketch)):
        return sketch_state(value)
    if isinstance(value, dict):
        return {k: state_of(v) for k, v in value.items()}
    if isinstance(value, list):
        return [state_of(v) for v in value]
    return value


def test_constants_equal():
    names = [n for n in dir(ref) if n.isupper()]
    assert names and set(names) == {n for n in dir(agg) if n.isupper()}
    for name in names:
        assert getattr(agg, name) == getattr(ref, name), name


def sketch_inputs(seed, n=10000):
    """Doubles across the sketch's range and beyond it (below its first
    edge, above its last), each bucket edge and its neighbours, and the
    values that are not ordinary numbers."""
    rng = np.random.default_rng(700 + seed)
    exponents = rng.uniform(-8, ref.SKETCH_BUCKETS + 8, n)
    values = [float(ref.SKETCH_MIN * ref.SKETCH_GAMMA ** e)
              for e in exponents]
    for bucket in range(ref.SKETCH_BUCKETS + 1):
        edge = ref.sketch_bucket_value(bucket)
        values += [edge, math.nextafter(edge, 0), math.nextafter(edge, 1e9)]
    return values + [0.0, -1.0, -0.0, float("nan"), float("inf"),
                     -float("inf"), 1e308, 5e-324, None]


@pytest.mark.parametrize("seed", range(2))
def test_sketch_buckets_bit_equal(seed):
    for value in sketch_inputs(seed):
        assert agg.sketch_bucket_index(value) == ref.sketch_bucket_index(
            value), value
    for bucket in range(-2, ref.SKETCH_BUCKETS + 3):
        assert (agg.sketch_bucket_value(bucket).hex()
                == ref.sketch_bucket_value(bucket).hex()), bucket


@pytest.mark.parametrize("seed", range(3))
def test_sketch_operations_equal(seed):
    rng = np.random.default_rng(800 + seed)
    values = [v for v in sketch_inputs(seed, 600) if v is not None]
    port, want = agg.Sketch(), ref.Sketch()
    other_port, other_want = agg.Sketch(), ref.Sketch()
    for _ in range(1500):
        op = int(rng.integers(7))
        v = values[int(rng.integers(len(values)))]
        if op in (0, 1):
            port.add(v)
            want.add(v)
        elif op == 2:
            port.remove(v)
            want.remove(v)
        elif op == 3:
            other_port.add(v)
            other_want.add(v)
        elif op == 4:
            port.merge(other_port)
            want.merge(other_want)
        elif op == 5:
            port.unmerge(other_port)
            want.unmerge(other_want)
        else:
            bucket = int(rng.integers(-3, ref.SKETCH_BUCKETS + 3))
            n = int(rng.integers(-2, 5))
            port.add_bucket_count(bucket, n)
            want.add_bucket_count(bucket, n)
        assert sketch_state(port) == sketch_state(want)
        q = float(rng.choice([0.0, 0.1, 0.5, 0.99, 1.0, -1.0, 2.0,
                              rng.uniform()]))
        assert port.quantile(q) == want.quantile(q)
        threshold = float(rng.uniform(0, 2000))
        assert port.fraction_above(threshold) == want.fraction_above(
            threshold)
        assert (port == agg.Sketch()) == (want == ref.Sketch())
        assert (agg.serialize_sketch(port) == ref.serialize_sketch(want))


def labels_for(rng, node):
    labels = {}
    if rng.random() < 0.9:
        labels[ref.TPU_COUNT] = str(rng.choice(["4", "8", "16", "x", ""]))
    if rng.random() < 0.9:
        labels[ref.PERF_CLASS] = str(rng.choice(CLASSES))
    if rng.random() < 0.8:
        labels[ref.PERF_MATMUL] = ref.fixed3(float(rng.uniform(50, 1000)))
        labels[ref.PERF_HBM] = str(rng.choice(
            [ref.fixed3(float(rng.uniform(100, 4000))), "junk", ""]))
    if rng.random() < 0.7:
        labels[ref.SLICE_ID] = f"slice-{int(rng.integers(6))}"
        labels[ref.SLICE_DEGRADED] = str(rng.choice(["true", "false"]))
    if rng.random() < 0.3:
        labels[ref.MULTISLICE_SLICE_ID] = f"ms-{int(rng.integers(3))}"
    if rng.random() < 0.15:
        labels[ref.LIFECYCLE_PREEMPT] = "true"
    if rng.random() < 0.1:
        labels[ref.LIFECYCLE_DRAINING] = "true"
    labels["google.com/tfd.node"] = node
    return labels


def stage_slo(rng):
    if rng.random() < 0.4:
        return ""
    stages = {}
    for name in ref.SLO_STAGES:
        if rng.random() < 0.6:
            sketch = ref.Sketch()
            for v in rng.uniform(0, 3000, int(rng.integers(1, 6))):
                sketch.add(float(v))
            stages[name] = sketch
    text = ref.serialize_stage_sketches(stages)
    if rng.random() < 0.2:
        text += ";bogus=1:2;plan=x:1,3:"
    return text


def events(seed, n=250, nodes=24):
    rng = np.random.default_rng(900 + seed)
    for _ in range(n):
        node = f"node-{int(rng.integers(nodes))}"
        if rng.random() < 0.12:
            yield node, None, ""
        else:
            yield node, labels_for(rng, node), stage_slo(rng)


@pytest.mark.parametrize("seed", range(4))
def test_inventory_store_equal_after_every_event(seed):
    port, want = agg.InventoryStore(), ref.InventoryStore()
    for node, labels, slo in events(seed):
        if labels is None:
            assert port.remove(node) == want.remove(node)
        else:
            assert (agg.extract_contribution(labels, slo)
                    == ref.extract_contribution(labels, slo))
            assert port.apply(node, labels, slo) == want.apply(
                node, labels, slo)
        assert port.build_output_labels() == want.build_output_labels()
        assert state_of(port.partial()) == state_of(want.partial())
    port.recompute_all()
    want.recompute_all()
    assert port.build_output_labels() == want.build_output_labels()
    assert (port.events, port.full_recomputes) == (want.events,
                                                   want.full_recomputes)


def shard_partials(seed, shards=3):
    """Seeded events spread over `shards` shard stores by shard_index_of;
    yields (shard, serialized partial labels) after each event."""
    stores = [ref.InventoryStore() for _ in range(shards)]
    for node, labels, slo in events(seed, 150):
        shard = ref.shard_index_of(node, shards)
        if labels is None:
            stores[shard].remove(node)
        else:
            stores[shard].apply(node, labels, slo)
        yield shard, ref.serialize_partial_labels(
            stores[shard].partial(), f"{shard}/{shards}")


@pytest.mark.parametrize("seed", range(3))
def test_shard_merge_store_equal_after_every_partial(seed):
    port, want = agg.ShardMergeStore(), ref.ShardMergeStore()
    rng = np.random.default_rng(1000 + seed)
    for shard, labels in shard_partials(seed):
        p, w = agg.parse_partial_labels(labels), ref.parse_partial_labels(
            labels)
        assert state_of(p) == state_of(w)
        assert agg.serialize_partial_labels(p, labels[ref.AGG_SHARD]) == (
            ref.serialize_partial_labels(w, labels[ref.AGG_SHARD]))
        if rng.random() < 0.1:
            assert port.remove_partial(shard) == want.remove_partial(shard)
        else:
            assert port.apply_partial(shard, p) == want.apply_partial(
                shard, w)
        assert port.build_output_labels() == want.build_output_labels()
        assert state_of(port.stage_sketches) == state_of(
            want.stage_sketches)
    port.recompute_all()
    want.recompute_all()
    assert port.build_output_labels() == want.build_output_labels()
    assert port.full_recomputes == want.full_recomputes == 1


def test_partial_and_stage_parsers_tolerate_the_same_junk():
    for labels in ({}, {ref.AGG_TIER: "root"},
                   {ref.AGG_TIER: "partial", ref.AGG_NODES: "x",
                    ref.AGG_SLICES: "a:1:0:0,:1:1:1,b:1:x:0,c:1:0",
                    ref.AGG_CAPACITY: "gold:4,silver:,:3,bad",
                    ref.AGG_MULTISLICE: "m:2", ref.AGG_MATMUL: "3:2,x:1,",
                    ref.AGG_HBM: "", ref.AGG_STAGE_SLO: "plan=1:1;x=2:2"}):
        assert state_of(agg.parse_partial_labels(labels)) == state_of(
            ref.parse_partial_labels(labels))
    for text in ("", ";", "plan=", "plan=0:3,5:2;publish=17:1",
                 "render=1:1;render=2:2", "plan=-1:2,999:1,3:0,4:x"):
        assert state_of(agg.parse_stage_sketches(text)) == state_of(
            ref.parse_stage_sketches(text))
        assert sketch_state(agg.parse_sketch(text[5:])) == sketch_state(
            ref.parse_sketch(text[5:]))
    for spec in ("", "plan=5", "plan=0,render=-3,publish=x,bogus=9",
                 "publish-acked=1500,plan=7,=4"):
        assert (agg.slo_budgets_ms_from_spec(spec)
                == ref.slo_budgets_ms_from_spec(spec))


@pytest.mark.parametrize("seed", range(3))
def test_burn_evaluator_edges_equal(seed):
    rng = np.random.default_rng(1100 + seed)
    budgets = ref.slo_budgets_ms_from_spec("publish=100,plan=500")
    port = agg.BurnEvaluator(budgets, fast_window_s=30, slow_window_s=120)
    want = ref.BurnEvaluator(budgets, fast_window_s=30, slow_window_s=120)
    now = 0.0
    for _ in range(300):
        now += float(rng.choice([1.0, 5.0, 20.0]))
        stages_port, stages_want = {}, {}
        for stage in ref.SLO_STAGES:
            if rng.random() < 0.7:
                values = rng.uniform(0, 2000, int(rng.integers(1, 8)))
                stages_port[stage], stages_want[stage] = (
                    agg.Sketch(), ref.Sketch())
                for v in values:
                    stages_port[stage].add(float(v))
                    stages_want[stage].add(float(v))
        assert port.note(now, stages_port) == want.note(now, stages_want)
        assert port.burning_stages() == want.burning_stages()
        assert port.samples == want.samples


@pytest.mark.parametrize("seed", range(2))
def test_flush_controller_steps_alike(seed):
    rng = np.random.default_rng(1200 + seed)
    port, want = agg.FlushController(2.0), ref.FlushController(2.0)
    now = 0.0
    for _ in range(400):
        now += float(rng.uniform(0, 1.5))
        op = int(rng.integers(4))
        if op == 0:
            port.note_dirty(now)
            want.note_dirty(now)
        elif op == 1 and port.should_flush(now):
            port.note_flushed()
            want.note_flushed()
        elif op == 2:
            since = now - float(rng.uniform(0, 3))
            port.rearm(since)
            want.rearm(since)
        assert (port.dirty, port.due_at(), port.should_flush(now)) == (
            want.dirty, want.due_at(), want.should_flush(now))


def test_names_shards_classes_and_formats_equal():
    rng = np.random.default_rng(1300)
    for i in range(500):
        node = f"node-{int(rng.integers(10 ** 6))}"
        shards = int(rng.integers(-1, 17))
        assert agg.shard_index_of(node, shards) == ref.shard_index_of(
            node, shards)
        name = str(rng.choice(["tfd-features-for-", "tfd-inventory-",
                               "tfd-inventory-shard-", "other-", ""])) + node
        output = str(rng.choice(["tfd-cluster-inventory", name]))
        assert agg.classify_name(name, output) == ref.classify_name(
            name, output)
        value = float(rng.uniform(-1e4, 1e4)) * 10 ** float(
            rng.integers(-5, 5))
        assert agg.fixed3(value) == ref.fixed3(value)
    for cls in CLASSES + ("unclassed", None):
        assert agg.capacity_bucket(cls) == ref.capacity_bucket(cls)
    assert state_of(agg.rollup_state()) == state_of(ref.rollup_state())
