"""The port's virtual-clock simulation primitives against the
reference's: `tpufd_torch.fakes.simnet` against `tpufd.fakes.simnet`.
One small seeded watch-mode run (SimApiServer and SimDaemons on a
SimClock, through joins, foreign drift, deletes, a partition, a dropped
watch fleet and a throttled re-establishment storm) and one small
aggregator run (AggSimServer and SimAggregator through sync, churn and
deletes) must reach the same outcome, event for event; so must
`percentile` and the clock itself."""

import random

import numpy as np
import pytest

from tpufd.fakes import simnet as ref
from tpufd_torch.fakes import simnet


def test_percentile_and_constants_equal():
    rng = np.random.default_rng(2800)
    for _ in range(300):
        values = [float(v) for v in rng.uniform(0, 1000,
                                                int(rng.integers(0, 40)))]
        pct = float(rng.choice([0, 1, 50, 90, 99, 99.9, 100,
                                rng.uniform(0, 100)]))
        assert simnet.percentile(values, pct) == ref.percentile(values, pct)
    assert simnet.BASE_LABELS == ref.BASE_LABELS


def test_clock_orders_alike():
    trails = []
    for module in (simnet, ref):
        clock, trail = module.SimClock(), []
        rng = random.Random(3)
        for i in range(200):
            t = rng.uniform(0, 50)
            clock.schedule(t, lambda now, i=i: trail.append((i, now)))
        clock.schedule(10.0, lambda now: clock.schedule(
            now + 1.0, lambda later: trail.append(("chained", later))))
        clock.run(25.0)
        trail.append(("now", clock.now))
        clock.run(60.0)
        trails.append(trail)
    assert trails[0] == trails[1]


def watch_run(module, seed, nodes=24):
    clock = module.SimClock()
    rng = random.Random(seed)
    server = module.SimApiServer(clock, shards=3, rng=rng)
    daemons = [module.SimDaemon(server, clock, i, seed)
               for i in range(nodes)]
    for i, daemon in enumerate(daemons):
        clock.schedule(0.01 * i, daemon.join)
    clock.run(2.0)
    for i in range(0, nodes, 3):  # foreign drift the daemons must heal
        name = daemons[i].name
        clock.schedule(2.0 + 0.05 * i, lambda now, n=name: server.edit(
            now, n, "google.com/tpu.count", "0"))
    clock.schedule(3.0, lambda now: server.delete(now, daemons[1].name))
    server.partitioned.add(daemons[2].name)
    clock.schedule(3.5, lambda now: server.edit(
        now, daemons[2].name, "google.com/tpu.count", "9"))
    clock.run(5.0)
    server.partitioned.clear()
    # Drop every watch at once; re-establishment is paced by the server.
    server.watch_capacity = 4
    for daemon in server.drop_all_watches(5.0):
        daemon.drop(5.0)
    clock.run(30.0)
    return {
        "objects": server.objects, "buckets": dict(server.buckets),
        "by_verb": dict(server.by_verb),
        "watch_buckets": dict(server.watch_buckets),
        "watchers": sorted(server.watchers),
        "daemons": [(d.name, d.passes, d.connected, d.reconnect_failures,
                     d.heal_latencies_ms, d.reconnected_at,
                     d.breaker.state, d.breaker.transitions)
                    for d in daemons],
        "now": clock.now,
    }


@pytest.mark.parametrize("seed", range(3))
def test_watch_mode_run_equal(seed):
    got, want = watch_run(simnet, seed), watch_run(ref, seed)
    assert got == want
    assert any(d[4] for d in got["daemons"]), "no drift was healed"
    assert got["by_verb"]["WATCH"] > 24, "the storm re-established nothing"


def agg_run(module, seed, nodes=30):
    clock = module.SimClock()
    rng = random.Random(seed)
    nprng = np.random.default_rng(seed)
    server = module.AggSimServer(clock, rng)
    aggregator = module.SimAggregator(server, clock, debounce_s=1.0,
                                      lease_s=6.0)

    def labels(i):
        out = dict(module.BASE_LABELS)
        out["google.com/tpu.perf.class"] = str(nprng.choice(
            ["gold", "silver", "degraded"]))
        out["google.com/tpu.perf.matmul-tflops"] = "%.3f" % float(
            nprng.uniform(100, 900))
        out["google.com/tpu.slice.id"] = f"slice-{i // 4}"
        return out

    for i in range(nodes):
        server.daemon_apply(0.0, f"node-{i}", labels(i))
    aggregator.start(0.0)
    clock.schedule(0.5, aggregator.sync)
    for step in range(60):
        t = 1.0 + 0.37 * step
        i = int(nprng.integers(nodes + 4))
        if nprng.random() < 0.15:
            clock.schedule(t, lambda now, n=f"node-{i}":
                           server.daemon_delete(now, n))
        else:
            clock.schedule(t, lambda now, n=f"node-{i}", lb=labels(i):
                           server.daemon_apply(now, n, lb))
    clock.run(40.0)
    return {"writes": server.output_writes,
            "requests": dict(server.agg_requests),
            "by_verb": dict(server.by_verb), "objects": server.objects,
            "latencies": aggregator.publish_latencies_ms,
            "synced": aggregator.synced,
            "labels": aggregator.store.build_output_labels(),
            "recomputes": aggregator.store.full_recomputes}


@pytest.mark.parametrize("seed", range(3))
def test_aggregator_run_equal(seed):
    got, want = agg_run(simnet, seed), agg_run(ref, seed)
    assert got == want
    assert got["writes"] and got["latencies"] and got["recomputes"] == 0
