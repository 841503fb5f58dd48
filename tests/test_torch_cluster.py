"""The port's cluster-in-a-box twin against the reference's:
`tpufd_torch.cluster` against `tpufd.cluster`. The failure-schedule
grammar parses the same schedules into the same events and domains and
refuses the same bad lines with the same messages; one seeded
`SimScheduler` run per seed, driven by a parsed schedule (each event
turned into the label writes a daemon would publish) and a seeded job
stream, makes the same decisions, explanations, evictions and audit
ring; the change tracker and stage breakdown agree; so do the
eligibility helpers."""

import numpy as np
import pytest

from tpufd import agg as ref_agg
from tpufd import cluster as ref
from tpufd.fakes import simnet as ref_simnet
from tpufd_torch import agg
from tpufd_torch import cluster
from tpufd_torch.fakes import simnet

SCHEDULE = """
# a small storm over three slices of four hosts
domain rack-a hosts=s00/h00,s01/h02,s02/h01
domain rack-b hosts=s02/h03
5   degrade        s00/h01
8   preempt        s01/h03
9   wedge          s02/h02   # a comment
12  partition      s01       hosts=0-1
14  brownout       apiserver secs=3
15  heal           s00/h01
18  leader-kill    s02
20  domain-fail    rack-a
22  preempt-clear  s01/h03
24  asym-partition s00/h02
25  heal-partition s01
27  unwedge        s02/h02
28  slowdown       apiserver secs=2 delay=0.5
30  leader-restart s02
31  domain-heal    rack-a
33  asym-heal      s00/h02
34  domain-fail    rack-b
36  degrade        s01/h00
40  domain-heal    rack-b
"""

BAD = [
    "5 degrade",
    "x degrade s00/h00",
    "5 degrade s00",
    "5 leader-kill s00/h00",
    "5 brownout s00",
    "5 domain-fail rack-z",
    "5 explode s00/h00",
    "5 degrade s00/h00 junk",
    "domain rack-a",
    "domain 9rack hosts=s00/h00",
    "domain rack-a hosts=s00/h00\ndomain rack-a hosts=s01/h00",
    "domain rack-a hosts=s00",
    "domain rack-a hosts=",
]

SLICES, HOSTS = 3, 4


def event_tuple(event):
    return (event.at, event.op, event.slice_idx, event.host_idx,
            event.args, event.line, event.target())


def test_schedule_parses_alike():
    got, got_domains = cluster.parse_schedule_with_domains(SCHEDULE)
    want, want_domains = ref.parse_schedule_with_domains(SCHEDULE)
    assert [event_tuple(e) for e in got] == [event_tuple(e) for e in want]
    assert got_domains == want_domains
    assert [event_tuple(e) for e in cluster.parse_schedule(SCHEDULE)] == \
        [event_tuple(e) for e in ref.parse_schedule(SCHEDULE)]


@pytest.mark.parametrize("text", BAD, ids=range(len(BAD)))
def test_bad_schedules_refused_alike(text):
    with pytest.raises(ValueError) as got:
        cluster.parse_schedule_with_domains(text)
    with pytest.raises(ValueError) as want:
        ref.parse_schedule_with_domains(text)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("args,members", [
    ({}, 4), ({"hosts": "1-2"}, 4), ({"hosts": "0-0"}, 1),
    ({"hosts": "2-1"}, 4), ({"hosts": "0-4"}, 4), ({"hosts": "x"}, 4)])
def test_host_range_alike(args, members):
    try:
        want = ref.parse_host_range(args, members)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).replace("(", r"\(")
                           .replace(")", r"\)")):
            cluster.parse_host_range(args, members)
    else:
        assert cluster.parse_host_range(args, members) == want


def node_name(slice_idx, host_idx):
    return f"s{slice_idx:02d}-h{host_idx:02d}"


def fleet(rng):
    view = {}
    for s in range(SLICES):
        for h in range(HOSTS):
            view[node_name(s, h)] = {
                ref.TPU_COUNT: str(rng.choice(["4", "8"])),
                ref.PERF_CLASS: str(rng.choice(["gold", "silver", ""])),
                ref.SLICE_ID: f"slice-{s}",
                ref.SLICE_DEGRADED: "false",
            }
    return view


def writes(event, view, domains, base):
    """The label writes one schedule event causes: (node, labels or None)
    pairs, each carrying the event's change id."""
    targets = []
    if event.op in ref.DOMAIN_OPS:
        targets = [node_name(s, h) for s, h in domains[event.args["domain"]]]
    elif event.host_idx is not None:
        targets = [node_name(event.slice_idx, event.host_idx)]
    elif event.slice_idx is not None:
        members = [node_name(event.slice_idx, h) for h in range(HOSTS)]
        targets = ([members[i] for i in ref.parse_host_range(
            event.args, HOSTS)] if event.op == "partition" else members)
    out = []
    for node in targets:
        labels = dict(view.get(node) or base[node])
        op = event.op
        if op == "degrade":
            labels[ref.PERF_CLASS] = "degraded"
        elif op == "heal":
            labels[ref.PERF_CLASS] = base[node][ref.PERF_CLASS]
        elif op in ("wedge", "partition", "domain-fail"):
            labels[ref.SLICE_DEGRADED] = "true"
        elif op in ("unwedge", "heal-partition", "domain-heal"):
            labels[ref.SLICE_DEGRADED] = "false"
        elif op == "preempt":
            labels[ref.LIFECYCLE_PREEMPT] = "true"
        elif op == "preempt-clear":
            labels.pop(ref.LIFECYCLE_PREEMPT, None)
        elif op == "leader-kill":
            labels[ref.SLICE_CLASS] = "degraded"
        elif op == "leader-restart":
            labels.pop(ref.SLICE_CLASS, None)
        elif op == "asym-partition":
            out.append((node, None))  # its object is deleted meanwhile
            continue
        labels[ref.CHANGE_KEY] = f"ch-{event.line}"
        out.append((node, labels))
    return out


def run_scheduler(module, agg_module, seed):
    """One seeded run; returns everything it decided and holds."""
    rng = np.random.default_rng(2500 + seed)
    events, domains = module.parse_schedule_with_domains(SCHEDULE)
    base = fleet(rng)
    scheduler = module.SimScheduler()
    scheduler.ring_capacity = 16
    store = agg_module.InventoryStore()
    record = {"transitions": [], "decisions": [], "drained": []}
    for node, labels in sorted(base.items()):
        record["transitions"].append(scheduler.on_event(node, labels))
        store.apply(node, labels)
    inventory = store.build_output_labels()
    inventory[ref.CHANGE_KEY] = "inv-0"
    scheduler.on_inventory(inventory)
    running = []  # (end, job_id)
    job_id = 0
    for event in events:
        t = event.at
        for node, labels in writes(event, scheduler.view, domains, base):
            record["transitions"].append(scheduler.on_event(node, labels))
            if labels is None:
                store.remove(node)
            else:
                store.apply(node, labels)
        if rng.random() < 0.5:
            inventory = store.build_output_labels()
            inventory[ref.CHANGE_KEY] = f"inv-{event.line}"
            scheduler.on_inventory(inventory)
        record["drained"].append(scheduler.drain_ineligible(t))
        for end, done in sorted(running):
            if end <= t:
                record["drained"].append(scheduler.release(done))
        running = [(end, j) for end, j in running if end > t]
        for _ in range(int(rng.integers(1, 4))):
            job_id += 1
            job = module.Job(f"job-{job_id}",
                             str(rng.choice(["any", "silver", "gold"])),
                             int(rng.choice([1, 4, 8, 12])),
                             float(rng.uniform(1, 15)))
            decision = scheduler.place(job, t, explain=bool(
                rng.random() < 0.6))
            record["decisions"].append((
                decision.job_id, decision.node, decision.reason,
                decision.at, decision.placed, decision.explain,
                scheduler.node_of(job.job_id), job.min_rank))
            if decision.placed:
                running.append((t + job.duration_s, job.job_id))
    record["state"] = {k: v for k, v in vars(scheduler).items()}
    record["placeable"] = {n: scheduler.placeable(n) for n in base}
    return record


@pytest.mark.parametrize("seed", range(3))
def test_scheduler_runs_decide_alike(seed):
    got = run_scheduler(cluster, agg, seed)
    want = run_scheduler(ref, ref_agg, seed)
    for key in ("transitions", "decisions", "drained", "placeable",
                "state"):
        assert got[key] == want[key], key
    reasons = {d[2] for d in got["decisions"]}
    assert "placed" in reasons and reasons - {"placed"}, reasons
    assert got["state"]["evicted_total"] > 0


def test_change_tracker_and_breakdown_alike():
    rng = np.random.default_rng(2600)
    port, want = cluster.ChangeTracker(), ref.ChangeTracker()
    nodes = [f"n{i}" for i in range(6)]
    t = 0.0
    for _ in range(400):
        t += float(rng.uniform(0, 2))
        node = nodes[int(rng.integers(len(nodes)))]
        op = int(rng.integers(5))
        if op == 0:
            kind = str(rng.choice(["degrade", "wedge", "preempt"]))
            assert port.mint(kind, node, t) == want.mint(kind, node, t)
        elif op == 1:
            stage = str(rng.choice(ref.CHAIN_STAGES + ("bogus",)))
            stamp_t = t - float(rng.uniform(-1, 3))
            port.stamp_node(node, stage, stamp_t)
            want.stamp_node(node, stage, stamp_t)
        elif op == 2:
            assert port.close(node, t) == want.close(node, t)
        elif op == 3:
            port.discard(node)
            want.discard(node)
        else:
            change = int(rng.integers(0, 50))
            assert port.known(change) == want.known(change)
            assert port.open_change(node) == want.open_change(node)
    assert vars(port) == vars(want)
    assert port.active() == want.active()
    assert port.closed
    assert cluster.stage_breakdown(port.closed, simnet.percentile) == \
        ref.stage_breakdown(want.closed, ref_simnet.percentile)
    stages = ("detect", "agree")
    assert cluster.stage_breakdown(port.closed, simnet.percentile,
                                   stages) == \
        ref.stage_breakdown(want.closed, ref_simnet.percentile, stages)
    chain = {s: float(rng.uniform(0, 500)) for s in ref.CHAIN_STAGES}
    assert cluster.slo_stage_durations(chain) == \
        ref.slo_stage_durations(chain)


def test_helpers_and_vocabularies_equal():
    rng = np.random.default_rng(2700)
    base = fleet(rng)
    variants = [{}, {ref.PERF_CLASS: "degraded"},
                {ref.SLICE_DEGRADED: "true"}, {ref.SLICE_CLASS: "degraded"},
                {ref.LIFECYCLE_PREEMPT: "true"},
                {ref.LIFECYCLE_DRAINING: "true"}, {ref.PERF_CLASS: "gold"}]
    view = {}
    for node, labels in base.items():
        labels = dict(labels, **variants[int(rng.integers(len(variants)))])
        view[node] = labels
        for fn in ("class_rank", "preempting", "basic_eligible",
                   "basic_reason"):
            assert getattr(cluster, fn)(labels) == getattr(ref, fn)(
                labels), fn
        for rank in range(4):
            assert cluster.node_eligible(labels, rank) == \
                ref.node_eligible(labels, rank)
    assert cluster.slice_blocked_ids(view) == ref.slice_blocked_ids(view)
    assert cluster.basic_eligible(None) == ref.basic_eligible(None)
    assert cluster.basic_reason(None) == ref.basic_reason(None)
    with pytest.raises(ValueError, match="unknown job class 'bronze'"):
        cluster.Job("j", "bronze", 1, 1.0)
    for name in ("CHANGE_KEY", "SLO_KEY", "SLO_STAGE_SOURCES", "CLASS_RANK",
                 "JOB_CLASS_RANK", "REJECTION_REASONS", "CHAIN_STAGES",
                 "HOST_OPS", "SLICE_OPS", "SERVER_OPS", "DOMAIN_OPS"):
        assert getattr(cluster, name) == getattr(ref, name), name
    assert cluster.SimScheduler.RING_CAPACITY == ref.SimScheduler.RING_CAPACITY
