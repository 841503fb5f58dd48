"""The port's trace recorder twin against the reference's:
`tpufd_torch.trace` against `tpufd.trace` on mint/stage/publish
sequences drawn from a numpy seed with injected timestamps. The
/debug/trace JSON and the Chrome trace-event rendering must be the same
bytes; so must the stage-SLO document through folds and expiry; the
per-stage durations, the document parsers (their refusals included) and
the change join must agree."""

import json

import numpy as np
import pytest

from tpufd import trace as ref
from tpufd_torch import trace

ORIGINS = ("probe", "slice", "lifecycle", "drift", "remedy")
SOURCES = ("health", "perf", "mock", "plugin.device-health", 'q"uo\\te')
STAGE_NAMES = ref.PASS_STAGES + ("agree", "fanout")


def recorders(capacity):
    return trace.TraceRecorder(capacity), ref.TraceRecorder(capacity)


def script(seed, n=400):
    """(op, args) steps with a clock that advances, stands still, and now
    and then steps backwards (the renderers clamp those intervals)."""
    rng = np.random.default_rng(1400 + seed)
    now = 1_700_000_000.0 + float(rng.uniform(0, 1000))
    generation = 0
    for _ in range(n):
        now += float(rng.choice([0.0, 1e-6, 0.0005, 0.013, 0.25, 1.5,
                                 -0.004]))
        op = int(rng.integers(6))
        if op <= 1:
            yield "mint", (str(rng.choice(ORIGINS)),
                           str(rng.choice(SOURCES)),
                           f"chip-{int(rng.integers(8))} moved\n", now)
        elif op <= 3:
            yield "stage", (str(rng.choice(STAGE_NAMES)), now)
        else:
            generation += 1
            through = (None if rng.random() < 0.5
                       else int(rng.integers(0, 60)))
            yield "publish", (generation, now, through)


def play(recorder, steps):
    returned = []
    for op, args in steps:
        if op == "mint":
            returned.append(recorder.mint(*args))
        elif op == "stage":
            recorder.stage(*args)
        else:
            retired = recorder.mark_published(*args)
            returned.append([(r["change"], list(r["stages"]))
                             for r in retired])
    return returned


@pytest.mark.parametrize("capacity", [4, 64, 256])
@pytest.mark.parametrize("seed", range(3))
def test_recorder_renderings_are_the_same_bytes(capacity, seed):
    port, want = recorders(capacity)
    assert play(port, script(seed)) == play(want, script(seed))
    assert port.records == want.records
    assert (port.dropped, port.active(), port.latest_active_change()) == (
        want.dropped, want.active(), want.latest_active_change())
    assert port.render_chrome_trace() == want.render_chrome_trace()
    for n in (0, 1, 5, capacity + 3):
        for change in (0, 1, port.next_change - 1, port.next_change + 9):
            assert port.render_json(n, change) == want.render_json(
                n, change)
    doc = trace.parse_trace(port.render_json())
    assert doc == ref.parse_trace(want.render_json())
    json.loads(port.render_chrome_trace())


@pytest.mark.parametrize("seed", range(2))
def test_stage_durations_and_joins_equal(seed):
    port, want = recorders(256)
    play(port, script(seed))
    play(want, script(seed))
    for mine, theirs in zip(port.records, want.records):
        assert trace.stage_durations_ms(mine) == ref.stage_durations_ms(
            theirs)
    doc = json.loads(port.render_json())
    for change in range(0, port.next_change + 2):
        assert trace.records_for_change(doc, change) == \
            ref.records_for_change(doc, change)
    # A parsed record (stages as a JSON object) gives the same durations
    # once its stages are read back in document order.
    for record in doc["records"]:
        parsed = {"minted_ts": record["minted_ts"],
                  "stages": list(record["stages"].items())}
        assert trace.stage_durations_ms(parsed) == \
            ref.stage_durations_ms(parsed)


@pytest.mark.parametrize("window_s", [0, 5, 600])
@pytest.mark.parametrize("seed", range(2))
def test_stage_slo_folds_alike(window_s, seed):
    rng = np.random.default_rng(1500 + seed)
    port, want = trace.StageSlo(window_s), ref.StageSlo(window_s)
    now = 0.0
    for change in range(1, 300):
        now += float(rng.choice([0.1, 1.0, 3.0, 20.0]))
        if rng.random() < 0.15:
            port.expire(now)
            want.expire(now)
            continue
        stage_ms = {s: float(rng.uniform(0, 4000)) for s in
                    ref.PASS_STAGES + ("bogus",) if rng.random() < 0.6}
        port.fold(change, stage_ms, now)
        want.fold(change, stage_ms, now)
        assert port.render_json() == want.render_json()
        assert port.serialize() == want.serialize()
    assert trace.parse_slo(port.render_json()) == ref.parse_slo(
        want.render_json())


BROKEN = [
    '{"capacity":1,"dropped_total":0,"active":0,"minted_total":0}',
    '{"capacity":1,"dropped_total":0,"active":0,"minted_total":2,'
    '"records":[{"change":1},{"change":2}]}',
    '{"capacity":4,"dropped_total":0,"active":0,"minted_total":1,'
    '"records":[{"change":1,"generation":0,"minted_ts":1.0,'
    '"origin":"x","published":false}]}',
    '{"window_s":60,"samples":0}',
    '{"window_s":60,"samples":0,"folded_total":0,"retired_total":0,'
    '"last_change":0,"stages":{"plan":{"count":1}},"serialized":""}',
]


@pytest.mark.parametrize("text", BROKEN, ids=range(len(BROKEN)))
def test_parsers_refuse_alike(text):
    parse = "parse_slo" if "window_s" in text else "parse_trace"
    with pytest.raises(ValueError) as got:
        getattr(trace, parse)(text)
    with pytest.raises(ValueError) as want:
        getattr(ref, parse)(text)
    assert str(got.value) == str(want.value)


def test_constants_equal():
    assert trace.PUBLISH_ACKED == ref.PUBLISH_ACKED
    assert trace.PASS_STAGES == ref.PASS_STAGES
    assert trace.TraceRecorder.DEFAULT_CAPACITY == \
        ref.TraceRecorder.DEFAULT_CAPACITY
    assert trace.StageSlo.DEFAULT_WINDOW_S == ref.StageSlo.DEFAULT_WINDOW_S
