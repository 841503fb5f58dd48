"""The port's NodeFeature sink twin against the reference's:
`tpufd_torch.sink` against `tpufd.sink` on inputs drawn from a numpy
seed, compared with exact equality (ints, strings and IEEE doubles, so
no tolerance applies): the desync hashes, the merge patch and apply
bodies byte for byte, the watch-event parser on well-formed and hostile
lines, the breaker on outcome sequences, and the three write flows
driven through the same writes against each package's own fake
apiserver."""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest

from tpufd import sink as ref
from tpufd.fakes.apiserver import FakeApiServer as RefApiServer
from tpufd_torch import sink
from tpufd_torch.fakes.apiserver import FakeApiServer

ALPHABET = list("abcdefghijklmnopqrstuvwxyz0123456789-./_") + ["é", "\x00"]
KEYS = ("google.com/tpu.count", "google.com/tpu.perf.class",
        "google.com/tpu.slice.id", "google.com/tpu.health.ok",
        "foreign.io/x", "k")


def names(seed, n=200):
    """Node names: the fleet's own pattern, then random strings of any
    length (empty, non-ASCII and NUL included)."""
    rng = np.random.default_rng(seed)
    out = [f"node-{int(i)}" for i in rng.integers(0, 100000, n // 2)]
    for _ in range(n - len(out)):
        size = int(rng.integers(0, 24))
        out.append("".join(ALPHABET[int(i)]
                           for i in rng.integers(0, len(ALPHABET), size)))
    return out


def label_dict(rng, values=("4", "8", "gold", "silver", "true", "")):
    return {KEYS[int(i)]: values[int(rng.integers(len(values)))]
            for i in rng.choice(len(KEYS), int(rng.integers(0, len(KEYS))),
                                replace=False)}


def compact(doc):
    return json.dumps(doc, separators=(",", ":"), ensure_ascii=False)


def test_constants_equal():
    for name in ("FNV_OFFSET", "FNV_PRIME", "NODE_NAME_LABEL",
                 "MERGE_PATCH_CONTENT_TYPE", "APPLY_PATCH_CONTENT_TYPE",
                 "APPLY_FIELD_MANAGER", "CHANGE_ANNOTATION",
                 "SLO_ANNOTATION", "WATCH_EVENT_TYPES"):
        assert getattr(sink, name) == getattr(ref, name), name
    assert sink.DiffSink.MAX_ATTEMPTS == ref.DiffSink.MAX_ATTEMPTS


@pytest.mark.parametrize("seed", range(3))
def test_desync_math_bit_equal(seed):
    rng = np.random.default_rng(100 + seed)
    for node in names(seed):
        assert sink.fnv1a64(node) == ref.fnv1a64(node)
        assert sink.fnv1a64(node.encode()) == ref.fnv1a64(node.encode())
        assert sink.hash_unit(node).hex() == ref.hash_unit(node).hex()
        tick = int(rng.integers(0, 2 ** 62))
        assert (sink.jitter_unit(node, tick).hex()
                == ref.jitter_unit(node, tick).hex())
        base = float(rng.choice([0.0, -1.0, 1.0, 30.0, 60.0,
                                 rng.uniform(0, 600)]))
        pct = float(rng.choice([0.0, -5.0, 10.0, rng.uniform(0, 100)]))
        for fn in ("phase_offset_s", "refresh_period_s"):
            assert (getattr(sink, fn)(base, node, pct)
                    == getattr(ref, fn)(base, node, pct)), fn
        assert (sink.jittered_interval_s(base, node, tick, pct)
                == ref.jittered_interval_s(base, node, tick, pct))
        retry = float(rng.choice([0.0, -2.0, 1.0, rng.uniform(0, 30)]))
        assert (sink.spread_retry_after_s(retry, node)
                == ref.spread_retry_after_s(retry, node))


@pytest.mark.parametrize("seed", range(3))
def test_merge_patch_and_apply_body_bytes_equal(seed):
    rng = np.random.default_rng(200 + seed)
    for node in names(seed, 120):
        acked, desired = label_dict(rng), label_dict(rng)
        args = (acked, desired, node, bool(rng.integers(2)),
                str(int(rng.integers(0, 50))) if rng.integers(2) else "",
                "17" if rng.integers(2) else "",
                "plan=0:3" if rng.integers(2) else "")
        got, want = sink.build_merge_patch(*args), ref.build_merge_patch(*args)
        assert got == want
        if want is not None:
            assert compact(got) == compact(want)
        body = (f"ns-{seed}", node, desired, args[5], args[6])
        assert (compact(sink.build_apply_body(*body))
                == compact(ref.build_apply_body(*body)))


def watch_lines(seed, n=300):
    """Watch lines: well-formed events of every type, objects with
    missing or mistyped fields, and lines that are not JSON at all."""
    rng = np.random.default_rng(300 + seed)
    types = ["ADDED", "MODIFIED", "DELETED", "BOOKMARK", "ERROR", "BOGUS"]
    lines = ["", "not json", "[]", "null", "42", '{"type":"ADDED"}',
             '{"type":"ERROR","object":{"code":410.0}}',
             '{"type":"ERROR","object":{"code":"410"}}']
    for _ in range(n):
        labels = label_dict(rng)
        if rng.integers(4) == 0:
            labels["junk"] = int(rng.integers(100))
        meta = {"resourceVersion": str(int(rng.integers(1, 9999))),
                "name": f"tfd-features-for-n{int(rng.integers(50))}"}
        if rng.integers(3) == 0:
            meta["resourceVersion"] = int(rng.integers(1, 9999))
        if rng.integers(2):
            meta["annotations"] = {sink.CHANGE_ANNOTATION: "12",
                                   sink.SLO_ANNOTATION: "plan=1:2"}
        obj = {"metadata": meta, "spec": {"labels": labels}}
        if rng.integers(5) == 0:
            obj = {"kind": "Status", "code": int(rng.integers(400, 500))}
        doc = {"type": types[int(rng.integers(len(types)))], "object": obj}
        lines.append(json.dumps(doc))
    return lines


@pytest.mark.parametrize("seed", range(2))
def test_parse_watch_event_equal(seed):
    for line in watch_lines(seed):
        assert sink.parse_watch_event(line) == ref.parse_watch_event(line)


@pytest.mark.parametrize("seed", range(4))
def test_breaker_steps_alike(seed):
    rng = np.random.default_rng(400 + seed)
    open_after = int(rng.integers(1, 5))
    cooldown = float(rng.choice([0.5, 3.0, 30.0]))
    port = sink.Breaker(open_after, cooldown)
    want = ref.Breaker(open_after, cooldown)
    now = 0.0
    for _ in range(500):
        now += float(rng.choice([0.0, 0.25, 1.0, 5.0, 40.0]))
        op = int(rng.integers(4))
        if op == 0:
            assert port.allow(now) == want.allow(now)
        elif op == 1:
            seconds = float(rng.choice([0.0, 1.0, 7.5]))
            port.defer(seconds, now)
            want.defer(seconds, now)
        elif op == 2:
            port.record_success()
            want.record_success()
        else:
            port.record_transient_failure(now)
            want.record_transient_failure(now)
        assert vars(port) == vars(want)
    assert port.opens() == want.opens()
    assert port.transitions, "the sequence never moved the breaker"


def wire_request(server):
    def request(method, path, body, headers):
        data = compact(body).encode() if body is not None else None
        req = urllib.request.Request(f"{server.url}{path}", data=data,
                                     method=method)
        for key, value in headers.items():
            req.add_header(key, value)
        try:
            with urllib.request.urlopen(req, timeout=5) as resp:
                return (resp.status, dict(resp.headers),
                        json.loads(resp.read() or b"null"))
        except urllib.error.HTTPError as e:
            return e.code, dict(e.headers), json.loads(e.read() or b"null")
    return request


def drive(module, server_cls, flow, seed):
    """One write sequence through one sink flow against the package's
    own fake: seeded label sets, with a foreign edit, a foreign
    non-string value, an external delete, merge patch and apply each
    switched off and on between writes. Returns every outcome, the
    stored objects, the request log and the field managers."""
    rng = np.random.default_rng(500 + seed)
    ns, node = "ns", f"node-{seed}"
    key = (ns, f"tfd-features-for-{node}")
    outcomes = []
    with server_cls() as server:
        request = wire_request(server)
        writer = {"diff": lambda: module.DiffSink(node, ns),
                  "apply": lambda: module.ApplySink(node, ns),
                  "baseline": lambda: module.BaselineSink(node, ns)}[flow]()
        for step in range(24):
            event = int(rng.integers(8))
            if step and event == 0 and key in server.store:
                server.edit(ns, key[1], lambda o: o["spec"]["labels"]
                            .update({"foreign.io/x": "1"}))
            elif step and event == 1 and key in server.store:
                server.store[key]["spec"]["labels"]["junk"] = 123
                writer.invalidate()
            elif event == 2:
                server.delete(ns, key[1])
            elif event == 3:
                server.set_patch_supported(not rng.integers(3) == 0)
            elif event == 4:
                server.set_apply_supported(not rng.integers(3) == 0)
            labels = label_dict(rng, ("4", "8", "16", "gold", "silver"))
            out = writer.write(request, labels)
            outcomes.append(vars(out))
        return (outcomes, dict(server.store), list(server.requests),
                server.field_managers(*key),
                {k: v for k, v in vars(writer).items()})


@pytest.mark.parametrize("flow", ["diff", "apply", "baseline"])
@pytest.mark.parametrize("seed", range(2))
def test_write_flows_equal_against_their_fakes(flow, seed):
    got = drive(sink, FakeApiServer, flow, seed)
    want = drive(ref, RefApiServer, flow, seed)
    assert got[0] == want[0]  # every WriteOutcome, field for field
    assert got[1:] == want[1:]
    assert any(o["ok"] for o in got[0])
    verbs = {m for m, _ in got[2]}
    assert ("PATCH" in verbs) == (flow != "baseline"), verbs
