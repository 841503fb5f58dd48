"""The port's flight-recorder reader against the reference's:
`tpufd_torch.journal` against `tpufd.journal` on documents generated from
a numpy seed, every schema error, and `python -m tpufd_torch journal`
against `python -m tpufd journal` on files, over HTTP and on a real
daemon's SIGUSR1 dump. The event helpers (merge_events, events_of_type,
label_changes, diffs_cover_changes and the per-type readers,
labels_file_text) against the reference's on drawn events and on that
daemon's journal and labels, and the port's metrics reader on its
/metrics page."""

import http.server
import json
import os
import signal
import subprocess
import sys
import threading

import numpy as np
import pytest

from conftest import REPO, daemon_argv, http_get, wait_for
from tpufd import journal as ref_journal
from tpufd.__main__ import main as ref_main
from tpufd.fakes import free_loopback_port
from tpufd_torch import journal

TYPES = ("probe-start", "probe-ok", "rewrite", "label-diff", "sink-write",
         "perf-measure", "dump")
SOURCES = ("health", "perf", "mock", "plugin.caps-ü")
TEXT = ("probe health succeeded", "wrote 24 labels", "héalth ✓ 健康",
        "Ωmega — dash", "quote ' and \" both")
FIELD_KEYS = ("duration_s", "key", "labeler", "tier", "matmul_tflops",
              "nöte")


def generated_doc(seed):
    """A journal document from a numpy seed. Event i cycles through the
    shapes the renderer branches on: source absent, empty or set;
    `message` absent every fourth event; `fields` empty on even events,
    else a few keys, some with empty values; `ts` fractional, or whole
    every fifth event. Seed 0 gives an empty ring."""
    rng = np.random.default_rng(seed)
    n = 0 if seed == 0 else int(rng.integers(4, 12))
    events = []
    seq = int(rng.integers(1, 10_000))
    for i in range(n):
        ts = 1.7e9 + float(rng.uniform(0, 3e7))
        event = {"seq": seq + i,
                 "ts": float(int(ts)) if i % 5 == 4 else ts,
                 "generation": int(rng.integers(0, 100)),
                 "change": int(rng.integers(0, 20)),
                 "type": TYPES[int(rng.integers(len(TYPES)))],
                 "fields": {}}
        if i % 3 == 1:
            event["source"] = SOURCES[int(rng.integers(len(SOURCES)))]
        elif i % 3 == 2:
            event["source"] = ""
        if i % 4 != 3:
            event["message"] = TEXT[int(rng.integers(len(TEXT)))]
        if i % 2:
            for key in rng.choice(FIELD_KEYS, size=int(rng.integers(1, 4)),
                                  replace=False):
                event["fields"][str(key)] = (
                    "" if rng.random() < 0.3
                    else TEXT[int(rng.integers(len(TEXT)))])
        events.append(event)
    return {"capacity": n + int(rng.integers(0, 4)),
            "dropped_total": int(rng.integers(0, 50)),
            "generation": int(rng.integers(0, 100)),
            "change": int(rng.integers(0, 20)),
            "events": events}


SEEDS = range(8)


@pytest.mark.parametrize("seed", SEEDS)
def test_parse_and_dump_text_equal_the_reference(seed):
    doc = generated_doc(seed)
    text = json.dumps(doc)
    for given in (text, text.encode(), json.loads(text)):
        got = journal.parse_journal(given)
        want = ref_journal.parse_journal(given)
        assert got == want == doc
        assert journal.dump_text(got) == ref_journal.dump_text(want)


def test_generated_docs_cover_every_branch():
    """The seeds above reach each shape the renderer branches on."""
    events = [e for seed in SEEDS for e in generated_doc(seed)["events"]]
    assert generated_doc(0)["events"] == []
    assert any("source" not in e for e in events)
    assert any(e.get("source") == "" for e in events)
    assert any(e.get("source") for e in events)
    assert any("message" not in e for e in events)
    assert any(not e["fields"] for e in events)
    assert any(e["fields"] and "" in e["fields"].values() for e in events)
    assert any(e["fields"] and "" not in e["fields"].values()
               for e in events)
    assert any(e["ts"] != int(e["ts"]) for e in events)
    assert any(not str(e.get("message", "")).isascii() for e in events)
    assert any(not "".join(e["fields"]).isascii() for e in events)


def minimal_doc():
    return {"capacity": 2, "dropped_total": 0, "generation": 1, "change": 0,
            "events": [{"seq": 1, "ts": 1700000000.25, "generation": 1,
                        "change": 0, "type": "probe-ok", "fields": {}}]}


def drop_top(key):
    def edit(doc):
        del doc[key]
    return edit


def drop_event_key(key):
    def edit(doc):
        del doc["events"][0][key]
    return edit


def over_capacity(doc):
    doc["capacity"] = 0


MALFORMED = (
    [(f"missing-{k}", drop_top(k)) for k in
     ("capacity", "dropped_total", "generation", "change", "events")]
    + [("over-capacity", over_capacity)]
    + [(f"event-missing-{k}", drop_event_key(k)) for k in
       ("seq", "ts", "generation", "change", "type", "fields")])


@pytest.mark.parametrize("edit", [m[1] for m in MALFORMED],
                         ids=[m[0] for m in MALFORMED])
def test_schema_errors_equal_the_reference(edit):
    doc = minimal_doc()
    edit(doc)
    with pytest.raises(ValueError) as want:
        ref_journal.parse_journal(json.loads(json.dumps(doc)))
    with pytest.raises(ValueError) as got:
        journal.parse_journal(json.loads(json.dumps(doc)))
    assert str(got.value) == str(want.value)


def run_port_journal(*args):
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    return subprocess.run(
        [sys.executable, "-m", "tpufd_torch", "journal", *args],
        cwd=str(REPO), env=env, capture_output=True, timeout=60)


def run_ref_journal(capsys, *args):
    capsys.readouterr()
    rc = ref_main(["journal", *args])
    return rc, capsys.readouterr().out


def as_dump(doc):
    """A SIGUSR1 dump's layout, the journal beside the other sections."""
    return {"dumped_at": 1700000001.5, "version": "v0.3.0",
            "labels": {"labels": {}, "provenance": {}},
            "published_labels": None, "snapshots": {}, "trace": {},
            "slo": {}, "journal": doc}


@pytest.mark.parametrize("shape", ["raw", "dump"])
@pytest.mark.parametrize("raw", [False, True], ids=["text", "raw"])
def test_file_output_equals_the_reference(tmp_path, capsys, shape, raw):
    doc = generated_doc(5)
    path = tmp_path / "journal.json"
    path.write_text(json.dumps(doc if shape == "raw" else as_dump(doc),
                               ensure_ascii=False), encoding="utf-8")
    flags = ["--file", str(path)] + (["--raw"] if raw else [])
    proc = run_port_journal(*flags)
    rc, out = run_ref_journal(capsys, *flags)
    assert proc.returncode == rc == 0, proc.stderr
    assert proc.stdout.decode("utf-8") == out


def test_malformed_file_raises_the_reference_error(tmp_path):
    doc = minimal_doc()
    del doc["events"][0]["type"]
    path = tmp_path / "journal.json"
    path.write_text(json.dumps(as_dump(doc)))
    with pytest.raises(ValueError) as want:
        ref_main(["journal", "--file", str(path)])
    proc = run_port_journal("--file", str(path))
    assert proc.returncode == 1 and proc.stdout == b""
    assert proc.stderr.decode().rstrip().endswith(
        f"ValueError: {want.value}")


class JournalServer:
    """A /debug/journal stand-in in a thread: serves `doc` and records
    every request path."""

    def __init__(self, doc):
        body = json.dumps(doc).encode()
        paths = self.paths = []

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):
                paths.append(self.path)
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):
                pass

        self.server = http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                                      Handler)
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=10)


@pytest.mark.parametrize("query, path", [
    ([], "/debug/journal?n=0&type="),
    (["--n", "3", "--type", "probe-ok"], "/debug/journal?n=3&type=probe-ok"),
])
def test_url_fetch_equals_the_reference(capsys, query, path):
    doc = generated_doc(3)
    with JournalServer(doc) as server:
        proc = run_port_journal("--url", server.url + "/", *query)
        rc, out = run_ref_journal(capsys, "--url", server.url + "/", *query)
    assert proc.returncode == rc == 0, proc.stderr
    assert server.paths == [path, path]
    assert proc.stdout.decode("utf-8") == out


def test_flags_and_defaults_equal_the_reference(monkeypatch):
    """Both parsers give the journal command the same arguments: the
    daemon's default introspection address, all events, no filter."""
    import tpufd.__main__ as ref_cli
    from tpufd_torch import __main__ as port_cli

    parsed = []
    for cli in (port_cli, ref_cli):
        monkeypatch.setattr(cli, "cmd_journal",
                            lambda args: parsed.append(vars(args)) or 0)
        assert cli.main(["journal"]) == 0
        parsed[-1].pop("fn")
    assert parsed[0] == parsed[1] == {
        "command": "journal", "url": "http://127.0.0.1:8081", "file": "",
        "n": 0, "type": "", "raw": False}




def whole_dump(path):
    """True once `path` holds a whole SIGUSR1 dump."""
    try:
        return "journal" in json.loads(path.read_text())
    except (OSError, ValueError):
        return False


@pytest.fixture(scope="module")
def daemon_run(tfd_binary, tmp_path_factory):
    """One run of the real daemon: the port's live read of its ring over
    HTTP (probe-ok, raw), two scrapes of its whole journal and of
    /debug/labels a few passes apart, its /metrics page, then a SIGUSR1
    dump."""
    tmp = tmp_path_factory.mktemp("daemon")
    port = free_loopback_port()
    out_file, dump = tmp / "tfd", tmp / "dump.json"
    proc = subprocess.Popen(
        daemon_argv(tfd_binary, port, out_file,
                    extra=(f"--debug-dump-file={dump}",)),
        env={**os.environ, "GCE_METADATA_HOST": "127.0.0.1:1"},
        stderr=subprocess.DEVNULL)

    def get(path):
        status, body = http_get(port, path)
        assert status == 200, (path, status)
        return body

    run = {"scrapes": [], "labels": []}
    try:
        assert wait_for(lambda: out_file.exists()), "first pass never ran"
        run["live"] = run_port_journal("--url", f"http://127.0.0.1:{port}",
                                       "--type", "probe-ok", "--raw")
        for _ in range(2):
            run["scrapes"].append(get("/debug/journal?n=0&type="))
            run["labels"].append(get("/debug/labels"))
            first = json.loads(run["scrapes"][0])["events"][-1]["seq"]
            assert wait_for(lambda: json.loads(get(
                "/debug/journal?n=0&type="))["events"][-1]["seq"]
                > first + 10), "the ring stood still"
        run["metrics"] = get("/metrics")
        proc.send_signal(signal.SIGUSR1)
        assert wait_for(lambda: whole_dump(dump)), "no dump"
    finally:
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=10)
    run["dump"] = dump
    return run


def test_real_daemon_dump_prints_the_reference_text(daemon_run, capsys):
    """One SIGUSR1 dump of the real daemon: both commands print the same
    text, and the port also reads the live ring over HTTP."""
    live, dump = daemon_run["live"], daemon_run["dump"]
    assert live.returncode == 0, live.stderr
    events = json.loads(live.stdout)["events"]
    assert events and {e["type"] for e in events} == {"probe-ok"}

    port_text = run_port_journal("--file", str(dump))
    rc, out = run_ref_journal(capsys, "--file", str(dump))
    assert port_text.returncode == rc == 0, port_text.stderr
    assert port_text.stdout.decode("utf-8") == out
    assert out.startswith("journal: ")
    assert " dump: SIGUSR1 debug dump requested" in out


def helpers_of(module, events, previous, current, debug_labels):
    """Every event helper of one journal module on one input."""
    return {
        "types": {t: module.events_of_type(events, t) for t in
                  ("label-diff", "probe-ok", "degradation", "dump",
                   "fault-injected", "breaker-transition", "absent")},
        "changes": module.label_changes(previous, current),
        "covered": module.diffs_cover_changes(
            events, module.label_changes(previous, current)),
        "degradation": module.degradation_transitions(events),
        "faults": module.fault_injections(events),
        "breaker": module.breaker_transitions(events),
        "file": module.labels_file_text(debug_labels),
    }


def test_real_daemon_journal_helpers_equal_the_reference(daemon_run):
    """Both scrapes and the dump merged by seq, then every event helper,
    on the real daemon's journal and labels: the port's results are the
    reference's, as a merged dict and as the dump's event list."""
    docs = [*daemon_run["scrapes"],
            json.loads(daemon_run["dump"].read_text())["journal"]]
    merged, want_merged = {}, {}
    for doc in docs:
        journal.merge_events(merged, journal.parse_journal(doc))
        ref_journal.merge_events(want_merged, ref_journal.parse_journal(doc))
    assert merged == want_merged
    assert len(merged) > max(len(journal.parse_journal(d)["events"])
                             for d in docs[:2])
    before, after = (json.loads(t) for t in daemon_run["labels"])
    for events in (merged, journal.parse_journal(docs[-1])["events"]):
        for previous, current, shown in [
                ({}, after["labels"], after),
                (before["labels"], after["labels"], daemon_run["labels"][1]),
                (after["labels"], {}, before)]:
            got = helpers_of(journal, events, previous, current, shown)
            assert got == helpers_of(ref_journal, events, previous, current,
                                     shown)
    got = helpers_of(journal, merged, {}, after["labels"], after)
    assert got["types"]["label-diff"] and got["types"]["probe-ok"]
    assert got["covered"] == (True, [])
    assert got["file"] == "".join(f"{k}={v}\n" for k, v in
                                  sorted(after["labels"].items()))


def test_real_daemon_metrics_page_reads_as_the_reference_reads_it(
        daemon_run):
    """The real daemon's /metrics page: the same samples from both
    readers, and both validators take it."""
    from tpufd import metrics as ref_metrics
    from tpufd_torch import metrics

    text = daemon_run["metrics"]
    got = list(metrics.parse_samples_ex(text))
    assert got == list(ref_metrics.parse_samples_ex(text)) and len(got) > 50
    metrics.validate_exposition(text)
    ref_metrics.validate_exposition(text)
    for name in ("tfd_rewrites_total", "tfd_probe_attempts_total"):
        for labels in (None, {"source": "mock"}):
            assert (metrics.sample_value(text, name, labels)
                    == ref_metrics.sample_value(text, name, labels))
    assert metrics.sample_value(text, "tfd_rewrites_total") >= 1


HELPER_TYPES = ("label-diff", "degradation", "fault-injected",
                "breaker-transition", "probe-ok")
HELPER_FIELDS = {
    "label-diff": ("key", "labeler", "source", "tier"),
    "degradation": ("from", "to"),
    "fault-injected": ("point", "action"),
    "breaker-transition": ("from", "to"),
    "probe-ok": ("duration_s",),
}


def helper_events(seed):
    """Events of every type a helper reads, from a numpy seed, each field
    present, empty or absent; and two label dicts that differ by added,
    removed and changed keys."""
    rng = np.random.default_rng(seed)
    events = []
    for seq in rng.permutation(60) + 1:
        kind = HELPER_TYPES[int(rng.integers(len(HELPER_TYPES)))]
        fields = {}
        for name in HELPER_FIELDS[kind]:
            draw = rng.random()
            if draw < 0.7:
                fields[name] = f"{name}-{int(rng.integers(4))}"
            elif draw < 0.85:
                fields[name] = ""
        events.append({"seq": int(seq), "ts": 1.7e9 + int(seq),
                       "generation": 1, "change": 0, "type": kind,
                       "fields": fields})
    keys = [f"google.com/tpu.k{i}" for i in range(8)]
    previous = {k: str(int(rng.integers(3))) for k in keys
                if rng.random() < 0.7}
    current = {k: str(int(rng.integers(3))) for k in keys
               if rng.random() < 0.7}
    return events, previous, current


@pytest.mark.parametrize("seed", range(6))
def test_drawn_journal_helpers_equal_the_reference(seed):
    events, previous, current = helper_events(seed)
    doc = {"capacity": 64, "dropped_total": 0, "generation": 1,
           "change": 0, "events": events}
    shown = {"labels": current, "provenance": {}}
    halves = [dict(doc, events=events[:40]), dict(doc, events=events[20:])]
    merged = {}
    for half in halves:
        journal.merge_events(merged, half)
    want = {}
    for half in halves:
        ref_journal.merge_events(want, half)
    assert merged == want and sorted(merged) == list(range(1, 61))
    for given in (events, merged):
        got = helpers_of(journal, given, previous, current, shown)
        assert got == helpers_of(ref_journal, given, previous, current,
                                 shown)
    assert journal.labels_file_text(json.dumps(shown)) == got["file"]
    assert journal.PROVENANCE_FIELDS == ref_journal.PROVENANCE_FIELDS
