"""The port's flight-recorder reader against the reference's:
`tpufd_torch.journal` against `tpufd.journal` on documents generated from
a numpy seed, every schema error, and `python -m tpufd_torch journal`
against `python -m tpufd journal` on files, over HTTP and on a real
daemon's SIGUSR1 dump."""

import http.server
import json
import os
import signal
import subprocess
import sys
import threading

import numpy as np
import pytest

from conftest import REPO, daemon_argv, wait_for
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


def test_real_daemon_dump_prints_the_reference_text(tfd_binary, tmp_path,
                                                    capsys):
    """One SIGUSR1 dump of the real daemon: both commands print the same
    text, and the port also reads the live ring over HTTP."""
    port = free_loopback_port()
    out_file = tmp_path / "tfd"
    dump = tmp_path / "dump.json"
    proc = subprocess.Popen(
        daemon_argv(tfd_binary, port, out_file,
                    extra=(f"--debug-dump-file={dump}",)),
        env={**os.environ, "GCE_METADATA_HOST": "127.0.0.1:1"},
        stderr=subprocess.DEVNULL)
    try:
        assert wait_for(lambda: out_file.exists()), "first pass never ran"
        live = run_port_journal("--url", f"http://127.0.0.1:{port}",
                                "--type", "probe-ok", "--raw")
        proc.send_signal(signal.SIGUSR1)
        assert wait_for(lambda: dump.exists()), "no dump"
    finally:
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=10)
    assert live.returncode == 0, live.stderr
    events = json.loads(live.stdout)["events"]
    assert events and {e["type"] for e in events} == {"probe-ok"}

    port_text = run_port_journal("--file", str(dump))
    rc, out = run_ref_journal(capsys, "--file", str(dump))
    assert port_text.returncode == rc == 0, port_text.stderr
    assert port_text.stdout.decode("utf-8") == out
    assert out.startswith("journal: ")
    assert " dump: SIGUSR1 debug dump requested" in out
