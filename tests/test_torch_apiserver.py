"""The port's fake apiserver against the reference's: the same HTTP
request sequence against `tpufd_torch.fakes.apiserver.FakeApiServer`
and `tpufd.fakes.apiserver.FakeApiServer` gives the same statuses,
headers that carry meaning, bodies and watch streams. The sequence
covers GET, LIST, POST, PUT and DELETE; a merge patch with a stale
resourceVersion (409); server-side apply by two field managers, with
and without force; per-object and collection watches, resumed from
their history and below the compaction floor (410); an injected 429
storm with Retry-After and the APF headers; an outage; bearer tokens;
the node cordon verb; and the pure selector and merge-patch helpers on
seeded input. Nothing is masked: no field of these answers is
wall-clock."""

import http.client
import json

import numpy as np
import pytest

from tpufd.fakes import apiserver as ref
from tpufd.fakes import free_loopback_port as ref_free_port
from tpufd_torch.fakes import apiserver
from tpufd_torch.fakes import free_loopback_port

NS = "fakens"
CR = f"/apis/nfd.k8s-sigs.io/v1alpha1/namespaces/{NS}/nodefeatures"
CM = f"/api/v1/namespaces/{NS}/configmaps"
APPLY = apiserver.APPLY_PATCH
MERGE = apiserver.MERGE_PATCH
# The response headers that carry the fake's contract.
HEADERS = ("Content-Type", "Retry-After", "Transfer-Encoding",
           "X-Kubernetes-PF-FlowSchema-UID",
           "X-Kubernetes-PF-PriorityLevel-UID")


def call(server, method, path, body=None, content_type="application/json",
         token=None):
    conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=10)
    headers = {"Content-Type": content_type}
    if token:
        headers["Authorization"] = f"Bearer {token}"
    data = json.dumps(body).encode() if body is not None else None
    conn.request(method, path, body=data, headers=headers)
    resp = conn.getresponse()
    raw = resp.read()
    conn.close()
    kept = {k: resp.headers[k] for k in HEADERS if k in resp.headers}
    if resp.headers.get("Transfer-Encoding") == "chunked":
        events = [json.loads(line) for line in raw.splitlines() if line]
        return resp.status, kept, events
    return resp.status, kept, json.loads(raw) if raw else None


def node_feature(name, labels, rv=None):
    meta = {"name": name, "namespace": NS,
            "labels": {"nfd.node.kubernetes.io/node-name": name[17:]}}
    if rv is not None:
        meta["resourceVersion"] = rv
    return {"apiVersion": "nfd.k8s-sigs.io/v1alpha1", "kind": "NodeFeature",
            "metadata": meta, "spec": {"labels": labels}}


def sequence(server):
    """The request sequence; returns every answer in order."""
    out = []

    def ask(*args, **kw):
        out.append(call(server, *args, **kw))
        return out[-1]

    a, b = "tfd-features-for-a", "tfd-features-for-b"
    ask("GET", f"{CR}/{a}")                                   # 404
    ask("POST", CR, node_feature(a, {"google.com/tpu.count": "4"}))
    ask("POST", CR, node_feature(a, {"x": "1"}))              # 409 exists
    ask("POST", CR, node_feature(b, {"google.com/tpu.count": "8"}))
    ask("GET", f"{CR}/{a}")
    ask("PUT", f"{CR}/{a}", node_feature(a, {"k": "v"}, rv="1"))
    ask("PUT", f"{CR}/{a}", node_feature(a, {"k": "w"}, rv="1"))  # 409
    ask("PUT", f"{CR}/ghost", node_feature("ghost", {}, rv="1"))  # 404
    ask("PATCH", f"{CR}/{a}", {"metadata": {"resourceVersion": "1"},
                               "spec": {"labels": {"k": "x"}}},
        content_type=MERGE)                                   # stale: 409
    ask("PATCH", f"{CR}/{a}", {"metadata": {"resourceVersion": "2"},
                               "spec": {"labels": {"k": None, "n": "1"}}},
        content_type=MERGE)
    ask("PATCH", f"{CR}/{a}", {"spec": {"labels": {"m": "2"}}},
        content_type="application/json-patch+json")           # 415
    # Server-side apply by two field managers: ownership, the no-op
    # apply, a conflict without force and the transfer with it.
    c = "tfd-features-for-c"
    ask("PATCH", f"{CR}/{c}?fieldManager=tfd&force=true",
        node_feature(c, {"k": "1", "j": "2"}), content_type=APPLY)
    ask("PATCH", f"{CR}/{c}?fieldManager=tfd&force=true",
        node_feature(c, {"k": "1", "j": "2"}), content_type=APPLY)  # no-op
    ask("PATCH", f"{CR}/{c}?fieldManager=other",
        {"spec": {"labels": {"k": "9"}}}, content_type=APPLY)       # 409
    ask("PATCH", f"{CR}/{c}?fieldManager=other&force=true",
        {"spec": {"labels": {"k": "9", "o": "3"}}}, content_type=APPLY)
    ask("PATCH", f"{CR}/{c}?fieldManager=tfd&force=true",
        node_feature(c, {"j": "5"}), content_type=APPLY)
    ask("GET", f"{CR}/{c}")
    # Per-object watch from the start of its history, then below the
    # compaction floor.
    ask("GET", f"{CR}/{c}?watch=true&resourceVersion=0&timeoutSeconds=0.3")
    server.compact(NS, c)
    ask("GET", f"{CR}/{c}?watch=true&resourceVersion=1&timeoutSeconds=0.3")
    # Collection LIST (with selectors) and watch, then its 410.
    ask("GET", CR)
    ask("GET", f"{CR}?labelSelector=nfd.node.kubernetes.io%2Fnode-name")
    ask("GET", f"{CR}?labelSelector=nfd.node.kubernetes.io%2Fnode-name%3Da")
    ask("GET", f"{CR}?labelSelector=%21nfd.node.kubernetes.io%2Fnode-name")
    ask("GET", f"{CR}?watch=true&resourceVersion=2&timeoutSeconds=0.3")
    server.compact_collection(NS)
    ask("GET", f"{CR}?watch=true&resourceVersion=2&timeoutSeconds=0.3")
    ask("DELETE", f"{CR}/{b}")
    ask("DELETE", f"{CR}/{b}")                                # 404
    # Coordination ConfigMaps share the store and its semantics.
    ask("POST", CM, {"metadata": {"name": "tfd-slice-s1"},
                     "data": {"lease": "x"}})
    ask("PATCH", f"{CM}/tfd-slice-s1", {"data": {"lease": "y"}},
        content_type=MERGE)
    ask("GET", f"{CM}/tfd-slice-s1")
    # The node cordon verb.
    ask("PATCH", "/api/v1/nodes/ghost", {"spec": {"unschedulable": True}},
        content_type=MERGE)                                   # 404
    server.set_node("n1", taints=[{"key": "k", "effect": "NoSchedule"}])
    ask("PATCH", "/api/v1/nodes/n1", {"metadata": {"resourceVersion": "9"},
                                      "spec": {"unschedulable": True}},
        content_type=MERGE)                                   # 409
    ask("PATCH", "/api/v1/nodes/n1", {"spec": {"unschedulable": True}},
        content_type=MERGE)
    ask("GET", "/api/v1/nodes/n1")
    # A 429 storm with Retry-After and the APF attribution, an outage,
    # then the fallbacks switched off.
    server.set_failing(429, retry_after=7, apf=True)
    for path in (f"{CR}/{a}", CR, "/api/v1/nodes/n1"):
        ask("GET", path)
    ask("PATCH", f"{CR}/{a}", {"spec": {"labels": {}}}, content_type=MERGE)
    server.set_failing(503)
    ask("GET", f"{CR}/{a}")
    server.set_failing(0)
    server.set_patch_supported(False)
    ask("PATCH", f"{CR}/{a}", {"spec": {"labels": {}}}, content_type=MERGE)
    server.set_apply_supported(False)
    ask("PATCH", f"{CR}/{a}?fieldManager=tfd", node_feature(a, {}),
        content_type=APPLY)
    ask("GET", "/elsewhere")
    return out


def run(module):
    with module.FakeApiServer(watch_history=4,
                              collection_history=8) as server:
        answers = sequence(server)
        server.seed(NS, "tfd-features-for-s", {"x": "1"},
                    {"nfd.node.kubernetes.io/node-name": "s"},
                    annotations={"tfd.google.com/change-id": "3"})
        server.seed(NS, "tfd-features-for-s", {"x": "2"})
        server.edit(NS, "tfd-features-for-s",
                    lambda o: o["spec"]["labels"].update({"e": "1"}))
        state = (dict(server.store), list(server.requests),
                 [(m, s) for _, m, s in server.timeline],
                 server.field_managers(NS, "tfd-features-for-c"),
                 server._handler.events, server._handler.compacted,
                 server._handler.collection_events,
                 server._handler.collection_compacted,
                 server._handler.grv, server._handler.nodes,
                 server._handler.node_events)
    return answers, state


def test_same_sequence_same_answers():
    got, got_state = run(apiserver)
    want, want_state = run(ref)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"answer {i}"
    assert got_state == want_state
    statuses = {status for status, _, _ in got}
    assert {200, 201, 404, 409, 410, 415, 429, 503} <= statuses | {
        e["object"].get("code") for _, _, body in got
        if isinstance(body, list) for e in body if e["type"] == "ERROR"}


def test_bearer_token_enforced_alike():
    for module in (apiserver, ref):
        with module.FakeApiServer(token="sekrit") as server:
            assert call(server, "GET", f"{CR}/x")[0] == 401
            assert call(server, "GET", f"{CR}/x", token="sekrit")[0] == 404
            assert call(server, "GET", f"{CR}/x", token="wrong")[0] == 401


def test_listener_partition_alike():
    answers = []
    for module in (apiserver, ref):
        with module.FakeApiServer() as server:
            server.seed(NS, "tfd-features-for-h", {"k": "v"})
            listener = server.add_listener()
            second = type("S", (), {"port": listener.port})
            seen = [call(second, "GET", f"{CR}/tfd-features-for-h")]
            listener.stop()
            with pytest.raises(OSError):
                call(second, "GET", f"{CR}/tfd-features-for-h")
            listener.start()
            seen.append(call(second, "GET", f"{CR}/tfd-features-for-h"))
            listener.stop()
            answers.append(seen)
    assert answers[0] == answers[1]


@pytest.mark.parametrize("seed", range(3))
def test_selectors_and_merge_patch_equal(seed):
    rng = np.random.default_rng(600 + seed)
    keys = ["a", "b", "nfd.node.kubernetes.io/node-name"]
    for _ in range(300):
        terms = []
        for _ in range(int(rng.integers(0, 4))):
            key = keys[int(rng.integers(len(keys)))]
            terms.append(key + ["", "=1", "==1", "!=1"][int(rng.integers(4))]
                         if rng.integers(4) else "!" + key)
        text = " , ".join(terms) + ("," if rng.integers(2) else "")
        assert (apiserver.parse_label_selector(text)
                == ref.parse_label_selector(text))
        obj = {"metadata": {"labels": {k: str(int(rng.integers(3)))
                                       for k in keys if rng.integers(2)}}}
        parsed = ref.parse_label_selector(text)
        assert (apiserver.selector_matches(parsed, obj)
                == ref.selector_matches(parsed, obj))
        target = {"x": {"y": 1, "z": [1]}, "w": "v"}
        patch = {"x": {"y": None, "q": int(rng.integers(9))},
                 "w": None if rng.integers(2) else {"n": 1}, "new": "1"}
        assert (apiserver.merge_patch(json.loads(json.dumps(target)), patch)
                == ref.merge_patch(json.loads(json.dumps(target)), patch))


def test_module_constants_and_free_port():
    for name in ("PREFIX", "CORE_PREFIX", "MERGE_PATCH", "APPLY_PATCH",
                 "WATCH_HISTORY", "COLLECTION_HISTORY", "NODES_PREFIX"):
        assert getattr(apiserver, name) == getattr(ref, name), name
    for fn in (free_loopback_port, ref_free_port):
        port = fn()
        assert 0 < port < 65536
