"""The port's own copy of ``tpufd.fakes.apiserver``
(``tpufd/fakes/apiserver.py``), kept equal to it and importing nothing
of ``tpufd``.

A fake Kubernetes API server for the NodeFeature CR sink tests.

Implements just the NFD CR surface the daemon talks to:
  GET    /apis/nfd.k8s-sigs.io/v1alpha1/namespaces/{ns}/nodefeatures/{name}
  GET    ...?watch=true (chunked watch stream: ADDED/MODIFIED/DELETED/
         BOOKMARK/ERROR events, resourceVersion semantics, 410 Gone on a
         compacted-away version, timeoutSeconds rotation)
  POST   /apis/nfd.k8s-sigs.io/v1alpha1/namespaces/{ns}/nodefeatures
  PUT    /apis/nfd.k8s-sigs.io/v1alpha1/namespaces/{ns}/nodefeatures/{name}
  PATCH  ... (application/merge-patch+json RFC 7386 with the
         resourceVersion-precondition 409, AND application/apply-patch+yaml
         server-side apply with per-field-manager ownership of spec.labels)
  DELETE /apis/nfd.k8s-sigs.io/v1alpha1/namespaces/{ns}/nodefeatures/{name}
with in-memory storage, resourceVersion bumping, optional bearer-token
enforcement, 429/Retry-After throttling (a fixed capacity per second, or
an injected storm), and optional TLS (certfile/keyfile).

Server-side apply model (the subset the daemon's ladder needs): each
object tracks which field manager owns which spec.labels key. An apply
from manager M replaces M's previously-owned keys with the applied set
— keys M no longer sends are removed, keys owned by OTHER managers
survive untouched. Without force=true, applying a key another manager
owns at a different value answers 409; with force, ownership transfers.
A PUT replaces spec.labels wholesale and clears all ownership (the
documented bottom-rung clobber).

HTTP/1.1 with keep-alive: the cluster-in-a-box fleet soak drives ~1000
simulated daemons through persistent connections; one thread per
connection instead of one per request is what makes that feasible.
Watch streams hold their handler thread for the stream's lifetime.
"""

import copy
import json
import ssl
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs

PREFIX = "/apis/nfd.k8s-sigs.io/v1alpha1/namespaces/"
# Core-API ConfigMaps: the slice-coherence layer keeps one per slice
# ("tfd-slice-<id>") as its coordination blackboard (lease + member
# reports + verdict). Same store, same resourceVersion/merge-patch
# semantics — names never collide with the NodeFeature CRs.
CORE_PREFIX = "/api/v1/namespaces/"
MERGE_PATCH = "application/merge-patch+json"
APPLY_PATCH = "application/apply-patch+yaml"

# Watch-event history retained per object; a watch asking for a version
# older than the retained window answers ERROR 410 (client must re-list).
# Default only — FakeApiServer(watch_history=...) overrides per server
# (a 100k-node sharded soak needs a floor proportional to fleet size or
# every reconnect would 410 into a full re-list).
WATCH_HISTORY = 64
# Collection-scoped history (one merged stream per namespace, ordered by
# the GLOBAL resourceVersion — the real apiserver's storage revision).
# Deliberately larger than the per-object window: one busy object must
# not compact every peer's events out from under a collection watcher.
# Default only — FakeApiServer(collection_history=...) overrides.
COLLECTION_HISTORY = 256
# Cluster-scoped core resources (GET/PUT /api/v1/nodes/<name>): the
# lifecycle probe reads spec.unschedulable/taints from here.
NODES_PREFIX = "/api/v1/nodes"


def parse_label_selector(text):
    """Parses a labelSelector query value into a list of (op, key, value)
    terms: op is 'exists', 'notexists', 'eq' or 'neq'. The subset the
    aggregator and tests use — set-based expressions are not served."""
    terms = []
    for raw in (text or "").split(","):
        raw = raw.strip()
        if not raw:
            continue
        if "!=" in raw:
            key, _, value = raw.partition("!=")
            terms.append(("neq", key.strip(), value.strip()))
        elif "==" in raw:
            key, _, value = raw.partition("==")
            terms.append(("eq", key.strip(), value.strip()))
        elif "=" in raw:
            key, _, value = raw.partition("=")
            terms.append(("eq", key.strip(), value.strip()))
        elif raw.startswith("!"):
            terms.append(("notexists", raw[1:].strip(), None))
        else:
            terms.append(("exists", raw, None))
    return terms


def selector_matches(terms, obj):
    labels = (obj.get("metadata") or {}).get("labels") or {}
    for op, key, value in terms:
        if op == "exists" and key not in labels:
            return False
        if op == "notexists" and key in labels:
            return False
        if op == "eq" and labels.get(key) != value:
            return False
        if op == "neq" and labels.get(key) == value:
            return False
    return True


def merge_patch(target, patch):
    """RFC 7386 JSON merge patch, in place on `target` (a dict)."""
    for key, value in patch.items():
        if value is None:
            target.pop(key, None)
        elif isinstance(value, dict):
            if not isinstance(target.get(key), dict):
                target[key] = {}
            merge_patch(target[key], value)
        else:
            target[key] = value
    return target


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"  # keep-alive for the fleet soak

    store = None  # type: dict
    token = None
    lock = None
    requests = None  # type: list  # (method, path) per handled request
    timeline = None  # type: list  # (monotonic_t, method, status)
    # Watch machinery: per-object event history [(rv:int, type, object)],
    # the compaction floor (oldest replayable rv), per-manager
    # spec.labels ownership, and the condition watchers park on.
    events = None     # type: dict  # (ns, name) -> list
    compacted = None  # type: dict  # (ns, name) -> int
    managers = None   # type: dict  # (ns, name) -> {manager: set(keys)}
    # Collection-scoped watch machinery: a GLOBAL resourceVersion (the
    # storage revision every emitted event is ordered by), one merged
    # per-namespace history, and its compaction floor.
    grv = None                  # type: list  # [int]
    collection_events = None    # type: dict  # ns -> [(grv, type, obj)]
    collection_compacted = None  # type: dict  # ns -> int
    nodes = None      # type: dict  # name -> Node object (/api/v1/nodes)
    # Retained history depths (the 410 compaction floors). Class attrs
    # so FakeApiServer(watch_history=..., collection_history=...) can
    # size the replay window to the fleet under test.
    watch_history = WATCH_HISTORY
    collection_history = COLLECTION_HISTORY
    watch_cond = None
    closing = None    # type: list  # [bool] — server shutting down
    bookmark_interval = 0.5
    # When truthy, every CR request gets this HTTP status before touching
    # the store — apiserver outage injection (5xx reads as transient to
    # the daemon, which stays alive and flips /readyz once rewrites go
    # stale; see FakeApiServer.set_failing). failing_retry_after rides a
    # Retry-After header on the injected status; failing_apf adds the
    # API-Priority-and-Fairness attribution headers a real apiserver
    # sends on a priority-level rejection.
    failing = 0
    failing_retry_after = None
    failing_apf = False
    # Requests-per-second capacity: above it every CR request answers
    # 429 + Retry-After until the next second's bucket (0 = unlimited).
    capacity = 0
    cap_bucket = None  # type: list  # [epoch_second, count]
    # When False, merge-PATCH answers 415 — an apiserver predating
    # merge-patch support on this resource; the client must fall back to
    # GET+PUT. apply_supported gates server-side apply the same way
    # (False exercises the SSA -> merge-patch ladder rung).
    patch_supported = True
    apply_supported = True

    def _check_auth(self):
        if self.token is None:
            return True
        return self.headers.get("Authorization") == f"Bearer {self.token}"

    def _reply(self, code, obj=None, headers=None):
        # Request log BEFORE the response: a no-op daemon pass (GET,
        # compare, skip the PUT) is otherwise invisible server-side, and
        # the soak harness counts passes by watching this stream.
        with self.lock:
            self.requests.append((self.command, self.path))
            self.timeline.append((time.monotonic(), self.command, code))
        body = json.dumps(obj).encode() if obj is not None else b"{}"
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for key, value in (headers or {}).items():
            self.send_header(key, value)
        self.end_headers()
        self.wfile.write(body)

    def _apf_headers(self):
        return {
            "X-Kubernetes-PF-FlowSchema-UID": "fake-flow-schema",
            "X-Kubernetes-PF-PriorityLevel-UID": "fake-priority-level",
        }

    def _gate(self):
        """Outage / throttle gate shared by every verb. Returns True when
        the request was already answered (injected failure or 429)."""
        if self.failing:
            headers = {}
            if self.failing_retry_after is not None:
                headers["Retry-After"] = str(self.failing_retry_after)
            if self.failing_apf:
                headers.update(self._apf_headers())
            self._reply(self.failing, {"message": "injected outage"},
                        headers=headers)
            return True
        if self.capacity:
            now = time.monotonic()
            with self.lock:
                bucket = int(now)
                if self.cap_bucket[0] != bucket:
                    self.cap_bucket[0] = bucket
                    self.cap_bucket[1] = 0
                self.cap_bucket[1] += 1
                over = self.cap_bucket[1] > self.capacity
            if over:
                self._reply(429, {"message": "too many requests"},
                            headers={"Retry-After": "1",
                                     **self._apf_headers()})
                return True
        if not self._check_auth():
            self._reply(401, {"message": "unauthorized"})
            return True
        return False

    def _split_path(self):
        path, _, query = self.path.partition("?")
        return path, parse_qs(query)

    def _parse(self):
        path, _ = self._split_path()
        for prefix, resource in ((PREFIX, "nodefeatures"),
                                 (CORE_PREFIX, "configmaps")):
            if not path.startswith(prefix):
                continue
            rest = path[len(prefix):]
            parts = rest.split("/")
            if len(parts) >= 2 and parts[1] == resource:
                name = parts[2] if len(parts) > 2 else None
                return parts[0], name
        return None, None

    def _body(self):
        """Consumes and parses the request body. Body-carrying verbs MUST
        call this before any early reply (429 gate, 415, 409): with
        HTTP/1.1 keep-alive an unread body stays in the socket and gets
        parsed as the NEXT request line, answering every later request
        on the connection with a bogus 501."""
        length = int(self.headers.get("Content-Length", "0"))
        raw = self.rfile.read(length)
        return json.loads(raw) if raw else {}

    @classmethod
    def _emit(cls, ns, name, event_type, obj):
        """Appends one watch event (lock held by the caller) and wakes
        every parked watcher. History beyond WATCH_HISTORY is compacted
        away — a watch resuming from before the floor gets 410 Gone.
        Classmethod: the FakeApiServer facade (edit/delete helpers)
        emits through the handler CLASS, which owns all shared state."""
        history = cls.events.setdefault((ns, name), [])
        rv = int(obj["metadata"]["resourceVersion"])
        history.append((rv, event_type, copy.deepcopy(obj)))
        if len(history) > cls.watch_history:
            dropped = history[:-cls.watch_history]
            del history[:-cls.watch_history]
            cls.compacted[(ns, name)] = dropped[-1][0]
        # Collection stream: the same event ordered by the GLOBAL
        # resourceVersion (per-object rvs are per-object counters and
        # cannot order a merged stream).
        cls.grv[0] += 1
        chistory = cls.collection_events.setdefault(ns, [])
        chistory.append((cls.grv[0], event_type, copy.deepcopy(obj)))
        if len(chistory) > cls.collection_history:
            dropped = chistory[:-cls.collection_history]
            del chistory[:-cls.collection_history]
            cls.collection_compacted[ns] = dropped[-1][0]
        cls.watch_cond.notify_all()

    # ---- watch stream ----------------------------------------------------

    def _watch(self, ns, name, query):
        """Serves GET ...?watch=true as a chunked event stream until
        timeoutSeconds elapses (clean rotation), the client goes away,
        or the server closes."""
        try:
            timeout_s = float(query.get("timeoutSeconds", ["30"])[0])
        except ValueError:
            timeout_s = 30.0
        bookmarks = query.get("allowWatchBookmarks", ["false"])[0] == "true"
        start_rv = query.get("resourceVersion", [None])[0]

        key = (ns, name)
        with self.lock:
            self.requests.append(("WATCH", self.path))
            self.timeline.append((time.monotonic(), "WATCH", 200))
            # "Future events only" is relative to REQUEST ARRIVAL, not
            # to whenever this thread gets scheduled after the headers
            # flush — a write racing the header round-trip must still
            # be delivered.
            floor = self.compacted.get(key, 0)
            obj = self.store.get(key)
            history = self.events.get(key, [])
            candidates = [0]
            if obj:
                candidates.append(int(obj["metadata"]["resourceVersion"]))
            candidates.extend(rv for rv, _, _ in history)
            rv_at_request = max(candidates)

        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()

        def emit(doc):
            data = json.dumps(doc, separators=(",", ":")).encode() + b"\n"
            self.wfile.write(b"%x\r\n" % len(data) + data + b"\r\n")
            self.wfile.flush()

        def finish():
            self.wfile.write(b"0\r\n\r\n")
            self.wfile.flush()

        if start_rv is not None:
            try:
                last_sent = int(start_rv)
            except ValueError:
                last_sent = 0
            if last_sent < floor:
                try:
                    emit({"type": "ERROR",
                          "object": {"kind": "Status", "code": 410,
                                     "message":
                                         "too old resource version"}})
                    finish()
                except OSError:
                    pass
                return
        else:
            # No version named: future events only (the "start from
            # now" informer bootstrap; the client lists first).
            last_sent = rv_at_request

        deadline = time.monotonic() + timeout_s
        next_bookmark = time.monotonic() + self.bookmark_interval
        try:
            while not self.closing[0]:
                now = time.monotonic()
                if now >= deadline:
                    break
                pending = []
                with self.watch_cond:
                    history = self.events.get(key, [])
                    pending = [e for e in history if e[0] > last_sent]
                    if not pending:
                        self.watch_cond.wait(
                            timeout=min(0.1, max(0.0, deadline - now)))
                        history = self.events.get(key, [])
                        pending = [e for e in history if e[0] > last_sent]
                for rv, event_type, obj in pending:
                    emit({"type": event_type, "object": obj})
                    last_sent = rv
                if bookmarks and time.monotonic() >= next_bookmark:
                    emit({"type": "BOOKMARK",
                          "object": {"metadata":
                                     {"resourceVersion": str(last_sent)}}})
                    next_bookmark = (time.monotonic() +
                                     self.bookmark_interval)
            finish()  # clean rotation: the client re-watches
        except OSError:
            pass  # client went away mid-stream

    # ---- collection scope (LIST + WATCH) ---------------------------------

    def _list(self, ns, query):
        """GET on the collection: a NodeFeatureList of every object in
        the namespace passing the labelSelector, stamped with the
        GLOBAL resourceVersion (what a collection watch resumes from)."""
        terms = parse_label_selector(
            query.get("labelSelector", [""])[0])
        with self.lock:
            items = [copy.deepcopy(obj) for (ons, _), obj in
                     sorted(self.store.items()) if ons == ns and
                     selector_matches(terms, obj)]
            rv = self.grv[0]
        return self._reply(200, {
            "apiVersion": "nfd.k8s-sigs.io/v1alpha1",
            "kind": "NodeFeatureList",
            "metadata": {"resourceVersion": str(rv)},
            "items": items,
        })

    def _watch_collection(self, ns, query):
        """GET ...nodefeatures?watch=true — ONE chunked stream carrying
        every object's events in global-resourceVersion order, filtered
        by the labelSelector, with BOOKMARKs carrying the global rv and
        ERROR 410 below the collection compaction floor."""
        try:
            timeout_s = float(query.get("timeoutSeconds", ["30"])[0])
        except ValueError:
            timeout_s = 30.0
        bookmarks = query.get("allowWatchBookmarks", ["false"])[0] == "true"
        start_rv = query.get("resourceVersion", [None])[0]
        terms = parse_label_selector(
            query.get("labelSelector", [""])[0])

        with self.lock:
            self.requests.append(("WATCH", self.path))
            self.timeline.append((time.monotonic(), "WATCH", 200))
            # Snapshot at REQUEST ARRIVAL (see _watch): a write racing
            # the header round-trip must still reach this stream.
            floor = self.collection_compacted.get(ns, 0)
            grv_at_request = self.grv[0]

        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()

        def emit(doc):
            data = json.dumps(doc, separators=(",", ":")).encode() + b"\n"
            self.wfile.write(b"%x\r\n" % len(data) + data + b"\r\n")
            self.wfile.flush()

        def finish():
            self.wfile.write(b"0\r\n\r\n")
            self.wfile.flush()

        if start_rv is not None:
            try:
                last_sent = int(start_rv)
            except ValueError:
                last_sent = 0
            if last_sent < floor:
                try:
                    emit({"type": "ERROR",
                          "object": {"kind": "Status", "code": 410,
                                     "message":
                                         "too old resource version"}})
                    finish()
                except OSError:
                    pass
                return
        else:
            last_sent = grv_at_request  # future events only

        deadline = time.monotonic() + timeout_s
        next_bookmark = time.monotonic() + self.bookmark_interval
        try:
            while not self.closing[0]:
                now = time.monotonic()
                if now >= deadline:
                    break
                pending = []
                with self.watch_cond:
                    history = self.collection_events.get(ns, [])
                    pending = [e for e in history if e[0] > last_sent]
                    if not pending:
                        self.watch_cond.wait(
                            timeout=min(0.1, max(0.0, deadline - now)))
                        history = self.collection_events.get(ns, [])
                        pending = [e for e in history if e[0] > last_sent]
                for grv, event_type, obj in pending:
                    if selector_matches(terms, obj):
                        emit({"type": event_type, "object": obj})
                    last_sent = grv
                if bookmarks and time.monotonic() >= next_bookmark:
                    emit({"type": "BOOKMARK",
                          "object": {"metadata":
                                     {"resourceVersion": str(last_sent)}}})
                    next_bookmark = (time.monotonic() +
                                     self.bookmark_interval)
            finish()  # clean rotation
        except OSError:
            pass

    # ---- verbs -----------------------------------------------------------

    def do_GET(self):  # noqa: N802
        if self._gate():
            return None
        path, query = self._split_path()
        if path.startswith(NODES_PREFIX + "/"):
            name = path[len(NODES_PREFIX) + 1:]
            with self.lock:
                node = self.nodes.get(name)
            if node is None:
                return self._reply(404, {"message": "not found"})
            return self._reply(200, node)
        ns, name = self._parse()
        if ns is None:
            return self._reply(404, {"message": "not found"})
        if name is None:
            # Collection scope: nodefeatures only (the coordination
            # ConfigMaps are always addressed by name).
            if not path.startswith(PREFIX):
                return self._reply(404, {"message": "not found"})
            if query.get("watch", ["false"])[0] == "true":
                return self._watch_collection(ns, query)
            return self._list(ns, query)
        if query.get("watch", ["false"])[0] == "true":
            return self._watch(ns, name, query)
        with self.lock:
            obj = self.store.get((ns, name))
        if obj is None:
            return self._reply(404, {"message": "not found"})
        return self._reply(200, obj)

    def do_POST(self):  # noqa: N802
        obj = self._body()  # consume before ANY reply (keep-alive framing)
        if self._gate():
            return None
        ns, name = self._parse()
        if ns is None or name is not None:
            return self._reply(404, {"message": "not found"})
        obj_name = obj.get("metadata", {}).get("name")
        with self.lock:
            if (ns, obj_name) in self.store:
                return self._reply(409, {"message": "already exists"})
            obj.setdefault("metadata", {})["resourceVersion"] = "1"
            self.store[(ns, obj_name)] = obj
            self._emit(ns, obj_name, "ADDED", obj)
        return self._reply(201, obj)

    def do_PUT(self):  # noqa: N802
        obj = self._body()  # consume before ANY reply (keep-alive framing)
        if self._gate():
            return None
        ns, name = self._parse()
        if ns is None or name is None:
            return self._reply(404, {"message": "not found"})
        with self.lock:
            existing = self.store.get((ns, name))
            if existing is None:
                return self._reply(404, {"message": "not found"})
            current_rv = existing["metadata"]["resourceVersion"]
            sent_rv = obj.get("metadata", {}).get("resourceVersion")
            if sent_rv != current_rv:
                return self._reply(409, {"message": "conflict"})
            obj["metadata"]["resourceVersion"] = str(int(current_rv) + 1)
            self.store[(ns, name)] = obj
            # A PUT replaces spec.labels wholesale: every field manager's
            # ownership is gone — the documented bottom-rung clobber.
            self.managers.pop((ns, name), None)
            self._emit(ns, name, "MODIFIED", obj)
        return self._reply(200, obj)

    def _do_apply(self, ns, name, patch):
        """Server-side apply (application/apply-patch+yaml; the daemon
        sends JSON, which is valid YAML). Per-field-manager ownership of
        spec.labels; metadata.labels merged (the NFD node-name
        attribution label)."""
        _, query = self._split_path()
        manager = query.get("fieldManager", ["unknown"])[0]
        force = query.get("force", ["false"])[0] == "true"
        applied = ((patch.get("spec") or {}).get("labels") or {})
        with self.lock:
            existing = self.store.get((ns, name))
            if existing is None:
                obj = copy.deepcopy(patch)
                obj.setdefault("metadata", {})["resourceVersion"] = "1"
                obj.setdefault("spec", {})["labels"] = dict(applied)
                self.store[(ns, name)] = obj
                self.managers[(ns, name)] = {manager: set(applied)}
                self._emit(ns, name, "ADDED", obj)
                return self._reply(201, obj)
            owned = self.managers.setdefault((ns, name), {})
            labels = existing.setdefault("spec", {}).setdefault("labels", {})
            if not force:
                for key in applied:
                    for other, keys in owned.items():
                        if other != manager and key in keys and \
                                labels.get(key) != applied[key]:
                            return self._reply(
                                409, {"message": f"conflict: field "
                                      f"{key} owned by {other}"})
            # No-op applies do not bump resourceVersion (real-apiserver
            # semantics): same labels for this manager's set, nothing to
            # prune, metadata already in place, ownership unchanged.
            meta_wanted = (patch.get("metadata") or {}).get("labels") or {}
            ann_wanted = (patch.get("metadata") or {}).get(
                "annotations") or {}
            previous_keys = owned.get(manager, set())
            foreign_owns_applied = any(
                other != manager and (keys & set(applied))
                for other, keys in owned.items())
            unchanged = (
                previous_keys == set(applied)
                and not foreign_owns_applied
                and all(labels.get(k) == v for k, v in applied.items())
                and all((existing.get("metadata", {}).get("labels") or {})
                        .get(k) == v for k, v in meta_wanted.items())
                and all((existing.get("metadata", {}).get("annotations")
                         or {}).get(k) == v
                        for k, v in ann_wanted.items()))
            if unchanged:
                return self._reply(200, copy.deepcopy(existing))
            previous = owned.get(manager, set())
            for key in previous - set(applied):
                labels.pop(key, None)
            for key, value in applied.items():
                labels[key] = value
                for other in owned:
                    if other != manager:
                        owned[other].discard(key)
            owned[manager] = set(applied)
            # Metadata labels (the node-name attribution) and
            # annotations (the change-id trace join key) merge in.
            meta_labels = (patch.get("metadata") or {}).get("labels") or {}
            if meta_labels:
                existing.setdefault("metadata", {}).setdefault(
                    "labels", {}).update(meta_labels)
            if ann_wanted:
                existing.setdefault("metadata", {}).setdefault(
                    "annotations", {}).update(ann_wanted)
            current_rv = existing["metadata"]["resourceVersion"]
            existing["metadata"]["resourceVersion"] = str(
                int(current_rv) + 1)
            self.store[(ns, name)] = existing
            self._emit(ns, name, "MODIFIED", existing)
            obj = copy.deepcopy(existing)
        return self._reply(200, obj)

    def do_PATCH(self):  # noqa: N802
        patch = self._body()  # consume before ANY reply (keep-alive framing)
        if self._gate():
            return None
        path, _ = self._split_path()
        if path.startswith(NODES_PREFIX + "/"):
            # Core /api/v1/nodes/<name> merge patch — the remediation
            # controller's cordon/uncordon verb (spec.unschedulable).
            # Same optimistic-concurrency contract as the CR store: a
            # metadata.resourceVersion in the patch is a PRECONDITION,
            # checked then stripped, and every successful patch bumps
            # the rv and fans out to parked watchers.
            content_type = (self.headers.get("Content-Type")
                            or "").split(";")[0].strip()
            if not self.patch_supported or content_type != MERGE_PATCH:
                return self._reply(
                    415, {"message": f"unsupported patch type "
                                     f"{content_type}"})
            node_name = path[len(NODES_PREFIX) + 1:]
            with self.lock:
                node = self.nodes.get(node_name)
                if node is None:
                    return self._reply(404, {"message": "not found"})
                current_rv = node["metadata"]["resourceVersion"]
                patch = copy.deepcopy(patch)
                sent_rv = (patch.get("metadata") or {}).pop(
                    "resourceVersion", None)
                if sent_rv is not None and sent_rv != current_rv:
                    return self._reply(409, {"message": "conflict"})
                if patch.get("metadata") == {}:
                    del patch["metadata"]
                merge_patch(node, patch)
                node["metadata"]["resourceVersion"] = str(
                    int(current_rv) + 1)
                self.nodes[node_name] = node
                history = self.node_events.setdefault(node_name, [])
                history.append((int(node["metadata"]["resourceVersion"]),
                                "MODIFIED", copy.deepcopy(node)))
                self.watch_cond.notify_all()
                obj = copy.deepcopy(node)
            return self._reply(200, obj)
        ns, name = self._parse()
        if ns is None or name is None:
            return self._reply(404, {"message": "not found"})
        content_type = (self.headers.get("Content-Type") or "").split(";")[0]
        content_type = content_type.strip()
        if content_type == APPLY_PATCH:
            if not self.apply_supported:
                return self._reply(
                    415, {"message": "server-side apply not supported"})
            return self._do_apply(ns, name, patch)
        if not self.patch_supported or content_type != MERGE_PATCH:
            return self._reply(
                415, {"message": f"unsupported patch type {content_type}"})
        with self.lock:
            existing = self.store.get((ns, name))
            if existing is None:
                return self._reply(404, {"message": "not found"})
            current_rv = existing["metadata"]["resourceVersion"]
            # metadata.resourceVersion in a merge patch is an
            # optimistic-concurrency PRECONDITION (as on a real
            # apiserver), never content: check it, then strip it so the
            # merge can't persist a stale version string.
            patch = copy.deepcopy(patch)
            sent_rv = (patch.get("metadata") or {}).pop(
                "resourceVersion", None)
            if sent_rv is not None and sent_rv != current_rv:
                return self._reply(409, {"message": "conflict"})
            if patch.get("metadata") == {}:
                del patch["metadata"]
            merge_patch(existing, patch)
            existing["metadata"]["resourceVersion"] = str(
                int(current_rv) + 1)
            self.store[(ns, name)] = existing
            self._emit(ns, name, "MODIFIED", existing)
            obj = copy.deepcopy(existing)
        return self._reply(200, obj)

    def do_DELETE(self):  # noqa: N802
        if self._gate():
            return None
        ns, name = self._parse()
        if ns is None or name is None:
            return self._reply(404, {"message": "not found"})
        with self.lock:
            existing = self.store.pop((ns, name), None)
            if existing is None:
                return self._reply(404, {"message": "not found"})
            self.managers.pop((ns, name), None)
            current_rv = existing["metadata"]["resourceVersion"]
            existing["metadata"]["resourceVersion"] = str(
                int(current_rv) + 1)
            self._emit(ns, name, "DELETED", existing)
        return self._reply(200, existing)

    def log_message(self, *args):
        pass


class FakeApiServer:
    def __init__(self, token=None, certfile=None, keyfile=None, port=0,
                 watch_history=WATCH_HISTORY,
                 collection_history=COLLECTION_HISTORY):
        # RLock: _reply logs the request under the lock, and the POST/PUT
        # error branches call _reply while already holding it for the
        # store — a plain Lock would deadlock every 409/404 reply.
        lock = threading.RLock()
        handler = type("Handler", (_Handler,), {
            "store": {}, "token": token, "lock": lock,
            "requests": [], "timeline": [], "failing": 0,
            "failing_retry_after": None, "failing_apf": False,
            "capacity": 0, "cap_bucket": [0, 0], "patch_supported": True,
            "apply_supported": True, "events": {}, "compacted": {},
            "managers": {}, "grv": [0], "collection_events": {},
            "collection_compacted": {}, "nodes": {}, "node_events": {},
            "watch_history": int(watch_history),
            "collection_history": int(collection_history),
            "watch_cond": threading.Condition(lock),
            "closing": [False]})
        self.store = handler.store
        self.requests = handler.requests
        self.timeline = handler.timeline
        self._handler = handler
        self._server = ThreadingHTTPServer(("127.0.0.1", port), handler)
        # Watch handler threads are daemonic and park on the condition;
        # they must not block interpreter shutdown.
        self._server.daemon_threads = True
        self.tls = certfile is not None
        if self.tls:
            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(certfile, keyfile)
            self._server.socket = ctx.wrap_socket(
                self._server.socket, server_side=True)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._handler.closing[0] = True
        with self._handler.watch_cond:
            self._handler.watch_cond.notify_all()
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=5)
        return False

    def set_failing(self, status=500, retry_after=None, apf=False):
        """Starts (status truthy) or stops (0/None) an injected outage:
        every subsequent CR request is answered with `status` and never
        touches the store. 5xx/429 are what the daemon treats as
        transient — it logs, stays alive, and retries next interval.
        `retry_after` (seconds) rides a Retry-After header, `apf` adds
        the X-Kubernetes-PF-* attribution headers — together they drive
        the daemon's adaptive backoff."""
        self._handler.failing = status or 0
        self._handler.failing_retry_after = retry_after
        self._handler.failing_apf = apf

    def set_capacity(self, per_second):
        """Caps CR requests per wall-clock second; the overflow answers
        429 + Retry-After: 1 with APF headers (0 = unlimited). The fleet
        soak's 429-storm phase uses this to prove the herd drains."""
        self._handler.capacity = per_second or 0

    def set_patch_supported(self, supported):
        """False: merge-PATCH answers 415 — exercises the client's
        GET+PUT fallback against an apiserver without merge-patch
        support."""
        self._handler.patch_supported = bool(supported)

    def set_apply_supported(self, supported):
        """False: application/apply-patch+yaml answers 415 — exercises
        the client's SSA -> merge-patch fallback rung."""
        self._handler.apply_supported = bool(supported)

    def set_bookmark_interval(self, seconds):
        """Watch-stream BOOKMARK cadence (default 0.5s — fast enough for
        tests to see resourceVersion progress without events)."""
        self._handler.bookmark_interval = float(seconds)

    def field_managers(self, ns, name):
        """Ownership snapshot: {manager: set(spec.labels keys)}."""
        with self._handler.lock:
            return {m: set(keys) for m, keys in
                    self._handler.managers.get((ns, name), {}).items()}

    def edit(self, ns, name, mutator):
        """External-drift injection: mutates the stored object (the
        `mutator` callable receives the object dict), bumps its
        resourceVersion, and emits a MODIFIED watch event — exactly what
        a foreign controller's write looks like to the daemon."""
        with self._handler.lock:
            obj = self.store[(ns, name)]
            mutator(obj)
            obj["metadata"]["resourceVersion"] = str(
                int(obj["metadata"]["resourceVersion"]) + 1)
            self._handler._emit(ns, name, "MODIFIED", obj)

    def delete(self, ns, name):
        """External-delete injection: removes the object and emits
        DELETED (the kubectl-delete drill)."""
        with self._handler.lock:
            obj = self.store.pop((ns, name), None)
            if obj is None:
                return
            self._handler.managers.pop((ns, name), None)
            obj["metadata"]["resourceVersion"] = str(
                int(obj["metadata"]["resourceVersion"]) + 1)
            self._handler._emit(ns, name, "DELETED", obj)

    def compact(self, ns, name):
        """Drops the retained watch history and raises the compaction
        floor to the object's current version: the next watch resuming
        from an older resourceVersion answers ERROR 410 (the re-list
        drill)."""
        with self._handler.lock:
            obj = self.store.get((ns, name))
            rv = int(obj["metadata"]["resourceVersion"]) if obj else 0
            history = self._handler.events.get((ns, name), [])
            if history:
                rv = max(rv, history[-1][0])
            self._handler.events[(ns, name)] = []
            self._handler.compacted[(ns, name)] = rv

    def seed(self, ns, name, labels, meta_labels=None, annotations=None):
        """Creates or replaces an object server-side (rv bump + watch
        event), exactly what a daemon's write looks like to a
        collection watcher — the aggregator soak seeds/churns its fleet
        through this without 200 real daemon processes. `annotations`
        rides metadata.annotations (the change-id / SLO channel a real
        daemon stamps next to its labels)."""
        with self._handler.lock:
            existing = self.store.get((ns, name))
            if existing is None:
                obj = {"apiVersion": "nfd.k8s-sigs.io/v1alpha1",
                       "kind": "NodeFeature",
                       "metadata": {"name": name, "namespace": ns,
                                    "resourceVersion": "1",
                                    "labels": dict(meta_labels or {}),
                                    "annotations": dict(annotations or {})},
                       "spec": {"labels": dict(labels)}}
                self.store[(ns, name)] = obj
                self._handler._emit(ns, name, "ADDED", obj)
            else:
                existing["spec"]["labels"] = dict(labels)
                if meta_labels:
                    existing.setdefault("metadata", {}).setdefault(
                        "labels", {}).update(meta_labels)
                if annotations:
                    existing.setdefault("metadata", {}).setdefault(
                        "annotations", {}).update(annotations)
                existing["metadata"]["resourceVersion"] = str(
                    int(existing["metadata"]["resourceVersion"]) + 1)
                self._handler._emit(ns, name, "MODIFIED", existing)

    def set_node(self, name, unschedulable=False, taints=None):
        """Creates/updates a /api/v1/nodes/<name> object — the lifecycle
        probe's draining input (spec.unschedulable + taints)."""
        with self._handler.lock:
            existing = self._handler.nodes.get(name)
            rv = "1" if existing is None else str(
                int(existing["metadata"]["resourceVersion"]) + 1)
            self._handler.nodes[name] = {
                "apiVersion": "v1", "kind": "Node",
                "metadata": {"name": name, "resourceVersion": rv},
                "spec": {"unschedulable": bool(unschedulable),
                         "taints": list(taints or [])},
            }

    def compact_collection(self, ns):
        """Raises the COLLECTION compaction floor to the current global
        resourceVersion: the next collection watch resuming from an
        older rv answers ERROR 410 (the aggregator's re-list drill)."""
        with self._handler.lock:
            self._handler.collection_events[ns] = []
            self._handler.collection_compacted[ns] = self._handler.grv[0]

    def add_listener(self, port=0):
        """A second loopback listener sharing THIS server's store and
        handler state. The multi-host slice soak gives each fake host
        its own listener so a single host can be network-partitioned
        (listener stopped → connection refused) while its peers keep
        talking to the same blackboard."""
        return _Listener(self._handler, port)

    @property
    def url(self):
        scheme = "https" if self.tls else "http"
        return f"{scheme}://127.0.0.1:{self.port}"


class _Listener:
    """One partitionable loopback port onto a FakeApiServer's store.
    stop() refuses connections (the network-partition injection);
    start() rebinds the SAME port (allow_reuse_address) to heal it."""

    def __init__(self, handler, port=0):
        self._handler = handler
        self._server = None
        self._thread = None
        self.port = port
        self.start()

    def start(self):
        if self._server is not None:
            return
        self._server = ThreadingHTTPServer(("127.0.0.1", self.port),
                                           self._handler)
        self._server.daemon_threads = True
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True)
        self._thread.start()

    def stop(self):
        if self._server is None:
            return
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=5)
        self._server = None
        self._thread = None

    @property
    def url(self):
        return f"http://127.0.0.1:{self.port}"
