"""The port's own copy of ``tpufd.sink`` (``tpufd/sink.py``), kept equal to
it and importing nothing of ``tpufd``.

Python twin of the fleet-scale NodeFeature diff sink.

Mirrors, constant for constant, the C++ pieces the cluster-in-a-box soak
needs to simulate a thousand daemons' apiserver behavior without running
a thousand daemon processes:

  - ``src/tfd/k8s/desync.h``: the deterministic hash-of-nodename cadence
    desynchronization (FNV-1a64 phase offset, per-tick jitter, refresh
    spread, Retry-After stretch). The parity tests pin both sides to the
    same golden numbers — if either drifts, the soak stops simulating
    the fleet the daemon actually schedules.
  - ``src/tfd/k8s/client.cc``: the diff-sink write flow (zero-GET
    resourceVersion-preconditioned JSON merge patch, 409 re-GET retry,
    404 create fallback, 415 full-update fallback) and the GET+full-PUT
    baseline it replaced.
  - ``src/tfd/k8s/breaker.h``: enough of the sink circuit breaker
    (consecutive-transient open, cooldown, and the server-directed
    Retry-After deferral) to prove a 429 storm drains without flapping.
"""

import json

FNV_OFFSET = 0xCBF29CE484222325
FNV_PRIME = 0x100000001B3
_MASK64 = (1 << 64) - 1
# Hash -> [0, 1), exactly as the C++: raw FNV-1a has no final avalanche
# (node names differing in the last digit barely move the hash), so the
# murmur3 fmix64 finalizer runs first and the unit comes from the
# exactly-double-representable low 53 bits.
_MASK53 = (1 << 53) - 1
_TWO53 = float(1 << 53)


def _fmix64(h):
    h ^= h >> 33
    h = (h * 0xFF51AFD7ED558CCD) & _MASK64
    h ^= h >> 33
    h = (h * 0xC4CEB9FE1A85EC53) & _MASK64
    h ^= h >> 33
    return h


def _unit(hash64):
    return (_fmix64(hash64) & _MASK53) / _TWO53

NODE_NAME_LABEL = "nfd.node.kubernetes.io/node-name"
MERGE_PATCH_CONTENT_TYPE = "application/merge-patch+json"
APPLY_PATCH_CONTENT_TYPE = "application/apply-patch+yaml"
APPLY_FIELD_MANAGER = "tfd"
# The causal change-id annotation key (obs/trace.h kChangeAnnotation):
# an ANNOTATION, never a spec.label, so scheduler eligibility is
# untouched while the CR stays joinable to the writer's /debug/trace.
CHANGE_ANNOTATION = "tfd.google.com/change-id"
# The stage-SLO sketch annotation key (obs/slo.h kSloAnnotation): the
# node's serialized windowed latency sketches, same annotation-not-label
# rule — latency digests must never become eligibility input.
SLO_ANNOTATION = "tfd.google.com/stage-slo"


# ---- desync math (k8s/desync.cc) -----------------------------------------

def fnv1a64(data):
    if isinstance(data, str):
        data = data.encode()
    h = FNV_OFFSET
    for byte in data:
        h = ((h ^ byte) * FNV_PRIME) & _MASK64
    return h


def hash_unit(key):
    """fnv1a64(key) mapped to [0, 1)."""
    return _unit(fnv1a64(key))


def jitter_unit(node, tick):
    """Deterministic per-(node, tick) value in [-1, 1)."""
    h = fnv1a64(node)
    for i in range(8):
        h = ((h ^ ((tick >> (8 * i)) & 0xFF)) * FNV_PRIME) & _MASK64
    return _unit(h) * 2.0 - 1.0


def jittered_interval_s(base_s, node, tick, jitter_pct):
    if jitter_pct <= 0 or base_s <= 0:
        return base_s
    return base_s * (1.0 + jitter_pct / 100.0 * jitter_unit(node, tick))


def phase_offset_s(base_s, node, jitter_pct):
    if jitter_pct <= 0 or base_s <= 0:
        return 0.0
    return hash_unit(node) * base_s


def refresh_period_s(base_s, node, jitter_pct):
    if jitter_pct <= 0 or base_s <= 0:
        return base_s
    u = hash_unit(node + "/anti-entropy")
    return base_s * (1.0 + jitter_pct / 100.0 * (2.0 * u - 1.0))


def spread_retry_after_s(retry_after_s, node):
    if retry_after_s <= 0:
        return 0.0
    return retry_after_s * (1.0 + 0.5 * hash_unit(node + "/retry-after"))


# ---- merge patch (k8s/client.cc BuildMergePatch) -------------------------

def build_merge_patch(acked, desired, node_name, fix_node_name,
                      resource_version, change_annotation="",
                      slo_annotation=""):
    """The JSON merge patch that turns `acked` into `desired`, as the
    C++ client serializes it (same key order: changed/added keys in
    sorted order, then removals). Returns None when there is nothing to
    patch, else the patch dict (json.dumps(..., separators=(",", ":"))
    reproduces the C++ byte stream for ASCII labels). A non-empty
    `change_annotation` (the causal change-id, obs/trace.h) and a
    non-empty `slo_annotation` (the serialized stage sketches,
    obs/slo.h) ride as metadata.annotations, change-id first —
    merge-patch semantics set just those keys, leaving foreign
    annotations alone."""
    spec = {}
    for key in sorted(desired):
        if acked.get(key) != desired[key]:
            spec[key] = desired[key]
    for key in sorted(acked):
        if key not in desired:
            spec[key] = None
    if not spec and not fix_node_name:
        return None
    patch = {}
    meta = {}
    if resource_version:
        meta["resourceVersion"] = resource_version
    if fix_node_name:
        meta["labels"] = {NODE_NAME_LABEL: node_name}
    annotations = {}
    if change_annotation:
        annotations[CHANGE_ANNOTATION] = change_annotation
    if slo_annotation:
        annotations[SLO_ANNOTATION] = slo_annotation
    if annotations:
        meta["annotations"] = annotations
    if meta:
        patch["metadata"] = meta
    patch["spec"] = {"labels": spec}
    return patch


# ---- watch events (k8s/watch.cc ParseWatchEventLine) ---------------------

WATCH_EVENT_TYPES = {
    "ADDED": "added",
    "MODIFIED": "modified",
    "DELETED": "deleted",
    "BOOKMARK": "bookmark",
    "ERROR": "error",
}


def parse_watch_event(line):
    """Twin of k8s::ParseWatchEventLine: one newline-delimited watch
    JSON document -> {type, resource_version, has_labels, labels,
    error_code}. Hostile input degrades to type 'unknown' (never
    raises); non-string spec.labels values read as absent — the same
    rules the C++ client applies, pinned by the parity grid in
    tests/test_fleet.py."""
    out = {"type": "unknown", "name": "", "resource_version": "",
           "change": "", "stage_slo": "", "has_labels": False,
           "labels": {}, "error_code": 0}
    try:
        doc = json.loads(line)
    except (ValueError, TypeError):
        return out
    if not isinstance(doc, dict):
        return out
    kind = doc.get("type")
    if kind not in WATCH_EVENT_TYPES:
        return out
    out["type"] = WATCH_EVENT_TYPES[kind]
    obj = doc.get("object")
    if not isinstance(obj, dict):
        return out
    rv = (obj.get("metadata") or {}).get("resourceVersion")
    if isinstance(rv, str):
        out["resource_version"] = rv
    # metadata.name: load-bearing at COLLECTION scope (the aggregator's
    # one stream carries every object); the per-object watcher ignores
    # it.
    name = (obj.get("metadata") or {}).get("name")
    if isinstance(name, str):
        out["name"] = name
    annotations = (obj.get("metadata") or {}).get("annotations")
    if isinstance(annotations, dict):
        change = annotations.get(CHANGE_ANNOTATION)
        if isinstance(change, str):
            out["change"] = change
        slo = annotations.get(SLO_ANNOTATION)
        if isinstance(slo, str):
            out["stage_slo"] = slo
    if out["type"] == "error":
        code = obj.get("code")
        if isinstance(code, (int, float)):
            out["error_code"] = int(code)
        return out
    labels = (obj.get("spec") or {}).get("labels")
    if isinstance(labels, dict):
        out["has_labels"] = True
        out["labels"] = {k: v for k, v in labels.items()
                         if isinstance(v, str)}
    return out


def build_apply_body(namespace, node, labels, change_annotation="",
                     slo_annotation=""):
    """The server-side-apply body (k8s/client.cc CrBody): the FULL
    desired object — JSON is valid YAML, which is why the wire
    content-type can be application/apply-patch+yaml. A non-empty
    `change_annotation` rides as the CHANGE_ANNOTATION metadata
    annotation (the causal-trace join key), a non-empty
    `slo_annotation` as SLO_ANNOTATION (the stage sketches)."""
    return _full_body(namespace, node, labels, change_annotation,
                      slo_annotation)


# ---- circuit breaker twin (k8s/breaker.{h,cc}) ---------------------------

class Breaker:
    """State machine twin: closed -> open after `open_after` consecutive
    transient failures, half-open probe after `cooldown_s`, plus the
    server-directed `defer()` that outranks every state. Clock injected
    so the soak can use a shared monotonic base."""

    CLOSED, HALF_OPEN, OPEN = "closed", "half-open", "open"

    def __init__(self, open_after=3, cooldown_s=30.0):
        self.open_after = open_after
        self.cooldown_s = cooldown_s
        self.state = self.CLOSED
        self.consecutive_failures = 0
        self.probe_in_flight = False
        self.open_until = 0.0
        self.defer_until = 0.0
        self.transitions = []  # (from, to) — flap evidence

    def _transition(self, to):
        if self.state != to:
            self.transitions.append((self.state, to))
            self.state = to

    def allow(self, now):
        if now < self.defer_until:
            return False
        if self.state == self.CLOSED:
            return True
        if self.state == self.HALF_OPEN:
            if self.probe_in_flight:
                return False
            self.probe_in_flight = True
            return True
        if now < self.open_until:
            return False
        self._transition(self.HALF_OPEN)
        self.probe_in_flight = True
        return True

    def defer(self, seconds, now):
        # Like the C++: a deferred write settles an in-flight half-open
        # probe without a verdict — release the slot so the next
        # allow() after the pause can probe again.
        self.probe_in_flight = False
        if seconds > 0:
            self.defer_until = max(self.defer_until, now + seconds)

    def record_success(self):
        self.consecutive_failures = 0
        self.probe_in_flight = False
        self._transition(self.CLOSED)

    def record_transient_failure(self, now):
        self.consecutive_failures += 1
        self.probe_in_flight = False
        if self.state == self.HALF_OPEN or (
                self.state == self.CLOSED and
                self.consecutive_failures >= self.open_after):
            self.open_until = now + self.cooldown_s
            self._transition(self.OPEN)

    def opens(self):
        return sum(1 for _, to in self.transitions if to == self.OPEN)


# ---- sink write flows (k8s/client.cc UpdateNodeFeature) ------------------

class WriteOutcome:
    def __init__(self):
        self.gets = 0
        self.posts = 0
        self.puts = 0
        self.patches = 0   # merge patches AND applies (both PATCH verbs)
        self.applies = 0   # the server-side-apply subset
        self.patch_bytes = 0
        self.retry_after_s = 0.0
        self.ok = False
        self.transient = False
        self.error = ""


def _cr_path(namespace, name=None):
    base = (f"/apis/nfd.k8s-sigs.io/v1alpha1/namespaces/{namespace}"
            f"/nodefeatures")
    return f"{base}/{name}" if name else base


def _cr_name(node):
    return f"tfd-features-for-{node}"


def _full_body(namespace, node, labels, change_annotation="",
               slo_annotation=""):
    metadata = {
        "name": _cr_name(node),
        "namespace": namespace,
        "labels": {NODE_NAME_LABEL: node},
    }
    annotations = {}
    if change_annotation:
        annotations[CHANGE_ANNOTATION] = change_annotation
    if slo_annotation:
        annotations[SLO_ANNOTATION] = slo_annotation
    if annotations:
        metadata["annotations"] = annotations
    return {
        "apiVersion": "nfd.k8s-sigs.io/v1alpha1",
        "kind": "NodeFeature",
        "metadata": metadata,
        "spec": {"labels": dict(labels)},
    }


class DiffSink:
    """One daemon's CR sink state machine: the C++ client's diff flow
    over an injected `request` callable

        request(method, path, body_dict_or_None, headers) ->
            (status, headers_dict, body_dict_or_None)

    so the soak can drive it through a pooled keep-alive connection and
    tests through anything scriptable."""

    MAX_ATTEMPTS = 3

    def __init__(self, node, namespace="default", use_patch=True):
        self.node = node
        self.namespace = namespace
        self.use_patch = use_patch
        self.known = False
        self.patch_unsupported = False
        self.resource_version = ""
        self.acked = {}

    def invalidate(self):
        self.known = False
        self.resource_version = ""
        self.acked = {}

    def _learn(self, body, labels):
        self.known = True
        self.acked = dict(labels)
        self.resource_version = (body or {}).get(
            "metadata", {}).get("resourceVersion", "") or ""

    def _note_throttle(self, status, headers, outcome):
        if status in (429, 503):
            try:
                retry_after = float((headers or {}).get("Retry-After", 0))
            except ValueError:
                retry_after = 0.0
            outcome.retry_after_s = max(outcome.retry_after_s, retry_after)

    def write(self, request, labels, outcome=None):
        """Mirrors UpdateNodeFeature: returns the WriteOutcome."""
        out = outcome or WriteOutcome()
        named = _cr_path(self.namespace, _cr_name(self.node))
        patching = self.use_patch and not self.patch_unsupported

        def fail(transient, error):
            out.ok = False
            out.transient = transient
            out.error = error
            return out

        def try_patch(patch):
            """Returns 'done', 'retry'."""
            body = json.dumps(patch, separators=(",", ":"))
            out.patches += 1
            out.patch_bytes += len(body)
            status, headers, resp = request(
                "PATCH", named, patch,
                {"Content-Type": MERGE_PATCH_CONTENT_TYPE})
            self._note_throttle(status, headers, out)
            if status == 200:
                self._learn(resp, labels)
                out.ok = True
                return "done"
            if status == 404:
                self.invalidate()
                return "retry"
            if status == 409:
                self.invalidate()
                return "retry"
            if status in (405, 415):
                self.patch_unsupported = True
                return "retry"
            fail(status == 429 or status >= 500, f"PATCH HTTP {status}")
            return "done"

        for _ in range(self.MAX_ATTEMPTS):
            patching = self.use_patch and not self.patch_unsupported
            if self.known and patching:
                patch = build_merge_patch(
                    self.acked, labels, self.node, False,
                    self.resource_version)
                # An empty diff does NOT no-op locally (C++ parity):
                # callers skip clean passes upstream, so a write call
                # with nothing to patch owes a real server interaction
                # and falls through to the semantic-equality GET.
                if patch is not None:
                    if try_patch(patch) == "done":
                        return out
                    continue

            out.gets += 1
            status, headers, cr = request("GET", named, None, {})
            self._note_throttle(status, headers, out)
            if status == 404:
                out.posts += 1
                status, headers, resp = request(
                    "POST", _cr_path(self.namespace),
                    _full_body(self.namespace, self.node, labels),
                    {"Content-Type": "application/json"})
                self._note_throttle(status, headers, out)
                if status == 409:
                    continue
                if status not in (200, 201):
                    return fail(status == 429 or status >= 500,
                                f"POST HTTP {status}")
                self._learn(resp, labels)
                out.ok = True
                return out
            if status != 200:
                return fail(status == 429 or status >= 500,
                            f"GET HTTP {status}")

            rv = (cr.get("metadata") or {}).get("resourceVersion", "")
            raw_labels = (cr.get("spec") or {}).get("labels", {}) or {}
            current = {k: v for k, v in raw_labels.items()
                       if isinstance(v, str)}
            node_ok = ((cr.get("metadata") or {}).get("labels") or {}).get(
                NODE_NAME_LABEL) == self.node
            # The raw-count guard mirrors the C++: a foreign NON-STRING
            # spec.labels value is invisible to the string-map compare
            # but must still dirty the write (healed by the wholesale
            # PUT below, which replaces spec.labels like the reference).
            if (node_ok and current == dict(labels)
                    and len(raw_labels) == len(current)):
                self.known = True
                self.acked = current
                self.resource_version = rv
                out.ok = True
                return out

            if patching:
                patch = build_merge_patch(current, labels, self.node,
                                          not node_ok, rv)
                if patch is not None:
                    if try_patch(patch) == "done":
                        return out
                    continue
                # Empty diff but not equal: non-string junk only the
                # full-replace PUT can heal — fall through.

            # Full-update fallback: mutate the fetched object (foreign
            # metadata survives), rv precondition rides along.
            cr.setdefault("metadata", {}).setdefault("labels", {})[
                NODE_NAME_LABEL] = self.node
            cr.setdefault("spec", {})["labels"] = dict(labels)
            out.puts += 1
            status, headers, resp = request(
                "PUT", named, cr, {"Content-Type": "application/json"})
            self._note_throttle(status, headers, out)
            if status == 409:
                self.invalidate()
                continue
            if status != 200:
                return fail(status == 429 or status >= 500,
                            f"PUT HTTP {status}")
            self._learn(resp, labels)
            out.ok = True
            return out
        return fail(True, "attempts exhausted")


class ApplySink(DiffSink):
    """The server-side-apply sink (k8s/client.cc with use_apply): every
    write is ONE self-contained PATCH of the full desired object under
    the 'tfd' field manager — no GET, no cached diff state needed, the
    CR created if missing, and spec.labels keys owned by OTHER field
    managers preserved by the server. The per-process fallback ladder
    mirrors the C++: a 415/405 on the apply demotes to the DiffSink
    merge-patch flow (then GET+PUT under it) for the rest of the
    process."""

    def __init__(self, node, namespace="default", use_patch=True):
        super().__init__(node, namespace, use_patch)
        self.apply_unsupported = False

    def write(self, request, labels, outcome=None):
        out = outcome or WriteOutcome()
        named = _cr_path(self.namespace, _cr_name(self.node))
        for _ in range(self.MAX_ATTEMPTS):
            if self.apply_unsupported:
                return super().write(request, labels, out)
            body = build_apply_body(self.namespace, self.node, labels)
            out.patches += 1
            out.applies += 1
            out.patch_bytes += len(json.dumps(body, separators=(",", ":")))
            status, headers, resp = request(
                "PATCH",
                named + f"?fieldManager={APPLY_FIELD_MANAGER}&force=true",
                body, {"Content-Type": APPLY_PATCH_CONTENT_TYPE})
            self._note_throttle(status, headers, out)
            if status in (200, 201):
                self._learn(resp, labels)
                out.ok = True
                return out
            if status in (405, 415):
                self.apply_unsupported = True  # remembered per process
                continue
            if status == 409:
                self.invalidate()
                continue
            out.ok = False
            out.transient = status == 429 or status >= 500
            out.error = f"APPLY HTTP {status}"
            return out
        out.ok = False
        out.transient = True
        out.error = "attempts exhausted"
        return out


class BaselineSink(DiffSink):
    """The pre-diff reference behavior the soak baselines against:
    GET -> compare -> full PUT on every write, nothing remembered, no
    fast path (the per-node per-interval apiserver load the tentpole
    exists to remove)."""

    def __init__(self, node, namespace="default"):
        super().__init__(node, namespace, use_patch=False)

    def write(self, request, labels, outcome=None):
        self.invalidate()  # never reuse state: every write re-GETs
        return super().write(request, labels, outcome)
