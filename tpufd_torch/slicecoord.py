"""The port's own copy of ``tpufd.slicecoord`` (``tpufd/slicecoord.py``),
kept equal to it and importing nothing of ``tpufd``.

Python twin of the slice-coherence pure logic (src/tfd/slice/coord.*).

Mirrors, parity-pinned by tests/test_slice.py against the C++ unit
grid (change one side, change both):
  - derive_slice_identity: the deterministic slice-id derivation
  - sanitize_slice_id:     the k8s-name-safe id (incl. the FNV suffix)
  - lease_expired:         the lease freshness rule
  - merge_verdict:         the leader's report merge (+ successor line)
  - build_slice_labels:    the published tpu.slice.* label set
  - serialize_report / serialize_verdict: the blackboard document BYTES
    (incl. the addr/relayed_by/successors fields, emitted only
    when set so pre-relay documents are unchanged)
  - succession_due / first_successor: the pre-declared lease-succession
    eligibility rule (missed-renewal detection + promotion order)

The soak (scripts/slice_soak.py) uses these to independently recompute
what the daemons SHOULD agree on, and the journal/label helpers to
assert they did.
"""

from tpufd_torch.sink import fnv1a64

PREFIX = "google.com/"
SLICE_ID = PREFIX + "tpu.slice.id"
SLICE_HOSTS = PREFIX + "tpu.slice.hosts"
SLICE_HEALTHY_HOSTS = PREFIX + "tpu.slice.healthy-hosts"
SLICE_DEGRADED = PREFIX + "tpu.slice.degraded"
SLICE_CLASS = PREFIX + "tpu.slice.class"
SLICE_KEYS = (SLICE_ID, SLICE_HOSTS, SLICE_HEALTHY_HOSTS, SLICE_DEGRADED,
              SLICE_CLASS)

# perf.h kRankGold..kRankDegraded order: larger = worse.
CLASS_RANKS = {"gold": 0, "silver": 1, "degraded": 2}
RANK_NAMES = {v: k for k, v in CLASS_RANKS.items()}


def sanitize_slice_id(raw):
    """C++ SanitizeSliceId: lowercase [a-z0-9-], runs collapsed, 32-char
    cap, 8-hex FNV-1a suffix over the RAW name."""
    safe = []
    last_dash = True
    for c in raw.lower():
        if c.isascii() and (c.isdigit() or "a" <= c <= "z"):
            safe.append(c)
            last_dash = False
        elif not last_dash:
            safe.append("-")
            last_dash = True
    out = "".join(safe).rstrip("-")[:32]
    # 016x matches C++ HexU64's zero-padding (the last-8 slice must
    # agree even for small hashes).
    suffix = format(fnv1a64(raw.encode()), "016x")[-8:]
    return f"{out}-{suffix}" if out else suffix


def _bounds_product(text):
    if not text:
        return 0
    product = 1
    for part in text.split(","):
        part = part.strip()
        if not part.isdigit() or int(part) <= 0:
            return 0
        product *= int(part)
    return product


def derive_slice_identity(tpu_env, accelerator_type="", env=None,
                          family_chips_per_host=None):
    """Returns a dict {valid, slice_id, raw_name, worker_id, num_hosts,
    source}. `family_chips_per_host` maps accelerator-type prefix to
    max chips per host for the family-table fallback (the C++ side uses
    slice/topology.h); pass e.g. {"v5litepod": 8, "v5p": 4}."""
    env = env or {}
    tpu_env = tpu_env or {}

    def get(m, key):
        return (m.get(key) or "").strip()

    worker = (get(env, "TFD_SLICE_WORKER_ID") or get(tpu_env, "WORKER_ID")
              or get(env, "TPU_WORKER_ID"))
    worker_id = int(worker) if worker.isdigit() else -1

    hosts = 0
    hosts_env = get(env, "TFD_SLICE_HOSTS")
    if hosts_env.isdigit():
        hosts = int(hosts_env)
    if hosts <= 0:
        hosts = _bounds_product(get(tpu_env, "HOST_BOUNDS"))
    if hosts <= 0:
        accel = get(tpu_env, "ACCELERATOR_TYPE") or accelerator_type.strip()
        if accel and "-" in accel:
            prefix, _, count = accel.rpartition("-")
            if count.isdigit():
                n = int(count)
                # v2/v3/v4/v5p accelerator types count TensorCores
                # (2 per chip); v5e/v6e count chips (topology.h
                # type_counts_cores).
                chips = n // 2 if prefix in ("v2", "v3", "v4",
                                             "v5p") else n
                per_host = _bounds_product(
                    get(tpu_env, "CHIPS_PER_HOST_BOUNDS"))
                if per_host <= 0 and family_chips_per_host:
                    per_host = family_chips_per_host.get(prefix, 0)
                if per_host > 0 and chips > 0:
                    hosts = -(-chips // per_host)

    name = get(env, "TFD_SLICE_ID")
    source = "env"
    if not name:
        name = get(tpu_env, "TPU_NAME") or get(tpu_env, "NODE_ID")
        source = "tpu-env"
    if not name:
        hostnames = get(env, "TPU_WORKER_HOSTNAMES")
        if hostnames:
            name = "gke-" + format(fnv1a64(hostnames.encode()), "016x")
            source = "gke-env"
    if not name:
        return {"valid": False, "slice_id": "", "raw_name": "",
                "worker_id": worker_id, "num_hosts": hosts, "source": ""}
    megascale = (get(tpu_env, "MEGASCALE_SLICE_ID")
                 or get(env, "MEGASCALE_SLICE_ID"))
    if megascale:
        name += "-s" + megascale
    valid = hosts >= 2 and 0 <= worker_id < hosts
    return {"valid": valid, "slice_id": sanitize_slice_id(name),
            "raw_name": name, "worker_id": worker_id,
            "num_hosts": hosts, "source": source}


def lease_expired(lease, now):
    """lease: {holder, epoch, renewed_at, duration_s}."""
    if not lease or not lease.get("holder") or lease.get(
            "duration_s", 0) <= 0:
        return True
    return now - lease.get("renewed_at", 0) > lease["duration_s"]


def renew_cadence(lease_duration_s, renew_cadence_s=0):
    """C++ Tick parity: the holder renews every slice tick; 0 falls
    back to lease_duration/3 (integer division, floor 1)."""
    if renew_cadence_s > 0:
        return renew_cadence_s
    return max(1, lease_duration_s // 3)


def succession_due(lease, now, renew_cadence_s=0):
    """The missed-renewal predicate (--slice-succession): the
    lease is NOT yet expired, but the holder has missed ~1.5 renewal
    ticks — the pre-declared first successor may promote now instead of
    waiting out the rest of the lease. Expired leases take the ordinary
    acquisition path, never this one."""
    if lease_expired(lease, now):
        return False
    cadence = renew_cadence(lease["duration_s"], renew_cadence_s)
    missed_after = cadence + max(1, cadence // 2)
    return now - lease.get("renewed_at", 0) > missed_after


def first_successor(successors, holder, reports, agreement_timeout_s,
                    now):
    """The promotion order: the FIRST-listed successor (the stored
    verdict's sorted list) that is not the absent holder and still has
    a fresh report. Returns "" when nobody qualifies (expiry is the
    backstop)."""
    fresh = {r["host"] for r in reports
             if r.get("at", 0) > 0 and now - r["at"] <= agreement_timeout_s}
    for cand in successors:
        if cand == holder:
            continue
        if cand in fresh:
            return cand
    return ""


def json_quote(s):
    """jsonlite::Quote parity: the exact escape set the C++ writer
    uses (no \\uXXXX for printable non-ASCII)."""
    out = ['"']
    for ch in s.encode("utf-8"):
        c = chr(ch)
        if c == '"':
            out.append('\\"')
        elif c == "\\":
            out.append("\\\\")
        elif c == "\b":
            out.append("\\b")
        elif c == "\f":
            out.append("\\f")
        elif c == "\n":
            out.append("\\n")
        elif c == "\r":
            out.append("\\r")
        elif c == "\t":
            out.append("\\t")
        elif ch < 0x20:
            out.append(f"\\u{ch:04x}")
        else:
            out.append(c)
    return "".join(out) + '"'


def serialize_report(report):
    """C++ SerializeReport byte mirror. report: {host, worker, healthy,
    preempting, shape, class, addr?, relayed_by?, at}. addr/relayed_by
    are emitted only when set, so a pre-relay report's bytes are
    unchanged."""
    addr = report.get("addr") or ""
    relayed_by = report.get("relayed_by") or ""
    return ("{\"host\":" + json_quote(report["host"]) +
            ",\"worker\":" + str(report.get("worker", -1)) +
            ",\"healthy\":" + ("true" if report.get("healthy") else
                               "false") +
            ",\"preempting\":" + ("true" if report.get("preempting") else
                                  "false") +
            ",\"shape\":" + json_quote(report.get("shape", "")) +
            ",\"class\":" + json_quote(report.get("class", "")) +
            ("" if not addr else ",\"addr\":" + json_quote(addr)) +
            ("" if not relayed_by
             else ",\"relayed_by\":" + json_quote(relayed_by)) +
            ",\"at\":" + f"{report.get('at', 0):.3f}" + "}")


def serialize_verdict(verdict):
    """C++ SerializeVerdict byte mirror. verdict: {seq, leader, change?,
    computed_at, hosts, healthy_hosts, degraded, class, members,
    successors?}. change and successors are emitted only when set, so
    pre-trace / pre-succession documents are unchanged."""
    members = ",".join(json_quote(m) for m in verdict.get("members", []))
    successors = ",".join(
        json_quote(m) for m in verdict.get("successors", []))
    change = int(verdict.get("change", 0) or 0)
    return ("{\"seq\":" + str(verdict.get("seq", 0)) +
            ",\"leader\":" + json_quote(verdict.get("leader", "")) +
            ("" if change == 0 else ",\"change\":" + str(change)) +
            ",\"computed_at\":" + f"{verdict.get('computed_at', 0):.3f}" +
            ",\"hosts\":" + str(verdict["hosts"]) +
            ",\"healthy_hosts\":" + str(verdict.get("healthy_hosts", 0)) +
            ",\"degraded\":" + ("true" if verdict.get("degraded") else
                                "false") +
            ",\"class\":" + json_quote(verdict.get("class", "")) +
            ",\"members\":[" + members + "]" +
            ("" if not successors
             else ",\"successors\":[" + successors + "]") +
            "}")


def merge_verdict(num_hosts, reports, agreement_timeout_s, now,
                  departed_at=None, rejoin_dwell_s=0, leader=""):
    """The leader's merge: reports = [{host, healthy, at, class?,
    preempting?}]. Present = heard from within the agreement window; a
    stale/missing member degrades the slice. A PREEMPTING member (the
    lifecycle fast path's verdict: alive but about to vanish) counts as
    a member but never healthy — the slice degrades proactively, before
    the host dies. Rejoin hysteresis (C++ MergeVerdict parity): a
    present healthy host whose ``departed_at[host]`` is younger than
    ``rejoin_dwell_s`` counts as a member but NOT healthy — a
    crash-looper cannot flap healthy-hosts once per restart.
    Returns {hosts, healthy_hosts, degraded, class, members, dwelling,
    successors}; successors (pre-declared succession) is every
    healthy present member except ``leader``, sorted — deterministic
    from the facts alone, so every member computes the same line of
    succession."""
    departed_at = departed_at or {}
    members = set()
    healthy = 0
    worst = -1
    dwelling = []
    successors = []
    for report in reports:
        at = report.get("at", 0)
        if at <= 0 or now - at > agreement_timeout_s:
            continue
        if report["host"] in members:
            continue
        members.add(report["host"])
        is_healthy = bool(report.get("healthy"))
        if report.get("preempting"):
            is_healthy = False
        if (is_healthy and rejoin_dwell_s > 0
                and report["host"] in departed_at
                and now - departed_at[report["host"]] < rejoin_dwell_s):
            is_healthy = False
            dwelling.append(report["host"])
        if is_healthy:
            healthy += 1
            if report["host"] != leader:
                successors.append(report["host"])
        rank = CLASS_RANKS.get(report.get("class") or "", -1)
        worst = max(worst, rank)
    return {
        "hosts": num_hosts,
        "healthy_hosts": healthy,
        "degraded": healthy < num_hosts,
        "class": RANK_NAMES.get(worst, ""),
        "members": sorted(members),
        "dwelling": sorted(dwelling),
        "successors": sorted(successors),
    }


def verdict_change(verdict_doc):
    """The causal change-id a serialized verdict doc echoes (the C++
    SerializeVerdict's optional ``change`` field, minted by the leader
    via obs/trace.h when the verdict content moved; 0 = none recorded —
    pre-trace docs parse as 0, exactly like the C++ ParseVerdict)."""
    try:
        return int(verdict_doc.get("change", 0))
    except (TypeError, ValueError, AttributeError):
        return 0


def build_slice_labels(slice_id, verdict):
    """The published tpu.slice.* set for one verdict — deterministic
    from the verdict fields alone (leader/seq never move a byte)."""
    labels = {
        SLICE_ID: slice_id,
        SLICE_HOSTS: str(verdict["hosts"]),
        SLICE_HEALTHY_HOSTS: str(verdict["healthy_hosts"]),
        SLICE_DEGRADED: "true" if verdict["degraded"] else "false",
    }
    if verdict.get("class"):
        labels[SLICE_CLASS] = verdict["class"]
    return labels


def slice_labels_of(labels):
    """The tpu.slice.* subset of a parsed label dict (the soak's
    byte-compare unit)."""
    return {k: v for k, v in labels.items() if k in SLICE_KEYS}
