"""Probe-plugin contract logic: the port's own copy of ``tpufd/plugin.py``,
the Python twin of ``src/tfd/plugin/``.

  - :func:`parse_handshake`    — the tfd.probe/v1 handshake validator
    (unknown contract versions rejected loudly, name/prefix rules)
  - :func:`parse_round_output` — probe-round validation: size cap,
    JSON schema, label budget, namespace enforcement, k8s key/value
    strictness; violations classified by the same kinds the daemon
    journals ("garbage", "oversize", "label-budget", "namespace",
    "invalid-key", "invalid-value", "schema")
  - :func:`parse_plugin_conf`  — the operator's "<file>.conf" stanza
  - :func:`effective_deadline_s` / :func:`effective_interval_s` — the
    hint trust rule (a plugin can make itself cheaper, never hotter)
  - :func:`plugin_violations`  — the daemon's journaled violations

``chip_smoke.py`` reads the port's run behind the in-tree
``device-health`` plugin back with them; tests/test_torch_plugin_contract.py
holds each against the reference.
"""

import json

CONTRACT_V1 = "tfd.probe/v1"
SOURCE_PREFIX = "plugin."
LABEL_DOMAIN = "google.com/"
MAX_HANDSHAKE_BYTES = 16 * 1024
MAX_ROUND_OUTPUT_BYTES = 256 * 1024

# tfd_plugin_state gauge encoding (plugin/plugin.h PluginState).
STATE_ACTIVE = 0
STATE_FAILING = 1
STATE_QUARANTINED = 2
STATE_REJECTED = 3


def _alnum(c):
    return c.isascii() and c.isalnum()


def valid_label_name(name):
    """The apiserver label-name rule for the part after "google.com/":
    alnum ends, [-._a-zA-Z0-9] middle, <= 63 chars."""
    if not name or len(name) > 63:
        return False
    if not _alnum(name[0]) or not _alnum(name[-1]):
        return False
    return all(_alnum(c) or c in "-._" for c in name)


def valid_plugin_name(name):
    """[a-z0-9-], alnum ends, 1..32 — names double as metric label
    values, source names, and journal keys."""
    if not name or len(name) > 32:
        return False
    low = set("abcdefghijklmnopqrstuvwxyz0123456789")
    if name[0] not in low or name[-1] not in low:
        return False
    return all(c in low or c == "-" for c in name)


def validate_label_prefix(prefix):
    """Returns an error string or None (C++ ValidateLabelPrefix)."""
    if not prefix.startswith(LABEL_DOMAIN):
        return f'label_prefix must start with "{LABEL_DOMAIN}"'
    name = prefix[len(LABEL_DOMAIN):]
    if len(name) < 2 or not name.endswith("."):
        return ("label_prefix must end with '.' and name a namespace "
                "(e.g. google.com/tpu.plugin.myprobe.)")
    if not valid_label_name(name + "x"):
        return "label_prefix is not a valid label-key prefix (chars or length)"
    return None


def strict_label_value(value):
    """tfd::StrictLabelValue: sanitize to [A-Za-z0-9._-] (spaces become
    dashes), cap at 63, trim non-alphanumeric ends. May return ""."""
    out = []
    for c in value:
        if _alnum(c) or c in "._-":
            out.append(c)
        elif c == " ":
            out.append("-")
    s = "".join(out)[:63]
    start, end = 0, len(s)
    while start < end and not _alnum(s[start]):
        start += 1
    while end > start and not _alnum(s[end - 1]):
        end -= 1
    return s[start:end]


def parse_handshake(text):
    """Returns (handshake_dict, None) or (None, error). The error
    strings match the rules (not the exact bytes) of the C++ side; an
    unknown contract version is its own loud, named error."""
    if len(text.encode("utf-8", "replace")) > MAX_HANDSHAKE_BYTES:
        return None, f"handshake larger than {MAX_HANDSHAKE_BYTES} bytes"
    try:
        doc = json.loads(text)
    except ValueError as e:
        return None, f"handshake is not valid JSON: {e}"
    if not isinstance(doc, dict):
        return None, "handshake is not a JSON object"
    contract = doc.get("contract")
    if contract != CONTRACT_V1:
        return None, (f"unknown contract version '{contract}' "
                      f"(this daemon speaks {CONTRACT_V1})")
    name = doc.get("name")
    if not isinstance(name, str) or not valid_plugin_name(name):
        return None, (f"invalid plugin name '{name}' "
                      "(want [a-z0-9-], alnum ends, 1..32 chars)")
    prefix = doc.get("label_prefix")
    if not isinstance(prefix, str):
        prefix = ""
    if err := validate_label_prefix(prefix):
        return None, err
    interval = doc.get("interval_s", 0)
    deadline = doc.get("deadline_s", 0)
    for hint in (interval, deadline):
        if not isinstance(hint, (int, float)) or not 0 <= hint <= 86400:
            return None, "interval_s/deadline_s hints must be in [0, 86400]"
    return {"contract": contract, "name": name, "label_prefix": prefix,
            "interval_s": int(interval), "deadline_s": int(deadline)}, None


def parse_round_output(text, handshake, label_budget):
    """Returns (labels, violations, round_ok). ``violations`` is a list
    of (kind, detail); ``round_ok`` False means the round was rejected
    WHOLE (garbage / oversize / label-budget) — per-key violations drop
    the key and keep the round. Mirrors C++ ParseRoundOutput."""
    violations = []
    if len(text.encode("utf-8", "replace")) > MAX_ROUND_OUTPUT_BYTES:
        violations.append(("oversize", f"{len(text)} bytes"))
        return {}, violations, False
    try:
        doc = json.loads(text)
        if not isinstance(doc, dict):
            raise ValueError("not a JSON object")
    except ValueError as e:
        violations.append(("garbage", str(e)))
        return {}, violations, False
    raw = doc.get("labels")
    if raw is None:
        return {}, violations, True  # facts-only round
    if not isinstance(raw, dict):
        violations.append(("schema", '"labels" is not an object'))
        return {}, violations, False
    # Budget runs on the RAW count, before per-key validation — padding
    # with droppable keys must not sneak a spammer under the budget.
    if label_budget and label_budget > 0 and len(raw) > label_budget:
        violations.append(
            ("label-budget", f"{len(raw)} labels (budget {label_budget})"))
        return {}, violations, False
    labels = {}
    prefix = handshake["label_prefix"]
    for key, value in raw.items():
        if not isinstance(value, str):
            violations.append(("schema", key))
            continue
        if not key.startswith(prefix):
            violations.append(("namespace", key))
            continue
        if (not valid_label_name(key[len(LABEL_DOMAIN):])
                or len(key) == len(prefix)):
            violations.append(("invalid-key", key))
            continue
        strict = strict_label_value(value)
        if not strict and value:
            violations.append(("invalid-value", key))
            continue
        labels[key] = strict
    return labels, violations, True


def _parse_duration_s(text):
    """Subset of config::ParseDurationSeconds: bare seconds, or
    h/m/s-suffixed components ("1m30s")."""
    text = text.strip()
    if text.isdigit():
        return int(text)
    total, num = 0, ""
    for c in text:
        if c.isdigit():
            num += c
        elif c in "hms" and num:
            total += int(num) * {"h": 3600, "m": 60, "s": 1}[c]
            num = ""
        else:
            return None
    return None if num else total


def parse_plugin_conf(text):
    """Returns (conf_dict, None) or (None, error) for a "<file>.conf"
    stanza: enabled / interval / deadline key=value lines."""
    conf = {"enabled": True, "interval_s": 0, "deadline_s": 0}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        if "=" not in line:
            return None, f"not key=value: '{line}'"
        key, _, value = line.partition("=")
        key, value = key.strip(), value.strip()
        if key == "enabled":
            if value.lower() in ("true", "1", "yes"):
                conf["enabled"] = True
            elif value.lower() in ("false", "0", "no"):
                conf["enabled"] = False
            else:
                return None, "enabled must be true/false"
        elif key in ("interval", "deadline"):
            seconds = _parse_duration_s(value)
            if seconds is None or seconds < 0:
                return None, f"{key}: not a duration: '{value}'"
            conf[key + "_s"] = seconds
        else:
            return None, f"unknown key '{key}'"
    return conf, None


def effective_deadline_s(handshake, conf, default_deadline_s):
    """The hint trust rule: conf (trusted) overrides the default; the
    handshake hint (untrusted) may only LOWER the kill budget."""
    base = conf.get("deadline_s") or default_deadline_s
    base = max(1, base)
    hint = handshake.get("deadline_s") or 0
    return hint if 0 < hint < base else base


def effective_interval_s(handshake, conf, default_interval_s):
    """The untrusted hint may only SLOW the cadence vs the daemon
    default; a trusted conf stanza overrides outright (it may quicken
    a plugin below its own hint)."""
    if conf.get("interval_s"):
        return conf["interval_s"]
    base = max(1, default_interval_s)
    return max(handshake.get("interval_s") or 0, base)


def plugin_violations(events):
    """[(plugin, kinds, round_rejected)] from journaled
    plugin-violation events (a journal event list, or the seq->event
    dict journal.merge_events accumulates)."""
    if isinstance(events, dict):
        events = [events[k] for k in sorted(events)]
    out = []
    for event in events:
        if event.get("type") != "plugin-violation":
            continue
        fields = event.get("fields", {})
        out.append((fields.get("plugin", ""),
                    tuple((fields.get("kinds") or "").split(",")),
                    fields.get("round_rejected") == "true"))
    return out
