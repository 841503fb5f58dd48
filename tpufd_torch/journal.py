"""Reads the daemon's flight recorder: the port's own copy of
``tpufd/journal.py``.

The daemon records probe lifecycle, rewrites, sink writes and label
diffs into a bounded ring, served as JSON on ``/debug/journal?n=&type=``
and written under the ``journal`` key of a SIGUSR1 dump.
``python -m tpufd_torch journal`` parses a document with
:func:`parse_journal` (same schema checks, same ``ValueError`` messages)
and prints it with :func:`dump_text` (same text). The event helpers read
a parsed run back:

  - :func:`merge_events` accumulates scrapes by the monotone ``seq``, so
    a wrapped ring never loses what an earlier scrape saw;
  - :func:`events_of_type` and the per-type readers
    (:func:`degradation_transitions`, :func:`fault_injections`,
    :func:`breaker_transitions`);
  - :func:`label_changes` / :func:`diffs_cover_changes`, the
    explainability invariant: every observed label change has a
    ``label-diff`` event carrying provenance;
  - :func:`labels_file_text`, a ``/debug/labels`` document rendered as
    the feature file.

The tests hold every function against its original.
"""

import datetime
import json

# Fields every label-diff event must carry for the diff to count as
# explained (the provenance half of the invariant).
PROVENANCE_FIELDS = ("labeler", "source", "tier")


def parse_journal(text):
    """Parses a /debug/journal (or SIGUSR1-dump ``journal``) document;
    raises ValueError when the schema is off."""
    doc = json.loads(text) if isinstance(text, (str, bytes)) else text
    for key in ("capacity", "dropped_total", "generation", "change",
                "events"):
        if key not in doc:
            raise ValueError(f"journal document missing {key!r}")
    if len(doc["events"]) > doc["capacity"]:
        raise ValueError("journal holds more events than its capacity "
                         f"({len(doc['events'])} > {doc['capacity']}) — "
                         "the ring is not bounded")
    for event in doc["events"]:
        for key in ("seq", "ts", "generation", "change", "type",
                    "fields"):
            if key not in event:
                raise ValueError(f"journal event missing {key!r}: {event}")
    return doc


def merge_events(accumulated, doc):
    """Folds a parsed journal document into ``accumulated`` ({seq:
    event}), deduplicating by seq; returns ``accumulated``."""
    for event in doc["events"]:
        accumulated[event["seq"]] = event
    return accumulated


def events_of_type(events, event_type):
    """Events (a seq->event dict or an event list) of one type, seq
    order."""
    if isinstance(events, dict):
        events = [events[seq] for seq in sorted(events)]
    return [e for e in events if e["type"] == event_type]


def label_changes(previous, current):
    """[(key, old, new)] between two label dicts (old/None = added,
    new/None = removed): the observer-side mirror of lm::DiffLabels."""
    out = []
    for key in sorted(set(previous) | set(current)):
        old, new = previous.get(key), current.get(key)
        if old != new:
            out.append((key, old, new))
    return out


def diffs_cover_changes(events, observed_changes):
    """The explainability invariant: every observed (key, old, new)
    change has a label-diff event for that key, and every label-diff
    event carries full provenance. Returns (ok, problems)."""
    problems = []
    diffs = events_of_type(events, "label-diff")
    keys_with_diffs = {e["fields"].get("key") for e in diffs}
    for key, old, new in observed_changes:
        if key not in keys_with_diffs:
            problems.append(f"change {key}: {old!r} -> {new!r} has no "
                            "label-diff event")
    for event in diffs:
        missing = [f for f in PROVENANCE_FIELDS
                   if not event["fields"].get(f)]
        if missing:
            problems.append(f"label-diff for {event['fields'].get('key')} "
                            f"lacks provenance fields {missing}")
    return not problems, problems


def _field_pairs(events, event_type, first, second):
    return [(e["fields"].get(first), e["fields"].get(second))
            for e in events_of_type(events, event_type)]


def degradation_transitions(events):
    """[(from, to)] from the journal's degradation events, seq order."""
    return _field_pairs(events, "degradation", "from", "to")


def fault_injections(events):
    """[(point, action)] from the journal's fault-injected events, seq
    order: which armed faults actually fired."""
    return _field_pairs(events, "fault-injected", "point", "action")


def breaker_transitions(events):
    """[(from, to)] from the sink circuit breaker's transition events,
    seq order (closed -> open -> half-open -> ...)."""
    return _field_pairs(events, "breaker-transition", "from", "to")


def labels_file_text(debug_labels):
    """Renders a /debug/labels document exactly as lm::FormatLabels
    writes the feature file (sorted ``key=value`` lines)."""
    doc = (json.loads(debug_labels)
           if isinstance(debug_labels, (str, bytes)) else debug_labels)
    labels = doc.get("labels", {})
    return "".join(f"{k}={labels[k]}\n" for k in sorted(labels))


def dump_text(doc):
    """Human-readable rendering of a parsed journal document (oldest
    first), one line per event plus its non-empty fields, sorted."""
    lines = [f"journal: {len(doc['events'])} events, capacity "
             f"{doc['capacity']}, dropped {doc['dropped_total']}, "
             f"generation {doc['generation']}"]
    for event in doc["events"]:
        stamp = datetime.datetime.fromtimestamp(
            event["ts"], tz=datetime.timezone.utc).strftime("%H:%M:%S.%f")
        source = f" [{event['source']}]" if event.get("source") else ""
        lines.append(f"  #{event['seq']} {stamp} g{event['generation']} "
                     f"{event['type']}{source}: "
                     f"{event.get('message', '')}")
        extras = {k: v for k, v in event["fields"].items() if v != ""}
        if extras:
            lines.append("      " + " ".join(
                f"{k}={v!r}" for k, v in sorted(extras.items())))
    return "\n".join(lines)
