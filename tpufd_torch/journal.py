"""Reads the daemon's flight recorder: the port's own copy of
``parse_journal`` and ``dump_text`` from ``tpufd/journal.py``.

The daemon records probe lifecycle, rewrites, sink writes and label
diffs into a bounded ring, served as JSON on ``/debug/journal?n=&type=``
and written under the ``journal`` key of a SIGUSR1 dump.
``python -m tpufd_torch journal`` parses a document with
:func:`parse_journal` (same schema checks, same ``ValueError`` messages)
and prints it with :func:`dump_text` (same text). The tests hold both
against the originals.
"""

import datetime
import json


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
