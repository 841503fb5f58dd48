"""Metrics registry + Prometheus text exposition (stdlib only).

The port's own copy of ``tpufd/metrics.py``. The producing half: the
same three instruments (counter / gauge / histogram), the same text
format (one ``# HELP``/``# TYPE`` block per family, escaped label
values, cumulative histogram buckets ending in ``+Inf``) and the same
registration-order output. Probe timings from ``tpufd_torch.health``
land here and ``python -m tpufd_torch health --metrics-out PATH`` writes
them as a node-exporter textfile. The reading half:
:func:`parse_samples_ex` / :func:`parse_samples` / :func:`sample_value`
read such a file back, and :func:`validate_exposition` checks it against
the text-format rules. The tests hold both halves against the original.
"""

import math
import os
import re
import threading

_NAME_RE = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*$")

# Sized for probe work: milliseconds (CPU test probes) up to the
# multi-minute measured-silicon runs (health.py's median-of-3 probes).
DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 2.5, 5.0,
                   10.0, 30.0, 60.0, 120.0, 300.0)


def _sanitize_name(name, label=False):
    """Coerces a name into the Prometheus grammar (invalid chars -> '_'),
    mirroring the C++ registry: exposition stays valid for any input."""
    out = re.sub(r"[^a-zA-Z0-9_:]", "_", str(name)) or "_"
    if out[0].isdigit():
        out = "_" + out
    if label:
        out = out.replace(":", "_")
    return out


def _escape_label_value(value):
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _escape_help(text):
    return str(text).replace("\\", "\\\\").replace("\n", "\\n")


def _format_value(value):
    value = float(value)
    if math.isnan(value):
        return "NaN"
    if math.isinf(value):
        return "+Inf" if value > 0 else "-Inf"
    if value == int(value) and abs(value) < 1e15:
        return str(int(value))
    return repr(value)


class Counter:
    def __init__(self):
        self._value = 0.0

    def inc(self, v=1.0):
        if v > 0:  # counters only go up; NaN/negative dropped
            self._value += v

    @property
    def value(self):
        return self._value


class Gauge:
    def __init__(self):
        self._value = 0.0

    def set(self, v):
        self._value = float(v)

    @property
    def value(self):
        return self._value


class Histogram:
    def __init__(self, buckets=DEFAULT_BUCKETS):
        bounds = sorted({float(b) for b in buckets if math.isfinite(b)})
        self.bounds = bounds
        self.counts = [0] * len(bounds)
        self.overflow = 0
        self.sum = 0.0
        self.count = 0
        # Last exemplar per bucket (trailing slot = +Inf): (labels, v)
        # — mirrors the C++ Histogram's exemplar store.
        self.exemplars = [None] * (len(bounds) + 1)

    def observe(self, v, exemplar=None):
        """`exemplar` (a labels dict, e.g. {"change_id": "42"}) is
        remembered for the bucket `v` lands in (last write wins) and
        rendered as an OpenMetrics exemplar after that bucket line."""
        v = float(v)
        if math.isnan(v):  # would poison _sum forever, cannot be bucketed
            return
        for i, bound in enumerate(self.bounds):
            if v <= bound:
                self.counts[i] += 1
                break
        else:
            self.overflow += 1
            i = len(self.bounds)
        self.sum += v
        self.count += 1
        if exemplar is not None:
            self.exemplars[i] = (dict(exemplar), v)


class Registry:
    """Get-or-register by (name, labels); renders in registration order.
    A lock guards registration and render — probe code is effectively
    single-threaded, but a scrape-while-probing must never corrupt."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families = {}   # name -> (type, help, {label_items: child})
        self._order = []

    @staticmethod
    def _series_names(name, kind):
        if kind == "histogram":
            return (name, f"{name}_bucket", f"{name}_sum", f"{name}_count")
        return (name,)

    def _get(self, kind, name, help_text, labels, factory):
        name = _sanitize_name(name)
        items = tuple((_sanitize_name(k, label=True), str(v))
                      for k, v in (labels or {}).items())
        if kind == "histogram":
            items = tuple(("exported_le" if k == "le" else k, v)
                          for k, v in items)
        with self._lock:
            # Sample-name collision guard (mirrors the C++ registry): a
            # family whose sample lines would collide with another
            # family's — a plain metric named like a histogram's
            # generated h_bucket/_sum/_count, or vice versa — is renamed
            # with trailing '_' until free; repeat registrations re-run
            # the exact lookup first, landing on the same family.
            while name not in self._families:
                ours = set(self._series_names(name, kind))
                if not any(ours & set(self._series_names(other, k))
                           for other, (k, _, _) in self._families.items()):
                    break
                name += "_"
            family = self._families.get(name)
            if family is None:
                family = (kind, str(help_text), {})
                self._families[name] = family
                self._order.append(name)
            if family[0] != kind:
                # Type mismatch: a detached instrument, never a crash.
                return factory()
            child = family[2].get(items)
            if child is None:
                child = factory()
                family[2][items] = child
            return child

    def counter(self, name, help_text, labels=None):
        return self._get("counter", name, help_text, labels, Counter)

    def gauge(self, name, help_text, labels=None):
        return self._get("gauge", name, help_text, labels, Gauge)

    def histogram(self, name, help_text, labels=None,
                  buckets=DEFAULT_BUCKETS):
        return self._get("histogram", name, help_text, labels,
                         lambda: Histogram(buckets))

    def render(self):
        with self._lock:
            out = []
            for name in self._order:
                kind, help_text, children = self._families[name]
                out.append(f"# HELP {name} {_escape_help(help_text)}")
                out.append(f"# TYPE {name} {kind}")
                for items, child in children.items():
                    labels = ",".join(
                        f'{k}="{_escape_label_value(v)}"'
                        for k, v in items)
                    if kind == "histogram":
                        # One coherent read: +Inf and _count derive from
                        # the same per-bucket values just rendered (the
                        # C++ TakeSnapshot rule) — reading child.count
                        # here could observe an observe() between its
                        # bucket increment and its count increment and
                        # emit +Inf < a finite bucket, which
                        # validate_exposition itself rejects.
                        counts = list(child.counts)
                        total = sum(counts) + child.overflow

                        def _exemplar_suffix(i, child=child):
                            entry = child.exemplars[i]
                            if entry is None:
                                return ""
                            ex_labels, ex_value = entry
                            rendered = ",".join(
                                f'{_sanitize_name(k, label=True)}='
                                f'"{_escape_label_value(v)}"'
                                for k, v in ex_labels.items())
                            return (f" # {{{rendered}}} "
                                    f"{_format_value(ex_value)}")

                        cumulative = 0
                        for i, (bound, n) in enumerate(
                                zip(child.bounds, counts)):
                            cumulative += n
                            le = _format_value(bound)
                            sep = "," if labels else ""
                            out.append(
                                f'{name}_bucket{{{labels}{sep}le="{le}"}} '
                                f"{cumulative}{_exemplar_suffix(i)}")
                        sep = "," if labels else ""
                        out.append(f'{name}_bucket{{{labels}{sep}le="+Inf"}} '
                                   f"{total}"
                                   f"{_exemplar_suffix(len(child.bounds))}")
                        suffix = f"{{{labels}}}" if labels else ""
                        out.append(f"{name}_sum{suffix} "
                                   f"{_format_value(child.sum)}")
                        out.append(f"{name}_count{suffix} {total}")
                    else:
                        suffix = f"{{{labels}}}" if labels else ""
                        out.append(f"{name}{suffix} "
                                   f"{_format_value(child.value)}")
            return "\n".join(out) + "\n" if out else ""

    def write_textfile(self, path):
        """Writes the rendered registry to `path` (write_textfile below);
        returns the text."""
        return write_textfile(path, self.render())


def write_textfile(path, text):
    """Atomic textfile-collector write: `text` to `path.tmp`, fsync,
    rename — a scraper never sees a torn file. Returns the text."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(text)
        f.flush()
        os.fsync(f.fileno())
    os.rename(tmp, path)
    return text


_DEFAULT = Registry()


def default_registry():
    return _DEFAULT


# ---- exposition parsing / validation ----------------------------------------

_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)"          # metric name
    r"(?:\{(.*)\})?"                        # optional label set
    r" (NaN|[+-]Inf|[0-9eE.+-]+)$")         # value (no timestamp)
# OpenMetrics exemplar form: `name{labels} value # {ex_labels} ex_value`.
# Tried only after the plain grammar fails, so a " # " inside a quoted
# label value still parses as a plain sample.
_EXEMPLAR_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(.*)\})?"
    r" (NaN|[+-]Inf|[0-9eE.+-]+)"
    r" # \{(.*)\} (NaN|[+-]Inf|[0-9eE.+-]+)$")
_LABEL_RE = re.compile(
    r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"(?:,|$)')


def _parse_value(text):
    if text == "NaN":
        return float("nan")
    if text == "+Inf":
        return float("inf")
    if text == "-Inf":
        return float("-inf")
    return float(text)


def _parse_label_text(label_text, line):
    """The contiguous `_LABEL_RE` scan shared by the sample label set
    and the exemplar label set."""
    labels = {}
    if not label_text:
        return labels
    consumed = 0
    for lm in _LABEL_RE.finditer(label_text):
        # Matches must be contiguous from the start, or a junk-prefixed
        # or space-separated label set would be read in part.
        if lm.start() != consumed:
            raise ValueError(
                f"unparseable label set in: {line!r}")
        key, value = lm.group(1), lm.group(2)
        if key in labels:
            raise ValueError(f"duplicate label {key!r} in: {line!r}")
        # Single-pass unescape: the writer emits a\\nb for the value
        # a\nb, which sequential replaces would mis-decode.
        labels[key] = re.sub(
            r"\\(.)",
            lambda m: "\n" if m.group(1) == "n" else m.group(1),
            value)
        consumed = lm.end()
    if consumed != len(label_text):
        raise ValueError(f"unparseable label set in: {line!r}")
    return labels


def parse_samples_ex(text):
    """Yields (name, labels-dict, value, exemplar) for every sample
    line, where exemplar is None or an (labels-dict, value) pair.
    Raises ValueError on lines that match neither the sample nor the
    comment grammar (no timestamps, no exemplar timestamps)."""
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        # Plain grammar first, exemplar grammar as fallback: the plain
        # regex's greedy label group also matches exemplar lines, whose
        # label text then fails the contiguity scan.
        match = _SAMPLE_RE.match(line)
        if match:
            name, label_text, value_text = match.groups()
            try:
                labels = _parse_label_text(label_text, line)
            except ValueError:
                match = None
            else:
                yield name, labels, _parse_value(value_text), None
                continue
        match = _EXEMPLAR_SAMPLE_RE.match(line)
        if not match:
            raise ValueError(f"unparseable sample line: {line!r}")
        name, label_text, value_text, ex_text, ex_value = match.groups()
        exemplar = (_parse_label_text(ex_text, line),
                    _parse_value(ex_value))
        yield (name, _parse_label_text(label_text, line),
               _parse_value(value_text), exemplar)


def parse_samples(text):
    """Yields (name, labels-dict, value) for every sample line."""
    for name, labels, value, _ in parse_samples_ex(text):
        yield name, labels, value


def sample_value(text, name, labels=None):
    """The value of the first sample matching `name` (and, when given,
    every (k, v) in `labels`); None when absent."""
    for sample_name, sample_labels, value in parse_samples(text):
        if sample_name != name:
            continue
        if labels and any(sample_labels.get(k) != v
                          for k, v in labels.items()):
            continue
        return value
    return None


def validate_exposition(text):
    """Validates Prometheus text exposition; raises ValueError with the
    offending line on any violation (the twin of the daemon's
    ValidateExposition, src/tfd/obs/metrics.cc)."""
    if text and not text.endswith("\n"):
        raise ValueError("exposition must end with a newline")
    types = {}
    for line in text.splitlines():
        if not line.startswith("#"):
            continue
        parts = line.split(None, 3)
        if len(parts) >= 3 and parts[1] == "TYPE":
            name = parts[2]
            if not _NAME_RE.match(name):
                raise ValueError(f"invalid family name in: {line!r}")
            if name in types:
                raise ValueError(f"duplicate TYPE for {name}")
            if len(parts) < 4 or parts[3] not in (
                    "counter", "gauge", "histogram", "summary", "untyped"):
                raise ValueError(f"invalid type in: {line!r}")
            types[name] = parts[3]

    last_bucket = {}
    last_le = {}
    inf_bucket = {}
    counts = {}
    for name, labels, value, exemplar in parse_samples_ex(text):
        # An exactly named family wins; only then does a histogram
        # series suffix attribute to its base.
        family = name
        if name not in types:
            for suffix in ("_bucket", "_sum", "_count"):
                base = (name[: -len(suffix)]
                        if name.endswith(suffix) else None)
                if base and types.get(base) == "histogram":
                    family = base
                    break
        if family not in types:
            raise ValueError(f"sample for undeclared family: {name}")
        if exemplar is not None:
            # Exemplars ride counter and histogram-bucket lines only.
            bucket_line = (types[family] == "histogram"
                           and name == family + "_bucket")
            if not bucket_line and types[family] != "counter":
                raise ValueError(
                    f"exemplar on a non-counter/non-bucket line: {name}")
            ex_labels, _ = exemplar
            budget = sum(len(k) + len(v) for k, v in ex_labels.items())
            if budget > 128:
                raise ValueError(
                    f"exemplar labels exceed the 128-rune budget "
                    f"({budget}) on: {name}")
        if types[family] == "counter" and value < 0:
            raise ValueError(f"negative counter: {name} {value}")
        if types[family] == "histogram" and name == family + "_bucket":
            if "le" not in labels:
                raise ValueError(f"histogram bucket without le: {name}")
            le = _parse_value(labels["le"])
            series = (family, tuple(sorted(
                (k, v) for k, v in labels.items() if k != "le")))
            if series in last_bucket:
                if le <= last_le[series]:
                    raise ValueError(f"bucket le not increasing: {series}")
                if value < last_bucket[series]:
                    raise ValueError(
                        f"bucket counts not cumulative: {series}")
            last_bucket[series] = value
            last_le[series] = le
            if math.isinf(le):
                inf_bucket[series] = value
        if types[family] == "histogram" and name == family + "_count":
            series = (family, tuple(sorted(labels.items())))
            counts[series] = value
    for series, count in counts.items():
        if series not in inf_bucket:
            raise ValueError(f"histogram series without +Inf bucket: "
                             f"{series}")
        if inf_bucket[series] != count:
            raise ValueError(f"+Inf bucket != _count for: {series}")
