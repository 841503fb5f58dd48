"""Metrics registry + Prometheus text exposition (stdlib only).

The port's own copy of the producing half of ``tpufd/metrics.py``: the
same three instruments (counter / gauge / histogram), the same text
format (one ``# HELP``/``# TYPE`` block per family, escaped label
values, cumulative histogram buckets ending in ``+Inf``) and the same
registration-order output. Probe timings from ``tpufd_torch.health``
land here and ``python -m tpufd_torch health --metrics-out PATH`` writes
them as a node-exporter textfile. The parsers and the validator stay in
``tpufd.metrics``; the tests validate this module's output with them.
"""

import math
import os
import re
import threading

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
        """Atomic textfile-collector write: render to `path.tmp`, fsync,
        rename — a scraper never sees a torn file."""
        text = self.render()
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
