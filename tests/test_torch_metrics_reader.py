"""The reading half of the port's metrics module against the reference's:
`tpufd_torch.metrics` parse_samples_ex / parse_samples / sample_value /
validate_exposition against `tpufd.metrics` on the expositions of
tests/test_metrics.py, on lines drawn from a numpy seed, on the port's own
textfile (the probe timings `health --metrics-out` writes). The real
daemon's /metrics page is read by both in tests/test_torch_journal.py."""

import math

import numpy as np
import pytest

from tpufd import metrics as ref
from tpufd_torch import metrics

# The exposition cases of tests/test_metrics.py: what its validator must
# refuse, then what it must take.
REFUSED = [
    "no trailing newline",
    "orphan_sample 1\n",
    "# TYPE m counter\nm -1\n",
    "# TYPE m counter\nm notanum\n",
    "# TYPE m bogus\nm 1\n",
    "# TYPE m counter\n# TYPE m counter\nm 1\n",
    '# TYPE m counter\nm{x="a",x="b"} 1\n',
    ('# TYPE h histogram\nh_bucket{le="1"} 5\nh_bucket{le="2"} 3\n'
     'h_bucket{le="+Inf"} 5\nh_sum 1\nh_count 5\n'),
    '# TYPE h histogram\nh_bucket{le="1"} 1\nh_sum 1\nh_count 1\n',
    ('# TYPE h histogram\nh_bucket{le="1"} 1\n'
     'h_bucket{le="+Inf"} 2\nh_sum 1\nh_count 3\n'),
    '# TYPE g gauge\ng 1 # {change_id="1"} 1\n',
    ('# TYPE h histogram\nh_bucket{le="+Inf"} 1\nh_sum 1\n'
     'h_count 1 # {change_id="1"} 1\n'),
    f'# TYPE c counter\nc 1 # {{change_id="{"x" * 140}"}} 1\n',
    '# TYPE m gauge\nm{a="1" ,b="2"} 1\n',
    '# TYPE m gauge\nm 1 1700000000\n',
    "# TYPE 1m gauge\n",
    '# TYPE h histogram\nh_bucket{x="1"} 1\n',
]
TAKEN = [
    "",
    "# TYPE x_bucket counter\nx_bucket 3\n",
    ("# HELP h text\n# TYPE h histogram\n"
     'h_bucket{le="1"} 1\nh_bucket{le="+Inf"} 2\n'
     "h_sum 1.5\nh_count 2\n"),
    ("# TYPE tfd_rewrites_total counter\ntfd_rewrites_total 17\n"
     "# TYPE tfd_d_seconds histogram\n"
     'tfd_d_seconds_bucket{op="a",le="+Inf"} 3\n'
     'tfd_d_seconds_sum{op="a"} 0.5\ntfd_d_seconds_count{op="a"} 3\n'),
    "# TYPE n gauge\nn NaN\n# TYPE i gauge\ni +Inf\ni{s=\"-\"} -Inf\n",
    ("# TYPE tfd_passes_total counter\n"
     'tfd_passes_total 7 # {change_id="9"} 0.25\n'
     "# TYPE tfd_g gauge\ntfd_g 1\n"),
    '# TYPE c counter\nc 1 # {change_id="1"} 1\n',
    '# TYPE g gauge\ng{path="a # b"} 1\n',
    '# TYPE g gauge\ng{v="a\\\\nb",w="q\\"x",n="l\\n2"} 1e-3\n',
]


def outcome(module, text):
    """(parse_samples_ex, parse_samples, validator error) of one module
    on `text`; values by repr, so NaN compares equal to NaN."""
    def canon(value):
        return repr(value) if isinstance(value, float) else value

    def read(parse, with_exemplar):
        try:
            return [(s[0], s[1], canon(s[2]))
                    + ((s[3] and (s[3][0], canon(s[3][1])),)
                       if with_exemplar else ())
                    for s in parse(text)]
        except ValueError as e:
            return f"ValueError: {e}"

    try:
        module.validate_exposition(text)
        error = None
    except ValueError as e:
        error = str(e)
    return (read(module.parse_samples_ex, True),
            read(module.parse_samples, False), error)


@pytest.mark.parametrize("text", REFUSED)
def test_refused_expositions_equal_the_reference(text):
    got = outcome(metrics, text)
    assert got == outcome(ref, text)
    assert got[2] is not None


@pytest.mark.parametrize("text", TAKEN)
def test_taken_expositions_equal_the_reference(text):
    got = outcome(metrics, text)
    assert got == outcome(ref, text)
    assert got[2] is None


def test_sample_value_equals_the_reference():
    text = TAKEN[3]
    for name, labels in [("tfd_rewrites_total", None),
                         ("tfd_d_seconds_count", {"op": "a"}),
                         ("tfd_d_seconds_count", {"op": "b"}),
                         ("absent", None), ("tfd_d_seconds_bucket", {})]:
        assert (metrics.sample_value(text, name, labels=labels)
                == ref.sample_value(text, name, labels=labels))
    assert math.isnan(metrics.sample_value(TAKEN[4], "n"))
    assert metrics.sample_value(TAKEN[4], "i", {"s": "-"}) == -math.inf


NAMES = ["m", "m_bucket", "m_count", "m_sum", "tfd_x_total", "1bad", "a:b"]
LABEL_SETS = ["", "{}", '{le="1"}', '{le="+Inf"}', '{op="a"}',
              '{op="a",le="0.5"}', '{op="a" ,le="1"}', '{op="a\\"b"}',
              '{op="#"}', '{op="a",op="b"}', "{op=a}", '{op="\\n"}']
VALUES = ["1", "0", "-1", "2.5e3", "NaN", "+Inf", "-Inf", "x", "1 2"]
EXEMPLARS = ["", ' # {change_id="3"} 0.5', " # {} 1", ' # {a="b"}',
             ' # {change_id="1"} 1 17']
TYPES = ["counter", "gauge", "histogram", "summary", "untyped", "bogus"]


def drawn_exposition(rng):
    """A few TYPE lines and sample lines over a handful of families,
    mostly well formed; ends in a newline nine times in ten."""
    lines = []
    for _ in range(int(rng.integers(1, 12))):
        if rng.random() < 0.3:
            lines.append(f"# TYPE {rng.choice(NAMES[:5])} "
                         f"{rng.choice(TYPES)}")
        elif rng.random() < 0.1:
            lines.append("# HELP m some help")
        else:
            lines.append(f"{rng.choice(NAMES)}{rng.choice(LABEL_SETS)} "
                         f"{rng.choice(VALUES)}{rng.choice(EXEMPLARS)}")
    text = "\n".join(lines)
    return text + "\n" if rng.random() < 0.9 else text


@pytest.mark.parametrize("seed", range(4))
def test_drawn_expositions_equal_the_reference(seed):
    rng = np.random.default_rng(seed)
    taken = 0
    for _ in range(300):
        text = drawn_exposition(rng)
        got = outcome(metrics, text)
        assert got == outcome(ref, text), text
        taken += got[2] is None
    assert 0 < taken < 300  # the draw reaches both verdicts


def port_textfile(monkeypatch):
    """The port's probe timings, as `health --metrics-out` writes them,
    in a fresh default registry: two probes timed through
    health.timed_probe (one failing), the health gauges, and a histogram
    whose label values need escaping and whose observations carry
    exemplars."""
    from tpufd_torch import health

    monkeypatch.setattr(metrics, "_DEFAULT", metrics.Registry())
    reg = metrics.default_registry()
    health.timed_probe("reader-probe", lambda: 1)

    def broken():
        raise RuntimeError("probe blew up")

    with pytest.raises(RuntimeError):
        health.timed_probe("reader-probe", broken)
    reg.gauge("tpufd_health_duration_seconds",
              "Wall time of the whole health_labels run.").set(0.25)
    reg.gauge("tpufd_health_ok",
              "1 when the core probes measured healthy, else 0.").set(1)
    hist = reg.histogram("tpufd_reader_seconds", "escaped labels",
                         labels={"path": 'a "q" \\ b\nc # d'},
                         buckets=(0.1, 1.0))
    for value, change in ((0.05, "1"), (0.5, None), (5.0, "2")):
        hist.observe(value, exemplar=change and {"change_id": change})
    return reg.render()


def test_port_textfile_reads_back_as_the_reference_reads_it(monkeypatch):
    text = port_textfile(monkeypatch)
    got = outcome(metrics, text)
    assert got == outcome(ref, text)
    assert got[2] is None
    probe = {"probe": "reader-probe"}
    for name, labels, want in [
            ("tpufd_probe_duration_seconds_count", probe, 2),
            ("tpufd_probe_failures_total", probe, 1),
            ("tpufd_health_ok", None, 1),
            ("tpufd_reader_seconds_count", {"path": 'a "q" \\ b\nc # d'}, 3)]:
        assert metrics.sample_value(text, name, labels) == want
        assert ref.sample_value(text, name, labels) == want
    assert any(ex for *_, ex in metrics.parse_samples_ex(text))
