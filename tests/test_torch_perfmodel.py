"""The port's perf class model against the reference's: `tpufd_torch.perfmodel`
against `tpufd.perfmodel` on the classification grid the C++ suite pins,
a hypothesis sweep of `classify` over percentages and previous classes,
and the fleet floor and label rendering on both rated tables."""

import json

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from tpufd import perfmodel as ref
from tpufd_torch import perfmodel

# tests/test_perf.py's grid, the same as unit_tests.cc
# TestPerfClassificationGrid: (matmul %, hbm %, previous class, class).
GRID = [
    (95, 80, None, "gold"),
    (95, 65, None, "silver"),
    (89, 80, None, "silver"),
    (95, None, None, "gold"),
    (None, 80, None, "silver"),
    (49, 80, None, "degraded"),
    (95, 45, None, "degraded"),
    (89, 80, "gold", "gold"),
    (86, 80, "gold", "silver"),
    (91, 80, "silver", "silver"),
    (94, 80, "silver", "gold"),
    (49, 80, "silver", "silver"),
    (46, 80, "silver", "degraded"),
    (51, 80, "degraded", "degraded"),
    (54, 80, "degraded", "silver"),
    (95, 80, "degraded", "gold"),
]
PREVIOUS = (None, "", "gold", "silver", "degraded", "platinum")


@pytest.mark.parametrize("matmul, hbm, prev, want", GRID)
def test_classification_grid(matmul, hbm, prev, want):
    assert perfmodel.classify(matmul, hbm, prev=prev) == want
    assert ref.classify(matmul, hbm, prev=prev) == want


def test_thresholds_and_names_equal_the_reference():
    for name in ("CLASS_GOLD", "CLASS_SILVER", "CLASS_DEGRADED",
                 "GOLD_MATMUL_PCT", "GOLD_HBM_PCT", "DEGRADED_PCT",
                 "HYSTERESIS_PCT"):
        assert getattr(perfmodel, name) == getattr(ref, name), name
    for name in ("gold", "silver", "degraded", "platinum", "", None):
        assert perfmodel.class_rank(name) == ref.class_rank(name)
    for rank in (-1, 0, 1, 2, 3, None):
        assert perfmodel.rank_name(rank) == ref.rank_name(rank)


# Each threshold, its hysteresis margins, and a hair to either side.
BOUNDARIES = sorted({b + d + e for b in (50.0, 70.0, 90.0)
                     for d in (-3.0, 0.0, 3.0) for e in (-1e-9, 0.0, 1e-9)})
PERCENT = st.one_of(st.none(), st.sampled_from(BOUNDARIES),
                    st.floats(min_value=0, max_value=120,
                              allow_nan=False))


@settings(max_examples=600, deadline=None, database=None, derandomize=True)
@given(matmul=PERCENT, hbm=PERCENT, prev=st.sampled_from(PREVIOUS))
def test_classify_equals_the_reference(matmul, hbm, prev):
    assert (perfmodel.classify(matmul, hbm, prev=prev)
            == ref.classify(matmul, hbm, prev=prev))


@pytest.mark.parametrize("measured, rated", [
    (727.5, 989.0), (0.25, 197.0), (0.0, 46.0), (-1.0, 989.0),
    (None, 989.0), (12.0, None), (12.0, 0.0), (12.0, -3.0)])
def test_pct_of_rated_equals_the_reference(measured, rated):
    assert (perfmodel.pct_of_rated(measured, rated)
            == ref.pct_of_rated(measured, rated))


FLOORS = [
    "{}",
    '{"matmul_p10_tflops": 700, "hbm_p10_gbps": 2900.5}',
    '{"matmul_p10_tflops": 0.3}',
    '{"hbm_p10_gbps": 0}',
    '{"matmul_p10_tflops": -5, "hbm_p10_gbps": "fast"}',
    '{"matmul_p10_tflops": null, "extra": [1, 2]}',
]


@pytest.mark.parametrize("text", FLOORS)
def test_parse_fleet_floor_equals_the_reference(text):
    assert perfmodel.parse_fleet_floor(text) == ref.parse_fleet_floor(text)


@pytest.mark.parametrize("text", ["[1, 2]", '"floor"', "7", "{not json",
                                  ""])
def test_fleet_floor_garbage_raises_on_both_sides(text):
    with pytest.raises(ValueError) as want:
        ref.parse_fleet_floor(text)
    with pytest.raises(ValueError) as got:
        perfmodel.parse_fleet_floor(text)
    assert type(got.value) is type(want.value)
    assert str(got.value) == str(want.value)


READINGS = [(727.0, 2996.0), (0.25, 253.0), (9.99, 10.0), (-1.0, 2996.0),
            (727.0, -1.0), (None, None), (0.0, 0.0)]


@pytest.mark.parametrize("text", FLOORS)
def test_apply_fleet_floor_equals_the_reference(text):
    floor = perfmodel.parse_fleet_floor(text)
    for matmul, hbm in READINGS:
        for name in ("gold", "silver", "degraded"):
            assert (perfmodel.apply_fleet_floor(name, matmul, hbm, floor)
                    == ref.apply_fleet_floor(name, matmul, hbm, floor))


@pytest.mark.parametrize("table", ["reference", "port"])
def test_expected_labels_equal_the_reference(table):
    """Both rated tables (the reference's TPU families and the port's
    H100 SKUs), every family of each and one unknown: readings below 10,
    whole, absent and negative."""
    specs = (ref.load_rated_specs() if table == "reference"
             else perfmodel.load_rated_specs())
    for family in [*specs, "v9z", None]:
        for matmul, hbm in READINGS:
            for ici in (None, -1.0, 3.5, 412.9):
                rated = specs.get(family, {})
                name = perfmodel.classify(
                    perfmodel.pct_of_rated(matmul,
                                           rated.get("matmul_tflops")),
                    perfmodel.pct_of_rated(hbm, rated.get("hbm_gbps")))
                got = perfmodel.expected_labels(matmul, hbm, ici, family,
                                                name, specs=specs)
                want = ref.expected_labels(matmul, hbm, ici, family, name,
                                           specs=specs)
                assert got == want, (family, matmul, hbm, ici)


def test_expected_labels_default_to_the_port_table():
    """Without `specs`, the port rates against its own H100 table."""
    labels = perfmodel.expected_labels(727.4, 2996.0, None, "h100-sxm",
                                       "silver")
    assert labels == {"google.com/tpu.perf.matmul-tflops": "727",
                      "google.com/tpu.perf.hbm-gbps": "2996",
                      "google.com/tpu.perf.pct-of-rated": "74",
                      "google.com/tpu.perf.class": "silver"}
    assert json.loads(json.dumps(perfmodel.load_rated_specs())) == {
        "h100-sxm": {"matmul_tflops": 989.0, "hbm_gbps": 3350.0},
        "h100-pcie": {"matmul_tflops": 756.0, "hbm_gbps": 2000.0}}
