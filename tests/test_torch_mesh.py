"""The port's slice-shape helpers and (data, model) rule against
tpufd.mesh, exact, errors included."""

import pytest

from tpufd_torch import mesh

SHAPES = ["4x4", "2x2x1", "4x4x4", "1x1", " 8x2 ", "4", "0x2", "1x2x3x4",
          "axb", "2x-1", "", "2xx2"]


def outcome(fn, *args):
    try:
        return fn(*args)
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("text", SHAPES)
def test_parse_shape_and_num_chips_match_jax(cpu_jax, text):
    from tpufd import mesh as ref

    assert outcome(mesh.parse_shape, text) == outcome(ref.parse_shape, text)
    assert outcome(mesh.num_chips, text) == outcome(ref.num_chips, text)


def test_reference_grid():
    """The reference's own grid (tests/test_tpufd.py::test_parse_shape)."""
    assert mesh.parse_shape("4x4") == (4, 4)
    assert mesh.parse_shape("2x2x1") == (2, 2, 1)
    assert mesh.num_chips("4x4x4") == 64
    for bad in ("4", "0x2", "1x2x3x4", "axb"):
        with pytest.raises(ValueError):
            mesh.parse_shape(bad)
    assert mesh.balanced_2d(16) == (4, 4)
    assert mesh.balanced_2d(8) == (2, 4)


def test_balanced_2d_matches_jax(cpu_jax):
    from tpufd import mesh as ref

    for n in range(1, 130):
        assert mesh.balanced_2d(n) == ref.balanced_2d(n), n


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("model_parallelism", [None, 1, 2, 3, 4, 8, 16])
def test_data_model_shape_matches_jax_mesh(cpu_jax, n, model_parallelism):
    """The shape of tpufd.mesh.data_model_mesh over n CPU devices, or its
    ValueError, text and all."""
    from tpufd import mesh as ref

    devices = cpu_jax.devices("cpu")[:n]
    got = outcome(mesh.data_model_shape, n, model_parallelism)
    want = outcome(
        lambda: tuple(ref.data_model_mesh(
            devices, model_parallelism=model_parallelism).shape.values()))
    assert got == want


def test_data_model_shape_defaults_past_eight_devices():
    """The default model axis stops at 8 (one tensor-parallel group)."""
    assert mesh.data_model_shape(16) == (2, 8)
    assert mesh.data_model_shape(12) == (3, 4)
    assert mesh.data_model_shape(6) == (3, 2)
