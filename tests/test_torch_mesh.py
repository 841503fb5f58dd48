"""The port's slice-shape helpers, (data, model) rule and device meshes
against tpufd.mesh, exact, errors included. The meshes are built on 4
gloo ranks (one spawn) and compared with tpufd's over 4 of JAX's virtual
CPU devices."""

import pytest

from tpufd_torch import launch, mesh

# (function, args) of every mesh built on the ranks and in tpufd.
MESH_CASES = [
    ("data_model_mesh", ()),
    ("data_model_mesh", (2,)),
    ("data_model_mesh", (4,)),
    ("data_model_mesh", (3,)),
    ("topology_mesh", ("2x2",)),
    ("topology_mesh", ("2x2x1",)),
    ("topology_mesh", ("1x4", ("a", "b"))),
    ("topology_mesh", ("4x4",)),
]

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


def build_meshes():
    """Rank side: each MESH_CASES mesh as (sizes, axis names) or its
    error."""
    def build(name, args):
        if name == "data_model_mesh":
            m = mesh.data_model_mesh("cpu", *args)
        else:
            m = mesh.topology_mesh(args[0], "cpu", *args[1:])
        return tuple(m.mesh.shape), m.mesh_dim_names

    return [outcome(build, name, args) for name, args in MESH_CASES]


@pytest.fixture(scope="module")
def rank_meshes():
    return launch.spawn_ranks(build_meshes, 4, "cpu", timeout=150)


@pytest.mark.parametrize("case", range(len(MESH_CASES)),
                         ids=[f"{n}{a}" for n, a in MESH_CASES])
def test_device_meshes_match_jax_at_four_devices(cpu_jax, rank_meshes,
                                                 case):
    """Sizes and axis names of each mesh over 4 ranks equal tpufd's over
    4 devices, or the same ValueError, text and all ("topology 4x4 needs
    16 devices, have 4")."""
    from tpufd import mesh as ref

    name, args = MESH_CASES[case]
    devices = cpu_jax.devices("cpu")[:4]

    def build():
        if name == "data_model_mesh":
            m = ref.data_model_mesh(devices, *args)
        else:
            m = ref.topology_mesh(args[0], devices, *args[1:])
        return tuple(m.devices.shape), tuple(m.axis_names)

    assert rank_meshes[case] == outcome(build)


def test_meshes_need_a_process_group():
    with pytest.raises(RuntimeError, match="no.*process group|none is"):
        mesh.data_model_mesh("cpu")
    with pytest.raises(RuntimeError, match="spawn_ranks"):
        mesh.topology_mesh("2x2", "cpu")
