"""Slice-shape helpers and device meshes: the PyTorch port of
tpufd/mesh.py.

``parse_shape``, ``num_chips`` and ``balanced_2d`` are the daemon's
slice-shape grammar (src/tfd/slice/shape.cc) in Python, as in the
reference. ``data_model_shape`` is the rule of the reference's
``data_model_mesh``; ``data_model_mesh`` and ``topology_mesh`` build the
reference's meshes as ``torch.distributed`` DeviceMeshes over the ranks
of the current process group (one rank per device, see
``tpufd_torch.launch``), and must be called on every rank.
"""

import math

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh


def parse_shape(text):
    """Parses "4x4" / "2x2x1" into a tuple of ints (the C++ grammar's twin,
    src/tfd/slice/shape.cc ParseShape)."""
    parts = str(text).strip().split("x")
    if len(parts) < 2 or len(parts) > 3:
        raise ValueError(f"invalid slice shape {text!r}: want 2 or 3 dims")
    dims = []
    for part in parts:
        if not part.isdigit():
            raise ValueError(f"invalid slice shape {text!r}")
        value = int(part)
        if value < 1:
            raise ValueError(f"invalid slice shape {text!r}: dims must be >= 1")
        dims.append(value)
    return tuple(dims)


def num_chips(shape_text):
    return math.prod(parse_shape(shape_text))


def balanced_2d(n):
    """The squarest (a, b) with a*b == n and a <= b — same rule the daemon
    uses for default 2D topologies (src/tfd/slice/topology.cc)."""
    a = int(math.isqrt(n))
    while a > 1 and n % a:
        a -= 1
    return (a, n // a)


def data_model_shape(n_devices, model_parallelism=None):
    """(data, model) sizes of a ('data', 'model') mesh over n_devices.

    `model_parallelism` defaults to the largest power-of-2 divisor of the
    device count capped at 8, as in the reference's data_model_mesh.
    Raises ValueError, with the reference's text, when it does not divide
    the device count.
    """
    n = n_devices
    if model_parallelism is None:
        model_parallelism = 1
        while model_parallelism < 8 and n % (model_parallelism * 2) == 0:
            model_parallelism *= 2
    if n % model_parallelism:
        raise ValueError(
            f"{n} devices not divisible by model_parallelism="
            f"{model_parallelism}")
    return n // model_parallelism, model_parallelism


def _world_size():
    if not dist.is_initialized():
        raise RuntimeError(
            "a device mesh spans the ranks of a process group, and none is "
            "initialised; run under tpufd_torch.launch.spawn_ranks")
    return dist.get_world_size()


def data_model_mesh(device_type, model_parallelism=None):
    """A ('data', 'model') DeviceMesh over every rank, split as the
    reference's data_model_mesh splits its devices (data_model_shape),
    with its ValueError when model_parallelism does not divide them."""
    shape = data_model_shape(_world_size(), model_parallelism)
    return init_device_mesh(device_type, shape,
                            mesh_dim_names=("data", "model"))


def topology_mesh(topology_text, device_type, axis_names=None):
    """A DeviceMesh shaped like the slice topology label (e.g. "4x4" -> a
    4x4 mesh with axes ('x', 'y')) over every rank, in rank order."""
    dims = parse_shape(topology_text)
    world = _world_size()
    if world != math.prod(dims):
        raise ValueError(
            f"topology {topology_text} needs {math.prod(dims)} devices, "
            f"have {world}")
    if axis_names is None:
        axis_names = ("x", "y", "z")[:len(dims)]
    return init_device_mesh(device_type, dims,
                            mesh_dim_names=tuple(axis_names))
