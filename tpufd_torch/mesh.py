"""Slice-shape helpers and the (data, model) split: the port's own copy of
the framework-free half of tpufd/mesh.py.

``parse_shape``, ``num_chips`` and ``balanced_2d`` are the daemon's
slice-shape grammar (src/tfd/slice/shape.cc) in Python, as in the
reference. ``data_model_shape`` carries the rule of the reference's
``data_model_mesh`` without building a mesh: the mapping onto
``torch.distributed.DeviceMesh`` comes with the multi-card slice.
"""

import math


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
