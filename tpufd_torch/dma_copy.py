"""HBM -> HBM copy, repeated: the port of the DMA-copy probe's kernel.

``dma_copy`` launches the CUDA kernel in ``csrc/dma_copy.cu`` (which
replaces the Pallas kernel ``tpufd/health.py::_dma_copy_fn``) for a CUDA
tensor, and runs the plain PyTorch version ``dma_copy_plain`` for a CPU
tensor. It never falls back from the kernel to the plain version.
``launches`` counts kernel launches, so a run can show that its path went
through the kernel. ``unaligned_launches`` counts those of them whose input
and output are not aligned alike modulo 16 bytes, which the kernel copies
element by element instead of in 16-byte vectors, so a run can show that
its launches all took the vector path.
"""

import ctypes

import torch

from tpufd_torch import _build

# Kernel launches made by dma_copy(); the plain version never counts.
launches = 0
# Those of them that took the kernel's element-by-element path.
unaligned_launches = 0

# What launch_plan() reports, in the order tpufd_dma_copy_plan fills it.
PLAN_KEYS = ("threads", "sweeps_per_chunk", "resident_per_sm",
             "sweep_bytes")

_library = None


def bind(lib):
    """Declares the C signatures of a dma_copy library (a ctypes.CDLL);
    returns it."""
    lib.tpufd_dma_copy.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
    lib.tpufd_dma_copy.restype = ctypes.c_int
    lib.tpufd_dma_copy_plan.argtypes = [
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    lib.tpufd_dma_copy_plan.restype = ctypes.c_int
    return lib


def _lib():
    global _library
    if _library is None:
        _library = bind(_build.load("dma_copy"))
    return _library


def _kernel():
    """The C entry point tpufd_dma_copy, as a ctypes function."""
    return _lib().tpufd_dma_copy


def launch_plan(rows, cols, chunks, device):
    """The launch the kernel makes for a (rows, cols) array in `chunks` on
    CUDA `device`: {key: int} over PLAN_KEYS."""
    plan = (ctypes.c_longlong * len(PLAN_KEYS))()
    with torch.cuda.device(device):
        err = _lib().tpufd_dma_copy_plan(rows, cols, chunks, plan)
    if err:
        raise RuntimeError(f"dma_copy launch plan failed: CUDA error {err}")
    return dict(zip(PLAN_KEYS, plan))


def _check(x, n, chunks):
    if x.dim() != 2 or x.numel() == 0:
        raise ValueError(f"dma_copy takes a non-empty 2-D tensor, got shape "
                         f"{tuple(x.shape)}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"dma_copy takes bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("dma_copy takes a contiguous tensor")
    if not 1 <= chunks <= 65535 or x.shape[0] % chunks:
        raise ValueError(f"rows ({x.shape[0]}) must split into chunks "
                         f"({chunks}) whole row blocks")
    if n < 1:
        raise ValueError(f"n must be >= 1, got {n}")


def dma_copy_plain(x, n, chunks):
    """out = x, written n times as `chunks` row-block copies: the plain
    PyTorch version of the kernel."""
    _check(x, n, chunks)
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    rows_per = x.shape[0] // chunks
    for _ in range(n):
        for c in range(chunks):
            block = slice(c * rows_per, (c + 1) * rows_per)
            out[block].copy_(x[block])
    return out


def dma_copy(x, n, chunks):
    """out = x for a contiguous (rows, cols) bf16 tensor, copied n times in
    `chunks` row blocks. A CUDA tensor goes through the kernel on the
    current stream (no synchronisation); a CPU tensor through
    dma_copy_plain. Raises on any other device, dtype or shape."""
    global launches, unaligned_launches
    _check(x, n, chunks)
    if x.device.type == "cpu":
        return dma_copy_plain(x, n, chunks)
    if x.device.type != "cuda":
        raise ValueError(
            f"dma_copy takes a CPU or CUDA tensor, got {x.device}")
    fn = _kernel()
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    rows, cols = x.shape
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), out.data_ptr(), rows, cols, chunks, n,
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"dma_copy kernel launch failed: CUDA error {err}")
    launches += 1
    if x.data_ptr() % 16 != out.data_ptr() % 16:
        unaligned_launches += 1
    return out
