"""One step of the matmul chain as one kernel:
out = bf16(0.5 * (tanh(bf16(x @ x)) + x)).

``chain_step`` launches the CUDA kernel in ``csrc/chain_step.cu`` (the
counterpart of XLA's fusion of the whole chain body in
``tpufd/health.py::_matmul_chain``: the product with the tail in its
epilogue) for a CUDA bf16 x that ``takes_fused_step`` accepts, and runs
the plain PyTorch version ``chain_step_plain`` for CPU tensors. It never
falls back from the kernel to the plain version. Both write into ``out``,
a second buffer of x's shape (the kernel reads x as an operand while it
writes, so a step cannot run in place), and return it. ``launches``
counts kernel launches, so a run can show that its path went through the
kernel.
"""

import ctypes

import torch

from tpufd_torch import _build
from tpufd_torch import chain_tail as chain_tail_lib

# Kernel launches made by chain_step(); the plain version never counts.
launches = 0

_library = None


def _kernel():
    """The C entry point tpufd_chain_step, as a ctypes function."""
    global _library
    if _library is None:
        lib = _build.load("chain_step")
        lib.tpufd_chain_step.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_void_p]
        lib.tpufd_chain_step.restype = ctypes.c_int
        _library = lib
    return _library.tpufd_chain_step


def fused_step_fits(device_type, dtype, shape, contiguous, address):
    """Whether the kernel takes an x of these properties: a CUDA bf16
    square matrix, contiguous, whose size is a positive multiple of 8 and
    whose first element is 16-byte aligned (the kernel's TMA maps need
    16-byte row strides and base)."""
    return (device_type == "cuda" and dtype == torch.bfloat16
            and len(shape) == 2 and shape[0] == shape[1]
            and shape[0] > 0 and shape[0] % 8 == 0 and contiguous
            and address % 16 == 0)


def takes_fused_step(x):
    """fused_step_fits for the tensor x: whether _matmul_chain runs its
    steps through chain_step."""
    return fused_step_fits(x.device.type, x.dtype, tuple(x.shape),
                           x.is_contiguous(), x.data_ptr())


def _check(x, out):
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"chain_step takes CPU or CUDA tensors, got "
                         f"{x.device}")
    if x.dim() != 2 or x.shape[0] != x.shape[1] or x.numel() == 0:
        raise ValueError(f"chain_step takes a non-empty square matrix, got "
                         f"shape {tuple(x.shape)}")
    if out.shape != x.shape:
        raise ValueError(f"chain_step takes out of x's shape "
                         f"{tuple(x.shape)}, got {tuple(out.shape)}")
    if out.dtype != x.dtype or not x.dtype.is_floating_point:
        raise TypeError(f"chain_step takes x and out of one floating dtype, "
                        f"got {x.dtype} and {out.dtype}")
    if out.device != x.device:
        raise ValueError(f"chain_step takes x and out on one device, got "
                         f"{x.device} and {out.device}")
    if not (x.is_contiguous() and out.is_contiguous()):
        raise ValueError("chain_step takes contiguous tensors")
    nbytes = x.numel() * x.element_size()
    if (out.data_ptr() < x.data_ptr() + nbytes
            and x.data_ptr() < out.data_ptr() + nbytes):
        raise ValueError("chain_step writes out while it reads x: out must "
                         "be another buffer")


def chain_step_plain(x, out):
    """out = 0.5 * (tanh(x @ x) + x), the product rounded to x's dtype,
    the tail computed in float32 and cast back once: the plain PyTorch
    version of the kernel (chain_tail_plain on the product). Returns
    out."""
    _check(x, out)
    return chain_tail_lib.chain_tail_plain(x @ x, out.copy_(x))


def chain_step(x, out):
    """out = 0.5 * (tanh(x @ x) + x) for a square contiguous x and a
    second buffer out of its shape. A CUDA x that takes_fused_step
    accepts goes through the kernel on the current stream (no
    synchronisation); CPU tensors through chain_step_plain. Raises on any
    other device, dtype, shape or alignment. Returns out."""
    global launches
    _check(x, out)
    if x.device.type == "cpu":
        return chain_step_plain(x, out)
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the chain_step kernel takes bfloat16, got "
                        f"{x.dtype}")
    if not (takes_fused_step(x) and out.data_ptr() % 16 == 0):
        raise ValueError(
            f"the chain_step kernel takes a size that is a multiple of 8 "
            f"and 16-byte aligned buffers; got shape {tuple(x.shape)}, x at "
            f"{x.data_ptr():#x}, out at {out.data_ptr():#x}")
    fn = _kernel()
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), out.data_ptr(), x.shape[0],
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(
            f"chain_step kernel launch failed: CUDA error {err}")
    launches += 1
    return out
