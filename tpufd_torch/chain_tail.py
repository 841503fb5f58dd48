"""The matmul chain's elementwise tail, fused: acc = 0.5 * (tanh(p) + acc).

``chain_tail`` launches the CUDA kernel in ``csrc/chain_tail.cu`` (the
counterpart of XLA's fusion of the chain body in
``tpufd/health.py::_matmul_chain``) for CUDA bf16 tensors, and runs the
plain PyTorch version ``chain_tail_plain`` for CPU tensors. The chain
takes it for every matrix that the fused step of
``tpufd_torch.chain_step`` does not take: every CPU matrix, and CUDA
ones of another dtype, shape or alignment. It never
falls back from the kernel to the plain version. Both write into ``acc``
and return it. ``launches`` counts kernel launches, so a run can show
that its path went through the kernel.
"""

import ctypes

import torch

from tpufd_torch import _build

# Kernel launches made by chain_tail(); the plain version never counts.
launches = 0

_library = None


def _kernel():
    """The C entry point tpufd_chain_tail, as a ctypes function."""
    global _library
    if _library is None:
        lib = _build.load("chain_tail")
        lib.tpufd_chain_tail.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_void_p]
        lib.tpufd_chain_tail.restype = ctypes.c_int
        _library = lib
    return _library.tpufd_chain_tail


def _check(p, acc):
    if p.shape != acc.shape or acc.numel() == 0:
        raise ValueError(f"chain_tail takes p and acc of one non-empty "
                         f"shape, got {tuple(p.shape)} and {tuple(acc.shape)}")
    if p.dtype != acc.dtype or not acc.dtype.is_floating_point:
        raise TypeError(f"chain_tail takes p and acc of one floating dtype, "
                        f"got {p.dtype} and {acc.dtype}")
    if p.device != acc.device:
        raise ValueError(f"chain_tail takes p and acc on one device, got "
                         f"{p.device} and {acc.device}")
    if not (p.is_contiguous() and acc.is_contiguous()):
        raise ValueError("chain_tail takes contiguous tensors")


def chain_tail_plain(p, acc):
    """acc = 0.5 * (tanh(p) + acc) in place, computed in float32 and cast
    back once: the plain PyTorch version of the kernel. Returns acc."""
    _check(p, acc)
    out = torch.tanh(p.float()).add_(acc.float()).mul_(0.5)
    return acc.copy_(out)


def chain_tail(p, acc):
    """acc = 0.5 * (tanh(p) + acc) in place for contiguous tensors of one
    shape. CUDA bf16 tensors go through the kernel on the current stream
    (no synchronisation); CPU tensors through chain_tail_plain. Raises on
    any other device, dtype or shape. Returns acc."""
    global launches
    _check(p, acc)
    if acc.device.type == "cpu":
        return chain_tail_plain(p, acc)
    if acc.device.type != "cuda":
        raise ValueError(
            f"chain_tail takes CPU or CUDA tensors, got {acc.device}")
    if acc.dtype != torch.bfloat16:
        raise TypeError(f"the chain_tail kernel takes bfloat16, got "
                        f"{acc.dtype}")
    fn = _kernel()
    with torch.cuda.device(acc.device):
        err = fn(p.data_ptr(), acc.data_ptr(), acc.numel(),
                 torch.cuda.current_stream(acc.device).cuda_stream)
    if err:
        raise RuntimeError(
            f"chain_tail kernel launch failed: CUDA error {err}")
    launches += 1
    return acc
