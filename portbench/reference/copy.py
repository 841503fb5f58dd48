"""The DMA-copy probe's kernel, plainly: out = x, bit for bit."""

import torch


def shape(mib, chunks):
    """(rows, 1024) bf16 of about `mib` MiB, rows a multiple of `chunks`:
    the probe's layout."""
    cols = 1024
    return max(mib * 1024 * 1024 // 2 // cols // chunks, 1) * chunks, cols


def copy(x, dtype=torch.bfloat16):
    """x's copy, passed through `dtype` (the control's float8_e4m3fn)."""
    return x.to(dtype).to(x.dtype)


def mismatches(out, ref):
    """Elements of `out` whose bits differ from the reference's; every
    element when the shapes or types differ."""
    if tuple(out.shape) != tuple(ref.shape) or out.dtype != ref.dtype:
        return float(ref.numel())
    return float((out.view(torch.int16) != ref.view(torch.int16)).sum())
