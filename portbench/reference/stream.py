"""The HBM stream probe's body, plainly: n sign flips of a bf16 buffer,
worked on its int16 bits."""

import torch

SIGN = -2**15  # 0x8000 as an int16


def numel(mib):
    """bf16 elements in `mib` MiB: the probe's 1-D buffer."""
    return mib * 1024 * 1024 // 2


def stream(x, n, dtype=torch.bfloat16):
    """x with the sign bit of every element flipped n times, on its bits
    and not through float, then passed through `dtype` (the control's
    float8_e4m3fn)."""
    bits = x.view(torch.int16).clone()
    for _ in range(n):
        bits ^= SIGN
    return bits.view(x.dtype).to(dtype).to(x.dtype)


def mismatches(out, ref, x):
    """Elements of `out` that differ from the reference's stream of `x`.

    An element whose input is NaN must come out NaN, its bits not
    compared: the program's neg_ negates a bf16 through float, and the
    conversions may rewrite a NaN's payload and sign (c10's rounding
    returns one canonical NaN, the vectorised CPU path flips the bit).
    Every other element's bits must equal the reference's, ±0, ±inf and
    subnormals included. Every element counts when the shapes or types
    differ."""
    if tuple(out.shape) != tuple(ref.shape) or out.dtype != ref.dtype:
        return float(ref.numel())
    nan = x.isnan()
    differ = out.view(torch.int16) != ref.view(torch.int16)
    return float(torch.where(nan, ~out.isnan(), differ).sum())
