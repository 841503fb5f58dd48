"""The matmul probe's chain, plainly: acc <- 0.5 * (tanh(acc @ acc) + acc).

The configuration states the chain in bf16: the product of two bf16
matrices accumulated in float32 and rounded to bf16, the tail worked in
float32 from those bf16 values and rounded once. `chain` does exactly
that with `dtype` as the stored type, with TF32 off, so the float32
products are full float32. With a float8 `dtype`, the control, each
stored tensor is scaled by its largest magnitude onto float8's largest
finite value first, so the control keeps the chain's range and loses
only precision."""

import torch


def store(t, dtype):
    """float32 `t` as `dtype` stores it, back in float32; a float8 store
    scales the tensor by its largest magnitude (one scale per tensor)."""
    if dtype.itemsize > 1:
        return t.to(dtype).float()
    scale = t.abs().amax().clamp_min(torch.finfo(torch.float32).tiny) / (
        torch.finfo(dtype).max)
    return (t / scale).to(dtype).float() * scale


def chain(x0, steps, dtype=torch.bfloat16):
    """`steps` chain steps from x0, each state and each product stored as
    `dtype`; returns the last state as float32."""
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        acc = store(x0.float(), dtype)
        for _ in range(steps):
            p = store(acc @ acc, dtype)
            acc = store((torch.tanh(p) + acc) * 0.5, dtype)
        return acc
    finally:
        torch.set_float32_matmul_precision(before)


def gap(out, ref):
    """The widest gap between `out` and the reference, over the
    reference's largest magnitude; inf when `out` is not the reference's
    shape or holds a non-finite value."""
    if tuple(out.shape) != tuple(ref.shape):
        return float("inf")
    diff = (out.float() - ref).abs().max()
    value = float(diff / ref.abs().max())
    return value if value == value else float("inf")  # NaN: no answer
