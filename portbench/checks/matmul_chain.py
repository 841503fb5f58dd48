"""The matmul probe's output check: the chain body the readings run (on
the card, one launch of the fused chain-step kernel a step, the product
with the tail in its epilogue; on the CPU, a product and the plain chain
tail), driven once at the cell's size for the first run's number of
steps on a seeded bf16 input, against the plain chain in bf16.

The input is diag(d) + E: d uniform in [-2, 2], E dense N(0, (0.1 /
sqrt(size))^2). Each diagonal element starts where tanh is saturated
(tanh(d^2) against d^2 up to 4) and decays to about 0.5 over the steps,
so the tail bends on every step; E feeds every product a full dot
product and grows with the diagonal to about the same magnitude. The
chain contracts there, so one rounding apart stays one rounding apart.
(Where the dense part alone has a spectral radius over 1, tanh
saturates on sums whose sign a rounding decides, and the check cannot
tell rounding from a fault.)

The number compared is the widest gap over the reference's largest
magnitude (`chain_gap`). The control is the plain chain with each state
and product stored in float8_e4m3fn, the precision below bf16, scaled by
its largest magnitude, so it keeps the chain's range. FAULTS plants the
faults the check has to catch in the program's chain step and tail."""

import contextlib
import math

import torch

from portbench.reference import chain as reference

DIAGONAL = 2.0
DENSE = 0.1


def inputs(spec, seed, device):
    size = spec["size"]
    g = torch.Generator(device=device)
    g.manual_seed(seed % 2**63)
    d = (torch.rand(size, generator=g, device=device) * 2 - 1) * DIAGONAL
    x = torch.randn((size, size), generator=g, device=device)
    x.mul_(DENSE / math.sqrt(size)).diagonal().add_(d)
    return x.to(torch.bfloat16)


def run(spec, seed, device, body):
    """The program's body on the seeded input, against the reference."""
    x0 = inputs(spec, seed, device)
    out = body(x0.clone(), spec["steps"]).float()
    return {"chain_gap": reference.gap(out, reference.chain(
        x0, spec["steps"]))}


def control(spec, seed, device):
    """The reference in scaled float8_e4m3fn in the program's place."""
    x0 = inputs(spec, seed, device)
    out = reference.chain(x0, spec["steps"], torch.float8_e4m3fn)
    return {"chain_gap": reference.gap(out, reference.chain(
        x0, spec["steps"]))}


@contextlib.contextmanager
def _tail_without_tanh():
    """The chain step computing 0.5 * (p + acc), the bend left out, where
    each path computes it: in place of the fused chain step (the card's,
    out = bf16(0.5 * (bf16(x @ x) + x))) and of the chain tail (any
    other x: the CPU's)."""
    from tpufd_torch import chain_step, chain_tail

    def step(x, out):
        p = (x @ x).float()
        return out.copy_((p + x.float()) * 0.5)

    def tail(p, acc):
        return acc.copy_((p.float() + acc.float()) * 0.5)

    saved = chain_step.chain_step, chain_tail.chain_tail
    chain_step.chain_step, chain_tail.chain_tail = step, tail
    try:
        yield
    finally:
        chain_step.chain_step, chain_tail.chain_tail = saved


FAULTS = {"tail_without_tanh": _tail_without_tanh}
