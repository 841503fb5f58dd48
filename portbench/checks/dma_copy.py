"""The DMA-copy probe's output check: the copy kernel the readings run,
driven once at the cell's shape and chunks for the first run's number of
repeats, on seeded bf16 bits (every pattern, NaNs included), against the
plain copy.

The number compared is the count of elements whose bits differ
(`copy_mismatches`); a copy is exact. The control is the plain copy
through float8_e4m3fn, the precision below bf16."""

import torch

from portbench.reference import copy as reference


def inputs(spec, seed, device):
    g = torch.Generator(device=device)
    g.manual_seed(seed % 2**63)
    bits = torch.randint(-2**15, 2**15,
                         reference.shape(spec["mib"], spec["chunks"]),
                         generator=g, device=device, dtype=torch.int16)
    return bits.view(torch.bfloat16)


def run(spec, seed, device, body):
    """The program's body on the seeded input, against the reference."""
    x = inputs(spec, seed, device)
    out = body(x, spec["repeats"], spec["chunks"])
    return {"copy_mismatches": reference.mismatches(out, reference.copy(x))}


def control(spec, seed, device):
    """The reference through float8_e4m3fn in the program's place."""
    x = inputs(spec, seed, device)
    out = reference.copy(x, torch.float8_e4m3fn)
    return {"copy_mismatches": reference.mismatches(out, reference.copy(x))}

