"""The HBM stream probe's output check: the body the readings run
(`health._stream`, n in-place `neg_` flips), driven at the cell's size
for each n of `flips` on a fresh copy of seeded bf16 bits (every pattern
at the cell's size: NaNs, ±inf, ±0 and subnormals included), against
the plain stream on the bits.

The number compared is the count of elements that differ, summed over
the n of `flips` (`stream_mismatches`); the stream is exact, but for a
NaN input, which must only stay NaN (`reference.stream.mismatches`).
The control is the plain stream through float8_e4m3fn, the precision
below bf16.

What it cannot see: a flip's output shows only the parity of n, so a
body that keeps the parity but skips flips (8 of 16, or 9 of 17) passes
it. Driving odd and even n catches a body that ignores n or halves it
at one of them; the work count is held by `label_over_peak` instead (a
body that skips more than about a tenth of its flips publishes a label
above 3350 GB/s, the sound one reads about 3016) and by
`stream_roofline_pct`, silent unless the window's `neg_` launches equal
the flips its `_stream` calls asked for."""

import torch

from portbench.reference import stream as reference


def inputs(spec, seed, device):
    g = torch.Generator(device=device)
    g.manual_seed(seed % 2**63)
    bits = torch.randint(-2**15, 2**15, (reference.numel(spec["mib"]),),
                         generator=g, device=device, dtype=torch.int16)
    return bits.view(torch.bfloat16)


def _mismatches(spec, seed, device, produce):
    """stream_mismatches of produce(x, n) over the n of `flips`."""
    x = inputs(spec, seed, device)
    return {"stream_mismatches": sum(
        reference.mismatches(produce(x, n), reference.stream(x, n), x)
        for n in spec["flips"])}


def run(spec, seed, device, body):
    """The program's body on a fresh copy of the seeded input for each n,
    against the reference."""
    return _mismatches(spec, seed, device, lambda x, n: body(x.clone(), n))


def control(spec, seed, device):
    """The reference through float8_e4m3fn in the program's place."""
    return _mismatches(spec, seed, device, lambda x, n: reference.stream(
        x, n, torch.float8_e4m3fn))
