"""Each probe's label worked out again from the probe's sizes: the work
that `iters` loop iterations do on `ranks` ranks, in the label's unit
times seconds. A sound label is work(kwargs, iters, ranks=k) / seconds,
for the `iters` and the seconds the program's timer returned on rank 0
of k. `kwargs` are the probe entry's arguments as the workload file
gives them. The probes here run on one card: their work does not depend
on `ranks`."""

from portbench.reference import copy


def matmul_tflops(kwargs, iters, ranks=1):
    """One (size, size) product a chain step, 2 size^3 operations: TFLOP."""
    return 2.0 * kwargs["size"] ** 3 * iters / 1e12


def dma_copy_gbps(kwargs, iters, ranks=1):
    """A read and a write of the (rows, 1024) bf16 array a repeat: GB."""
    rows, cols = copy.shape(kwargs["mib"], kwargs["chunks"])
    return 2.0 * rows * cols * 2 * iters / 1e9


def hbm_gbps(kwargs, iters, ranks=1):
    """A read and a write of the mib-MiB bf16 buffer an iteration: GB."""
    return 2.0 * kwargs["mib"] * 1024 * 1024 * iters / 1e9
