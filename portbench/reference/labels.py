"""Each probe's label worked out again from the probe's sizes: the work
that `iters` loop iterations do, in the label's unit times seconds. A
sound label is work(kwargs, iters) / seconds, for the `iters` and the
seconds the program's timer returned. `kwargs` are the probe entry's
arguments as the workload file gives them."""

from portbench.reference import copy


def matmul_tflops(kwargs, iters):
    """One (size, size) product a chain step, 2 size^3 operations: TFLOP."""
    return 2.0 * kwargs["size"] ** 3 * iters / 1e12


def dma_copy_gbps(kwargs, iters):
    """A read and a write of the (rows, 1024) bf16 array a repeat: GB."""
    rows, cols = copy.shape(kwargs["mib"], kwargs["chunks"])
    return 2.0 * rows * cols * 2 * iters / 1e9


def hbm_gbps(kwargs, iters):
    """A read and a write of the mib-MiB bf16 buffer an iteration: GB."""
    return 2.0 * kwargs["mib"] * 1024 * 1024 * iters / 1e9
