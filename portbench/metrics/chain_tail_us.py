"""chain_tail_us: the mean device time of one launch of the fused
chain-tail kernel in the traced window, in microseconds.

A time, not a roofline share: in the window the tail reads the product
that cuBLAS has just written, partly from the 50 MB L2, so the byte
bound at HBM rate (3 * 4096^2 * 2 B at 3350 GB/s, 30.0 us) is no bound
there: a tail launch took 29.5 us on average in the first traced run.
Silent when no kernel named KERNEL runs."""

KERNEL = "chain_tail_kernel"


def read(record):
    trace = record["trace"]
    if not trace:
        return None
    times = [e - s for name, s, e, _ in trace["device_ops"] if KERNEL in name]
    if not times:
        return None
    return sum(times) / len(times) / 1e3
