"""dma_copy_roofline_pct: the least time of the DMA-copy kernel's repeats
in the traced window over their measured time.

Each call of tpufd_torch.dma_copy.dma_copy(x, n, chunks) is one launch
that reads x and writes its copy n times: 2 * numel * 2 * n bytes in
bf16, 2 * 131072 * 1024 * 2 B a repeat at the cell's size (0.1603 ms at
3350 GB/s). The measured time is the sum of the trace's kernels named
KERNEL; the metric is silent unless each recorded call has its launch in
the window, so a kernel taken off the path reads nothing."""

KERNEL = "dma_copy_kernel"
TARGET = "tpufd_torch.dma_copy:dma_copy"


def _bytes(x, n, chunks):
    return {"bytes": 2 * x.numel() * x.element_size() * n}


SPANS = {TARGET: _bytes}


def read(record):
    trace = record["trace"]
    calls = record["spans"].get(TARGET, [])
    if not trace or not calls:
        return None
    times = [e - s for name, s, e, _ in trace["device_ops"]
             if KERNEL in name]
    if len(times) != len(calls):
        return None
    least_s = sum(c["bytes"] for c in calls) / (record["peaks"]["hbm_gbps"]
                                                * 1e9)
    return 100.0 * least_s / (sum(times) / 1e9)
