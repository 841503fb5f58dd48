"""step_mfu_pct: the matmul chain's operations in the traced window over
the window's length, as a share of the card's bf16 peak.

The operations are those of the probe body's products, 2 * r * c * c for
each step of tpufd_torch.health._matmul_chain(x, n) on an (r, c) matrix,
whatever kernels run them: the whole step's share of the peak, which
bounds the GEMM's roofline and the tail's time together."""

TARGET = "tpufd_torch.health:_matmul_chain"


def _flops(x, n):
    return {"flops": 2 * x.shape[0] * x.shape[1] * x.shape[1] * n}


SPANS = {TARGET: _flops}


def read(record):
    trace = record["trace"]
    calls = record["spans"].get(TARGET, [])
    if not trace or not calls or not trace["device_ops"]:
        return None
    flops = sum(c["flops"] for c in calls)
    return 100.0 * flops / trace["window_s"] / (
        record["peaks"]["bf16_dense_tflops"] * 1e12)
