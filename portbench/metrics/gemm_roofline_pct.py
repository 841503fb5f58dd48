"""gemm_roofline_pct: the least time of the chain's GEMMs in the traced
window over their measured time.

Each call of tpufd_torch.health._matmul_chain(x, n) runs n products x @ x
of an (r, c) bf16 matrix, 2 * r * c * c operations each (2 * 4096^3 at
the cell's size, 0.139 ms at 989 TFLOP/s). The measured time is that of
every device operation the profiler links to "aten::mm" (cuBLAS's kernel
and its memset). The metric is silent when no operation is linked to it,
as when the product leaves aten::mm."""

LAUNCHER = "aten::mm"
TARGET = "tpufd_torch.health:_matmul_chain"


def _flops(x, n):
    return {"flops": 2 * x.shape[0] * x.shape[1] * x.shape[1] * n}


SPANS = {TARGET: _flops}


def read(record):
    trace = record["trace"]
    calls = record["spans"].get(TARGET, [])
    if not trace or not calls:
        return None
    ns = sum(e - s for _, s, e, launcher in trace["device_ops"]
             if launcher == LAUNCHER)
    if not ns:
        return None
    least_s = sum(c["flops"] for c in calls) / (
        record["peaks"]["bf16_dense_tflops"] * 1e12)
    return 100.0 * least_s / (ns / 1e9)
