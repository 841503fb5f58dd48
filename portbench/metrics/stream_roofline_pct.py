"""stream_roofline_pct: the least time of the HBM stream's flips in the
traced window over their measured time.

Each call of tpufd_torch.health._stream(x, n) flips x's signs in place n
times, one neg_ launch a flip that reads and writes x: 2 * numel * 2 * n
bytes in bf16, 2 * 2^29 B a flip at the cell's size (0.3205 ms at 3350
GB/s). The measured time is the sum of the trace's kernels whose name
holds KERNEL: PyTorch's elementwise kernel for neg on bf16, which a card
trace (torch 2.11.0+cu128, H100) names "void
at::native::vectorized_elementwise_kernel<8,
at::native::neg_kernel_cuda(at::TensorIteratorBase&)::{lambda()#2}::
operator()() const::{lambda()#9}::operator()() const::
{lambda(c10::BFloat16)#1}, std::array<char*, 2ul> >(...)". The metric is
silent unless their number equals the flips the recorded calls asked
for, so a body that skips launches, or a stream taken off neg_, reads
nothing rather than fast."""

KERNEL = "neg_kernel_cuda"
TARGET = "tpufd_torch.health:_stream"


def _bytes(x, n):
    return {"bytes": 2 * x.numel() * x.element_size() * n, "flips": n}


SPANS = {TARGET: _bytes}


def read(record):
    trace = record["trace"]
    calls = record["spans"].get(TARGET, [])
    if not trace or not calls:
        return None
    times = [e - s for name, s, e, _ in trace["device_ops"]
             if KERNEL in name]
    if not times or len(times) != sum(c["flips"] for c in calls):
        return None
    least_s = sum(c["bytes"] for c in calls) / (record["peaks"]["hbm_gbps"]
                                                * 1e9)
    return 100.0 * least_s / (sum(times) / 1e9)
