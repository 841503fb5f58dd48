"""chain_step_roofline_pct: the least time of the chain's steps in the
traced window over the time the fused chain-step kernel ran.

Each call of tpufd_torch.health._matmul_chain(x, n) runs n steps on an
(r, c) bf16 matrix, 2 * r * c * c operations each (2 * 4096^3 at the
cell's size, 0.139 ms at 989 TFLOP/s). On the card every step is one
launch of the kernel named KERNEL (tpufd_torch/csrc/chain_step.cu), the
product with the tail in its epilogue. The measured time is the union of
those launches' intervals, not their sum: each launch starts behind its
predecessor (programmatic dependent launch) and waits there, so the
launches' spans overlap and add up to more than the window. The metric
is silent unless the launches number the steps the recorded calls asked
for, so a chain taken off the kernel, or one that skips launches, reads
nothing rather than fast."""

from portbench.trace import union_ns

KERNEL = "chain_step_kernel"
TARGET = "tpufd_torch.health:_matmul_chain"


def _flops(x, n):
    return {"flops": 2 * x.shape[0] * x.shape[1] * x.shape[1] * n,
            "steps": n}


SPANS = {TARGET: _flops}


def read(record):
    trace = record["trace"]
    calls = record["spans"].get(TARGET, [])
    if not trace or not calls:
        return None
    launches = sorted((s, e) for name, s, e, _ in trace["device_ops"]
                      if KERNEL in name)
    if not launches or len(launches) != sum(c["steps"] for c in calls):
        return None
    ns = sum(e - s for s, e in union_ns(launches))
    least_s = sum(c["flops"] for c in calls) / (
        record["peaks"]["bf16_dense_tflops"] * 1e12)
    return 100.0 * least_s / (ns / 1e9)
