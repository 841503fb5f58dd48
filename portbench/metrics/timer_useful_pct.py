"""timer_useful_pct: the loop iterations the window's labels rest on over
every loop iteration their timer ran, in percent: the program's
``timer`` spans (tpufd_torch.spans), iterations_label over
iterations_run, each summed over the window's timer calls.

The ladder sets it. The timer warms up on its first run (2n), times its
first step (three pairs of n and 2n, 9n iterations), skips the lengths
that step predicts short and accepts the next: a matmul reading runs
16 + 9 * 8 + 9 * 2048 = 18,520 chain steps for a label of 2048, 11.06%;
a DMA-copy or stream reading 32 + 9 * 16 + 9 * 1024 = 9,392 repeats or
flips for 1024, 10.90%. Silent where the program records no spans or its
spans are not the window's readings."""


def read(record):
    try:
        from tpufd_torch import spans
    except ImportError:
        return None
    readings = spans.window(
        [[n for call in r["timer"] for n, _ in call["runs"]]
         for r in record["readings"]])
    if readings is None:
        return None
    timers = [t for r in readings for t in r["timer"]]
    ran = sum(t.attrs["iterations_run"] for t in timers)
    if not ran:
        return None
    return 100.0 * sum(t.attrs["iterations_label"] for t in timers) / ran
