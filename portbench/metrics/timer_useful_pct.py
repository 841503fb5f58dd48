"""timer_useful_pct: the loop iterations the window's labels rest on over
every loop iteration their timer ran, in percent: the program's
``timer`` spans (tpufd_torch.spans), iterations_label over
iterations_run, each summed over the window's timer calls.

The ladder sets it: the matmul probe runs 16 + 9 * 2728 = 24,568 chain
steps for a label of 2048, 8.34%. Silent where the program records no
spans or its spans are not the window's readings."""


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
