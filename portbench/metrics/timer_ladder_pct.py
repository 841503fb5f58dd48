"""timer_ladder_pct: the share of the window's timer time spent outside
the calibration step each label rests on, in percent: the warm-up run,
the ladder's earlier steps and the timer's bookkeeping. The program's
``timer`` and accepted ``timer.step`` spans (tpufd_torch.spans), host
clock.

Silent where the program records no spans or its spans are not the
window's readings."""


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
    total = sum(t.seconds for r in readings for t in r["timer"])
    if not total:
        return None
    accepted = sum(s.seconds for r in readings for s in r["timer.step"]
                   if s.attrs.get("accepted"))
    return 100.0 * (total - accepted) / total
