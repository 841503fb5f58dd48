"""timer_overshoot_pct: how far past its timer's settle threshold the
differential each label rests on lies, in percent: 100 * (the accepted
``timer.step``'s median difference t(2n) - t(n) over its ``timer``'s
``settle_s`` - 1), the mean over the window's readings. The program's
spans (tpufd_torch.spans), host clock.

A step is accepted once its median reaches settle_s; what the timer runs
past that buys the label nothing, and the accepted step runs it nine
times over (three pairs of 2n and n). Silent where the program records
no spans, its spans are not the window's readings, its ``timer`` spans
hold no ``settle_s``, or no label was accepted."""

import statistics


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
    over = []
    for r in readings:
        settle_s = {t.id: t.attrs.get("settle_s") for t in r["timer"]}
        for step in r["timer.step"]:
            settle = settle_s.get(step.parent)
            if step.attrs.get("accepted") and settle:
                median = statistics.median(step.attrs["differences"])
                over.append(median / settle - 1.0)
    if not over:
        return None
    return 100.0 * statistics.fmean(over)
