"""timer_pair_spread_pct: (largest - smallest) / median of the three
differences t(2n) - t(n) of each calibration step a label rests on, the
widest over the window, in percent. The program's accepted
``timer.step`` spans (tpufd_torch.spans).

A host that stalls one run of the three pairs widens it before the
label reads above the card's peak. Silent where the program records no
spans, its spans are not the window's readings, or no label was
accepted."""

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
    spreads = []
    for r in readings:
        for step in r["timer.step"]:
            if step.attrs.get("accepted"):
                d = step.attrs["differences"]
                spreads.append((max(d) - min(d)) / statistics.median(d))
    if not spreads:
        return None
    return 100.0 * max(spreads)
