"""label_spread_pct: (largest - smallest) / median of the window's label
values, in percent. Needs two labels."""

import statistics


def read(record):
    labels = [r["value"] for r in record["readings"] if r["value"]]
    if len(labels) < 2:
        return None
    return 100.0 * (max(labels) - min(labels)) / statistics.median(labels)
