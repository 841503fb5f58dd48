"""label_peak_pct: the harmonic mean of the window's label values (the
work the labels account for over the time they account for), as a share
of the card's data-sheet peak in the label's unit. Host clock: each label
is the program's own differential timing."""


def read(record):
    labels = [r["value"] for r in record["readings"] if r["value"]]
    if not labels:
        return None
    harmonic = len(labels) / sum(1.0 / v for v in labels)
    return 100.0 * harmonic / record["peak"]
