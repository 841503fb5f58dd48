"""exec_label_pct: the harmonic mean, over the labels the window's sound
execs published (matmul-tflops, hbm-gbps, dma-copy-gbps: whole numbers,
each the median of three readings), of each label over its data-sheet
peak, in percent: what the published labels say the card does. Host
clock: each label is the program's own differential timing.

It is label_peak_pct's definition over the three labels, each held to
its own peak: a file of its own so that the cell's bound is its own,
set from the exec's runs and not the label cells'."""


def read(record):
    labels = record["workload"].get("labels", {})
    shares = [float(value) / record["peaks"][labels[name]["peak"]]
              for r in record["readings"]
              if "exec" in r and r["error"] is None
              for name, value in r["exec"]["labels"].items()]
    if not shares or not all(shares):
        return None
    return 100.0 * len(shares) / sum(1.0 / s for s in shares)
