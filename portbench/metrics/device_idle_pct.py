"""device_idle_pct: the share of the traced window in which no device
operation runs (torch.profiler, CUPTI's kernel, copy and set records)."""


def read(record):
    trace = record["trace"]
    if not trace or not trace["window_s"] or not trace["device_ops"]:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
