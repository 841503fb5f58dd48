"""device_s_per_reading: the device's busy seconds in the traced window
(the union of its operations; one stream, so their sum) over the number
of readings in it."""


def read(record):
    trace = record["trace"]
    if not trace or not trace["device_ops"]:
        return None
    return trace["busy_s"] / trace["readings"]
