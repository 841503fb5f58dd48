"""reading_s: the window's wall time, from the first reading's start to
the last reading's end, over the number of readings it took, raised ones
included. Host clock."""


def read(record):
    readings = record["readings"]
    if not readings:
        return None
    return (readings[-1]["end"] - readings[0]["start"]) / len(readings)
