"""exec_s: the mean wall time of the window's execs, each from its
process start (/proc/<pid>/stat, CLOCK_BOOTTIME) to the moment the
harness saw it exit, less the seconds the launcher spent on the output
checks and on the profiler (portbench.execs.wall_s); failed and killed
execs included. Host clock.

It is this cell's reading_s, one exec a reading, but for the checks'
seconds taken out: a file of its own so that it carries a bound of its
own, since an exec's start-up spreads as reading_s's 1% cannot hold."""

from portbench.execs import wall_s


def read(record):
    execs = [r["exec"] for r in record["readings"] if "exec" in r]
    if not execs:
        return None
    return sum(wall_s(e) for e in execs) / len(execs)
