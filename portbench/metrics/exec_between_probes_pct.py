"""exec_between_probes_pct: the share of the window's exec wall time
after each exec's first ``probe`` span opened that lies inside no probe
span (the program's spans, tpufd_torch.spans): the probe scheduler,
rating and label output, --metrics-out and the interpreter's exit.
Each part is measured on its own (portbench.execs.phases): the gaps
between probe spans, the last one's close to the child's exit stamp,
and that stamp to the exit the harness saw. With exec_startup_pct and
the share inside probe spans it makes 100% where the child's spans are
placed right. Silent where no exec recorded a probe."""

from portbench.execs import phases


def read(record):
    split = [p for r in record["readings"] if "exec" in r
             for p in [phases(r["exec"])] if p is not None]
    wall = sum(p[3] for p in split)
    if not wall:
        return None
    return 100.0 * sum(p[2] for p in split) / wall
