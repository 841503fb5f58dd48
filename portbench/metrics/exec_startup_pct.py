"""exec_startup_pct: the share of the window's exec wall time from each
exec's process start to its first ``probe`` span's open (the program's
spans, tpufd_torch.spans, placed in CLOCK_BOOTTIME by the child): the
interpreter, the imports, argument parsing and CUDA's initialisation.
Each part is measured on its own (portbench.execs.phases): with
exec_between_probes_pct and the share inside probe spans it makes 100%
where the child's spans are placed right. Silent where no exec recorded
a probe."""

from portbench.execs import phases


def read(record):
    split = [p for r in record["readings"] if "exec" in r
             for p in [phases(r["exec"])] if p is not None]
    wall = sum(p[3] for p in split)
    if not wall:
        return None
    return 100.0 * sum(p[0] for p in split) / wall
