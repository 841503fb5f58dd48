"""setup_s: seconds from the process's start until the window's first
reading starts (interpreter, imports, CUDA init, kernel libraries, the
cell's warm-up iteration). Host clock (CLOCK_BOOTTIME)."""


def read(record):
    return record["setup_s"]
