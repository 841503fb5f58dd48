"""Faults of the label path, planted in the program to show that the
label check fails them: a timer that reports half the seconds (the label
doubles) and a label that counts half the work. Each takes the cell's
workload file and returns a context manager that holds the fault."""

import contextlib
import importlib


@contextlib.contextmanager
def _halved(target):
    """The program's `target` ("module:attr") returning half its value."""
    module_name, _, attr = target.partition(":")
    module = importlib.import_module(module_name)
    original = getattr(module, attr)
    setattr(module, attr, lambda *a, **k: 0.5 * original(*a, **k))
    try:
        yield
    finally:
        setattr(module, attr, original)


LABEL_FAULTS = {
    "halved_time": lambda workload: _halved(workload["label"]["timer"]),
    "halved_work": lambda workload: _halved(workload["entry"]),
}
