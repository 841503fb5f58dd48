"""The readings that a cell's check limits are set from, on the card.

    python3 portbench/calibrate.py --workload health.matmul \
        --seeds 1-12 --control-seeds 101-103 --readings 12

In one process, on the cell's sizes:

  - the output check on the program (the body its workload file names)
    on every seed of `--seeds`;
  - the control, the plain reference in the precision below the
    configuration's put in the program's place, and each fault of the
    check module's FAULTS planted in the program, on every seed of
    `--control-seeds`;
  - the label check over `--readings` readings of the cell's entry, as
    the window takes them, then over `--fault-readings` readings under
    each of `portbench.faults.LABEL_FAULTS`.

One JSON line per reading, then a summary line: the largest number of
the program's sound runs and the smallest of the control's and of each
fault's, the readings a limit lies between.
"""

import argparse
import contextlib
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import run  # noqa: E402,F401 -- sets the caches


def seeds(text):
    """"1-12" or "1,5,9" as a list of ints."""
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi or lo) + 1))
    return out


def _fold(into, numbers, pick):
    for key, value in numbers.items():
        into[key] = pick(into.get(key, value), value)


def _print(**line):
    print(json.dumps(line), flush=True)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=seeds, required=True)
    parser.add_argument("--control-seeds", type=seeds, required=True)
    parser.add_argument("--readings", type=int, default=0)
    parser.add_argument("--fault-readings", type=int, default=2)
    args = parser.parse_args(argv)

    import torch

    from portbench import harness
    from portbench.faults import LABEL_FAULTS

    if not torch.cuda.is_available():
        sys.stderr.write("calibrate: no CUDA card\n")
        return 2
    device = torch.device("cuda", 0)
    workload = harness.cell_spec(args.workload)["workload"]
    spec = workload["check"]
    checker = harness.check_module(spec["module"])
    body = harness.resolve(spec["body"])
    program, lower = {}, {}
    for seed in args.seeds:
        numbers = checker.run(spec, seed, device, body)
        _print(side="program", seed=seed, **numbers)
        _fold(program, numbers, max)
    planted = {"control": contextlib.nullcontext,
               **getattr(checker, "FAULTS", {})}
    for name, plant in planted.items():
        lower[name] = {}
        for seed in args.control_seeds:
            with plant():
                numbers = (checker.control(spec, seed, device)
                           if name == "control"
                           else checker.run(spec, seed, device, body))
            _print(side=name, seed=seed, **numbers)
            _fold(lower[name], numbers, min)

    label = workload["label"]

    def readings(count):
        entry = harness.resolve(workload["entry"])
        calls, out = [], []
        with harness.recording_timer(label["timer"], calls):
            for _ in range(count):
                out += harness.closed_loop(
                    lambda: entry(device, **workload["kwargs"]), 0,
                    contextlib.nullcontext, calls)
        return out

    if args.readings:
        for reading in readings(args.readings):
            numbers = harness.label_numbers([reading], label,
                                            workload["kwargs"])
            _print(side="label", value=reading["value"],
                   seconds=reading["end"] - reading["start"], **numbers)
            _fold(program, numbers, max)
        for name, plant in LABEL_FAULTS.items():
            lower[name] = {}
            with plant(workload):
                faulty = readings(args.fault_readings)
            for reading in faulty:
                numbers = harness.label_numbers([reading], label,
                                                workload["kwargs"])
                _print(side=name, value=reading["value"], **numbers)
                _fold(lower[name], numbers, min)
    _print(workload=args.workload, kind=torch.cuda.get_device_name(device),
           program_max=program, least=lower,
           limits={**spec["limits"], **label["limits"]})
    return 0


if __name__ == "__main__":
    sys.exit(main())
