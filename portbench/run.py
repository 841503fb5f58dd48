"""The port's benchmark: one run of one cell on the cards it asks for.

    python3 portbench/run.py --workload health.matmul --seed 7 \
        --seconds 45 --trace 0

From the root of a checkout. The cell's window is one closed-loop reader
of the probe entry its workload file names (`portbench/harness.py`). A
cell of k > 1 chips runs over k ranks of one NCCL group, one process per
card: this process is rank 0 on cuda:0 and starts the others.
With `--trace 0` the last line of standard output holds the cell's
end-to-end metrics, with `--trace 1` its per-layer metrics, read from
torch.profiler over the window. Every run checks the program's output
against the plain reference and prints each number compared beside its
limit, as the last lines of standard error and under "checks", last in
the result's line.

Per-reading labels, times and timer calls, the set-up's split (with the
kernel libraries a checkout's first run built), the trace's summary and
nvidia-smi's clocks and power beside the window go to
$TMPDIR/portbench/. Kernel libraries and compiler caches live under
build/portbench/ in the checkout, so only a checkout's first run builds.

It exits non-zero and prints no result without a CUDA card (or with
fewer cards than the cell asks for), when the card has no peaks in
portbench/peaks.json, when the process (or, over several ranks, any
rank's) holds a module of JAX or of the JAX package once the window has
closed, and when a rank raises outside a reading, dies or stalls (4,
naming the rank on stderr, within harness.PAST_WINDOW_S of the window's
close).
"""

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path


def process_start():
    """The CLOCK_BOOTTIME second this process began (/proc/self/stat's
    starttime, in clock ticks since boot)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rpartition(")")[2].split()
    return int(fields[19]) / os.sysconf("SC_CLK_TCK")


STARTED = process_start()
ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "build" / "portbench"
# Fixed directories inside the checkout: only its first run builds.
os.environ["TPUFD_TORCH_KERNEL_DIR"] = str(CACHE / "kernels")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda_cache")
sys.path[:] = [str(ROOT)] + [p for p in sys.path
                             if Path(p or ".").resolve() != ROOT / "portbench"]

SMI_FIELDS = "timestamp,clocks.sm,clocks.mem,power.draw,power.limit," \
             "temperature.gpu,utilization.gpu"


def _boot_s():
    return time.clock_gettime(time.CLOCK_BOOTTIME)


def _finite(value):
    if isinstance(value, float) and not math.isfinite(value):
        return str(value)
    return value


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    imports = _boot_s()
    import torch

    from portbench import harness

    chips = harness.cell_spec(args.workload)["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        sys.stderr.write(f"portbench: {args.workload} needs {chips} CUDA "
                         f"card(s); torch sees "
                         f"{torch.cuda.device_count()}\n")
        return 2
    cuda = _boot_s()
    torch.cuda.init()
    cuda_done = _boot_s()
    sys.stderr.write(f"portbench: set-up: interpreter {imports - STARTED:.3f} "
                     f"s, imports {cuda - imports:.3f} s, CUDA init "
                     f"{cuda_done - cuda:.3f} s\n")
    out = (Path(os.environ.get("TMPDIR") or tempfile.gettempdir())
           / "portbench" / f"{args.workload}.seed{args.seed}.trace"
           f"{args.trace}")
    out.mkdir(parents=True, exist_ok=True)
    libraries = _listing(Path(os.environ["TPUFD_TORCH_KERNEL_DIR"]))
    try:
        result, readings, summary = harness.run_cell(
            args.workload, args.seed, args.seconds, bool(args.trace),
            torch.device("cuda", 0), process_start=STARTED,
            beside=lambda: _smi(out / "smi.csv"))
    except harness.RankFault as e:
        sys.stderr.write(f"portbench: {e}\n")
        return harness.RANK_FAULT_EXIT
    result["device"]["power_limit_w"] = _power_limit(out / "smi.csv")
    # A checkout's first run builds the kernel libraries in its set-up;
    # the build is recorded apart from the runs that find them built.
    built = sorted(_listing(Path(os.environ["TPUFD_TORCH_KERNEL_DIR"]))
                   - libraries)
    setup = {"interpreter_s": imports - STARTED, "imports_s": cuda - imports,
             "cuda_init_s": cuda_done - cuda, "built": built}
    with open(out / "setup.json", "w") as f:
        json.dump(setup, f, indent=1)
    if built:
        sys.stderr.write(f"portbench: set-up: a checkout's first run, it "
                         f"built {built}\n")

    found = harness.forbidden_modules()
    if found:
        sys.stderr.write(f"portbench: the process holds {found}, the "
                         f"JAX stack or the JAX package\n")
        return 3
    with open(out / "readings.json", "w") as f:
        json.dump(readings, f, indent=1)
    if summary is not None:
        with open(out / "trace.json", "w") as f:
            json.dump({k: v for k, v in summary.items()
                       if k != "device_ops"}, f, indent=1)
    sys.stderr.write(f"portbench: readings, trace summary and nvidia-smi "
                     f"samples in {out}\n")
    for name, c in result["checks"].items():
        sys.stderr.write(f"check {name}: {c['value']!r} limit "
                         f"{c['limit']!r}\n")
    sys.stderr.flush()
    result["checks"] = {k: {"value": _finite(c["value"]),
                            "limit": c["limit"]}
                        for k, c in result["checks"].items()}
    print(json.dumps(result), flush=True)
    return 0


@contextlib.contextmanager
def _smi(path):
    """nvidia-smi sampling the card's clocks and power once a second into
    `path` while the window runs; nothing where there is no nvidia-smi."""
    with open(path, "w") as sink:
        try:
            smi = subprocess.Popen(
                ["nvidia-smi", f"--query-gpu={SMI_FIELDS}", "--format=csv",
                 "--id=0", "-lms", "1000"],
                stdout=sink, stderr=subprocess.DEVNULL)
        except OSError:
            smi = None
        try:
            yield
        finally:
            if smi is not None:
                smi.terminate()
                smi.wait()


def _listing(directory):
    return set(os.listdir(directory)) if directory.is_dir() else set()


def _power_limit(path):
    """The card's power limit in watts, from the samples' last row."""
    try:
        rows = path.read_text().strip().splitlines()
        return float(rows[-1].split(",")[4].split()[0])
    except (OSError, IndexError, ValueError):
        return None


if __name__ == "__main__":
    sys.exit(main())
