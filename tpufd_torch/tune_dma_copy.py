"""Times the DMA-copy kernel's pipeline candidates on one CUDA card.

    python -m tpufd_torch.tune_dma_copy [--rounds 7]

Builds ``csrc/dma_copy.cu`` once per (tile KiB, stages, stores in flight)
candidate, one nvcc each with -D flags, all started together, into
``tune/`` under ``_build.kernel_dir()``, and checks each bit-exact at the
probe's shape (131072 x 1024 bf16 in 2 chunks). Then, in turns, ``rounds``
times: every candidate at n 16, the shipped one also at n 4 and 64 (its
time per repeat stays flat in n when every repeat comes from HBM) and in
1 and 4 chunks, and one whole-array ``copy_``. Prints the card's
``nvidia-smi`` name and power limit, each run's ms per repeat (median,
min, max) with its launch plan, and a JSON line of the same.
Exits non-zero without a card or if a candidate fails to build or to copy.
"""

import argparse
import ctypes
import json
import statistics
import subprocess
import sys

import torch

from tpufd_torch import _build, dma_copy, health

# (tile KiB, stages, stores in flight): the shipped defaults first; one,
# two or four blocks per SM by shared memory.
CANDIDATES = ((32, 6, 1), (32, 6, 2), (32, 6, 3), (64, 3, 1), (16, 12, 1),
              (16, 12, 3), (16, 12, 6), (8, 24, 1), (16, 6, 1), (32, 3, 1),
              (32, 3, 2), (8, 6, 1))
SHAPE = health._dma_copy_shape(256, 2)
CHUNKS = 2


def name_of(candidate):
    return "T{}K-S{}-W{}".format(*candidate)


def build(candidate):
    """Starts nvcc for one candidate: (process, library path)."""
    tile, stages, stores = candidate
    target = (_build.kernel_dir() / "tune"
              / f"libdma_copy-{name_of(candidate)}.so")
    target.parent.mkdir(parents=True, exist_ok=True)
    cmd = _build.nvcc_command("dma_copy", target)
    cmd[1:1] = [f"-DTPUFD_DMA_TILE_KIB={tile}", f"-DTPUFD_DMA_STAGES={stages}",
                f"-DTPUFD_DMA_STORES={stores}"]
    return subprocess.Popen(cmd, text=True, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT), target


def ms_per_repeat(fn, n, reps):
    """Device ms per repeat of fn() over `reps` calls, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps / n


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rounds", type=int, default=7)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tune_dma_copy: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card)
    jobs = {cand: build(cand) for cand in CANDIDATES}
    libs = {}
    for cand, (proc, target) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"tune_dma_copy: {name_of(cand)} failed to "
                             f"build:\n{log}")
        libs[name_of(cand)] = dma_copy.bind(ctypes.CDLL(str(target)))

    torch.cuda.set_device(0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(SHAPE, generator=gen, device="cuda").to(torch.bfloat16)
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream().cuda_stream

    def launch(lib, n, chunks=CHUNKS):
        err = lib.tpufd_dma_copy(x.data_ptr(), out.data_ptr(), *SHAPE,
                                 chunks, n, stream)
        if err:
            raise SystemExit(f"tune_dma_copy: launch failed: CUDA error "
                             f"{err}")

    plans = {}
    for name, lib in libs.items():
        out.zero_()
        launch(lib, 3)
        torch.cuda.synchronize()
        if not torch.equal(out.view(torch.int16), x.view(torch.int16)):
            raise SystemExit(f"tune_dma_copy: {name} output is not its input")
        plan = (ctypes.c_longlong * len(dma_copy.PLAN_KEYS))()
        if lib.tpufd_dma_copy_plan(*SHAPE, CHUNKS, plan):
            raise SystemExit(f"tune_dma_copy: {name} plan failed")
        plans[name] = dict(zip(dma_copy.PLAN_KEYS, plan))

    shipped = next(iter(libs))
    runs = [(name, lambda lib=lib: launch(lib, 16), 16)
            for name, lib in libs.items()]
    runs += [(f"{shipped} n {n}", lambda n=n: launch(libs[shipped], n), n)
             for n in (4, 64)]
    runs += [(f"{shipped} chunks {c}",
              lambda c=c: launch(libs[shipped], 16, c), 16) for c in (1, 4)]
    runs.append(("copy_", lambda: out.copy_(x), 1))
    times = {name: [] for name, _, _ in runs}
    for _ in range(args.rounds):
        for name, fn, n in runs:
            times[name].append(ms_per_repeat(fn, n, 5 if n > 1 else 20))
    moved = 2 * x.numel() * x.element_size()
    bound_ms = moved / (health.RATED_HBM_GBPS["h100-sxm"] * 1e9) * 1e3
    print(f"ms per repeat at {SHAPE} bf16, {CHUNKS} chunks and n 16 "
          f"unless named, {args.rounds} rounds; bound {bound_ms:.4f} ms")
    summary = {}
    for name, ts in times.items():
        plan = plans.get(name)
        summary[name] = {"median": statistics.median(ts), "min": min(ts),
                         "max": max(ts), "plan": plan}
        where = (f"; {plan['blocks_per_chunk']} blocks/chunk, "
                 f"{plan['resident_per_sm']}/SM, {plan['smem_bytes']} B"
                 if plan else "")
        print(f"  {name:<16} median {summary[name]['median']:.4f} "
              f"min {min(ts):.4f} max {max(ts):.4f} "
              f"({bound_ms / summary[name]['median']:.1%} of bound{where})")
    print(json.dumps({"card": card, "shape": list(SHAPE), "chunks": CHUNKS,
                      "bound_ms": bound_ms, "ms_per_repeat": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
