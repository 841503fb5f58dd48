#!/usr/bin/env python3
"""Drives the PyTorch port (tpufd_torch) on one CUDA card and checks it.

    python3 chip_smoke.py

Run from the root of a checkout: it builds the kernels from the sources
there. Phases, one line or more each; any failure exits non-zero and no
phase catches an exception:

  1. the card: `nvidia-smi` name and power limit;
  2. build every kernel (one nvcc per source, all started together); then
     the matmul probe (median of 3), read first in the process;
  3. every kernel against its plain PyTorch version on the card. The DMA
     copy: bit-exact at the probe's shape and at small, ragged and
     misaligned ones, and at its edges (chunks 3, one row per chunk,
     chunks smaller than a tile and a tile plus 16 bytes, more chunks
     than the grid holds); its C entry point with the output inside a
     sentinel-filled buffer, which must stay untouched around it; its
     launch plan; the wrapper's refusal of a bad row count; kernel,
     plain-version and library-call times beside the bound, the kernel's
     time at 2n over its time at n, and the kernel no faster than `copy_`
     beyond COPY_NOISE. The chain tail: equal to its plain version or at
     most 1 bf16 ulp apart (the count of elements that differ printed) at
     the probe's shape, ragged shapes, inputs 6 bytes off a 16-byte
     boundary and every finite bf16 bit pattern; its C entry point with
     acc inside a sentinel-filled buffer; its time beside its byte bound,
     its plain version and the three eager passes it replaced, which it
     must beat. Then the matmul probe read again;
  4. the slice: health_labels(extended=True) on cuda:0, with every kernel
     launch count set to 0 just before and read just after, and the
     `dma-copy-gbps` label no higher than `copy_`'s rate beyond
     COPY_NOISE; then each probe's device, wall and enqueue time per
     iteration, and one chain step split into its product, the three-pass
     tail and the fused tail;
  5. perfmodel's output lines, in the grammar the daemon parses;
  6. the burn-in forward at entry() width, bf16 on the card against the
     port's float32 forward on the host; the train step: run_burnin and
     the `burnin` command on the card, and 2 steps on the card in bf16
     against the same 2 steps in float32 on the host, loss and
     parameters;
  7. multi-card: one NCCL rank per visible card (launch.spawn_ranks; the
     world size and NCCL version printed first), each running the sharded
     run_burnin (2 steps, reference width), its loss finite and within
     rel 1e-2 of the one-card loss at the same (data, model) shape, the
     collectives of one sharded step counted by CommDebugMode; ring
     attention in both modes at the reference's defaults, within 1e-4 of
     full attention; allreduce_gbps at 64 MiB (at one rank the reference's
     byte count is 0, so only a finite value is required); then, in a
     process group of its own as the `burnin` command runs it,
     burnin.ring_acceptance, both modes within 1e-4, and its time from
     spawn to result. With more than one card, health_labels must also
     publish allreduce-gbps;
  8. the daemon: build it from the checkout's C++ sources (cmake +
     ninja, or g++ from CMakeLists.txt's core sources); fill a kernel
     directory with `python -m tpufd_torch._build`, from which every
     exec of the phase loads its kernels (TPUFD_TORCH_KERNEL_DIR set, no
     directory holding nvcc on PATH); split a fresh exec's start-up
     (`python -X importtime`, the first CUDA op, loading and first
     launching the kernels). Then start the daemon on the mock v5e-4
     topology with --device-health=full execing `tpufd_torch health
     --extended` and --perf-characterize execing `tpufd_torch perfmodel`,
     wait for both execs on the card and check the feature file: the
     health labels (ok, the three probes, none degraded, each within
     PERF_TOL of phase 4's, the enumeration cross-check), the exec's
     textfile (it passes metrics.validate_exposition, tpufd_health_ok
     reads 1, the DMA probe's time), the perf labels within PERF_TOL of
     phase 5's line; print what else it published; read its flight
     recorder with `tpufd_torch journal` over HTTP (probe-ok of health,
     perf-measure) and from a SIGUSR1 dump. The daemon rates the perf
     exec's readings by a stand-in --rated-specs-file that gives the
     mock's family (v5e) this card's figures: its tpu.perf.* labels
     (pct-of-rated and class among them) must equal
     perfmodel.expected_labels of the newest perf-measure event's
     readings, classed by perfmodel.classify. The whole journal, merged
     by journal.merge_events over two scrapes, must hold no health
     transition that the port's healthsm calls illegal; stop it with
     SIGTERM. Then start it again with --device-health=off and the
     in-tree device-health plugin in its --plugin-dir, execing the same
     health command through TFD_PLUGIN_HEALTH_EXEC under
     --plugin-timeout PLUGIN_TIMEOUT_S, and check the same health labels
     and textfile, a plugin-discovered and no plugin-kill event, no
     illegal health transition and no plugin.plugin_violations. The
     kernel directory
     must be unchanged after the execs. Each line carries its wall time
     since the phase began; the last compares the health exec's wall
     time in-process, under the daemon and behind the plugin;
  9. the fleet path: start the port's fake apiserver
     (tpufd_torch.fakes.apiserver) in this process and run the daemon on
     the card as phase 8 runs it, but publishing through its NodeFeature
     CR sink (--use-node-feature-api) into the fake as CARD_NODE. The CR's
     tpu.health.* labels are held against phase 4 and its tpu.perf.*
     labels against perfmodel.expected_labels of the perf-measure event;
     the change named by the CR's change-id annotation is read back from
     /debug/trace through trace.parse_trace and records_for_change, must
     reach publish-acked, and its stage_durations_ms are printed. Then
     three peer CRs drawn from PEER_SEED (gold, silver, degraded) join it,
     and the daemon runs in its fleet modes against the fake, each answer
     held to the port's twin fed the same CRs: --mode=aggregator (the
     tfd-cluster-inventory labels equal agg.InventoryStore's rollup, the
     fleet matmul p10/p50 from the card's reading among them),
     --mode=placement (a battery of POST /v1/placements equal to
     placement.PlacementIndex.query; the card's node must be a candidate
     for a job of its class and chips, and its rank is printed), and
     --mode=remedy in its default dry run, while the degraded peer flaps
     REMEDY_FLAPS times and the inventory asks for QUEUED_CHIPS (its
     journal, read with `tpufd_torch journal`, must hold a cordon intent
     for that peer, none for the card's node, the same intents as
     remedy.RemedyEngine fed the same streams, and its engine state must
     be the twin's render_json). Every daemon of the phase is killed by
     its tag on any exit;
 10. a `{"kernels": [...]}` line;
 11. as the last line, `{"ok": true, "device": {...}}`.
"""

import contextlib
import io
import json
import math
import os
import re
import shlex
import shutil
import signal
import subprocess
import sys
import tempfile
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import distribute_tensor
from torch.distributed.tensor.debug import CommDebugMode

from tpufd_torch import _build, agg, burnin, chain_tail, dma_copy
from tpufd_torch import graft_entry, health, healthsm, journal, launch, mesh
from tpufd_torch import metrics, perfmodel, placement, plugin, remedy, sink
from tpufd_torch import trace
from tpufd_torch import __main__ as cli
from tpufd_torch.fakes import free_loopback_port
from tpufd_torch.fakes.apiserver import FakeApiServer

PREFIX = "google.com/tpu.health."
PERF_PREFIX = "google.com/tpu.perf."  # the daemon's perf labels
DEVICE = torch.device("cuda", 0)
PROBE_SHAPE = health._dma_copy_shape(256, 2)  # health --extended's array
# Burn-in forward, bf16 on the card against float32 on the host: outputs
# reach a few units, where one bf16 ulp is 1.6e-2, and the hidden layer
# is rounded to bf16 before the second product.
BURNIN_RTOL, BURNIN_ATOL = 2e-2, 5e-2
SENTINEL = -21846  # 0xaaaa, the int16 canary around an output
# A copy that beats the card's own copy_ of the same array by more than
# this factor is served partly from L2, not HBM: its time and its label
# would overstate the memory. Runs of one card differ by about 2%.
COPY_NOISE = 1.03
CHAIN_SHAPE = (4096, 4096)  # the matmul probe's array on the card
# The train step, bf16 on the card against float32 on the host, as the
# CPU tests hold the port's bf16 step against the reference's: the loss
# within rel 2e-2; each parameter within one bf16 ulp of its value
# (rtol 8e-3) beside half the tensor's largest update (a weight within a
# few updates of zero is mostly update, whose gradient bf16 rounds).
TRAIN_LOSS_RTOL, TRAIN_PARAM_RTOL, TRAIN_UPDATE_SHARE = 2e-2, 8e-3, 0.5
# The data sheet's float32 rate outside the tensor cores (FLOP/s), for the
# chain tail's operation bound.
FP32_FLOPS = 67e12
# The sharded burn-in loss against the one-card loss at the same shape:
# both bf16 on the card, the sharded one summing partial products in
# another order.
SHARDED_LOSS_RTOL = 1e-2
RING_TOL = 1e-4  # float32 ring attention against full attention
REPO = Path(__file__).resolve().parent
DAEMON = REPO / "build" / "tpu-feature-discovery"
MOCK_TOPOLOGY = "tests/fixtures/v5e-4.yaml"  # enumerates 4 chips
MOCK_CHIPS = 4
MOCK_FAMILY = "v5e"  # the family the daemon rates the mock's chips by
# The daemon runs its device-exclusive sources one at a time: health
# --extended (about 34 s on the card) and perfmodel (about 27 s), each
# behind an interpreter start, the `torch` import and CUDA init.
DAEMON_DEADLINE_S = 300
# The daemon's perf labels against phase 5's in-process line: the probes
# spread about 2% between runs; a child on the host or on another card
# reads far outside this.
PERF_TOL = 0.10
# Set in the daemon's environment, so every process it starts carries
# it and none outlives the phase.
DAEMON_TAG = "TPUFD_CHIP_SMOKE_DAEMON"
PLUGIN = REPO / "deployments" / "plugins" / "device-health"
# The plugin's kill deadline. --plugin-timeout defaults to 30 s, and
# health --extended took 40-44 s under the daemon: the plugin would be
# killed and publish ok=false.
PLUGIN_TIMEOUT_S = 180
# Phase 9, the fleet path: the fake apiserver's namespace, the card's
# node, its three seeded peers (each one's perf class and the ranges its
# matmul TFLOP/s and HBM GB/s are drawn from), and the seed they are
# drawn with.
FLEET_NS = "tfd-fleet"
CARD_NODE = "chip-smoke-card"
PEERS = {"peer-gold": ("gold", (900.0, 980.0), (3000.0, 3300.0)),
         "peer-silver": ("silver", (700.0, 880.0), (2500.0, 3000.0)),
         "peer-degraded": ("degraded", (200.0, 450.0), (800.0, 1500.0))}
PEER_SEED = 2026
INVENTORY = "tfd-cluster-inventory"  # the aggregator's output CR
# The remediation controller's windows, short as the reference's own
# drill sets them (tests/test_remedy.py). A node that reads degraded
# from its first observation draws no cordon: placement fences it
# already. The controller cordons a crash-looping node, one whose
# eligibility goes down REMEDY_FLAPS times inside REMEDY_WINDOW_S.
REMEDY_WINDOW_S, REMEDY_FLAPS = 10, 3
# The runner's queued-demand bridge label on the inventory CR
# (src/tfd/remedy/remedy.h kQueueDemandLabel); more chips than the fleet
# holds asks for a rebuild.
QUEUE_DEMAND = "google.com/tpu.queue.demand-chips"
QUEUED_CHIPS = 64
FLEET_DEADLINE_S = 30  # for a fleet daemon to answer as its twin does


def fail(message):
    raise SystemExit(f"chip_smoke: FAIL: {message}")


def require(condition, message):
    if not condition:
        fail(message)


def cuda_ms(fn, reps):
    """Mean device milliseconds of fn() over `reps` calls, from CUDA
    events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def phase_card():
    require(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    family = health.family_of(DEVICE)
    print(f"[1 card] {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {torch.cuda.device_count()} visible | "
          f"rated family {family}")
    return family


def phase_build():
    t0 = time.perf_counter()
    logs = _build.build()
    print(f"[2 build] {len(logs)} kernel(s) built in "
          f"{time.perf_counter() - t0:.2f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"    {name}: {line.strip()}")


def check_dma_copy(x, n, chunks):
    """Kernel against plain version on the same input: bit-exact, and
    equal to the input. Returns the max abs difference."""
    got = dma_copy.dma_copy(x, n, chunks)
    want = dma_copy.dma_copy_plain(x, n, chunks)
    torch.cuda.synchronize()
    label = f"shape {tuple(x.shape)} chunks {chunks} n {n}"
    require(torch.equal(got.view(torch.int16), want.view(torch.int16)),
            f"dma_copy kernel differs from its plain version at {label}")
    require(torch.equal(got.view(torch.int16), x.view(torch.int16)),
            f"dma_copy kernel output is not its input at {label}")
    return float((got.float() - want.float()).abs().max())


def random_bf16(shape, gen, offset=0):
    """A bf16 tensor of `shape`, `offset` elements past the start of its
    (16-byte aligned) allocation."""
    numel = shape[0] * shape[1]
    flat = torch.randn(numel + offset, generator=gen, device=DEVICE) * 100
    return flat.to(torch.bfloat16)[offset:].view(shape)


def dma_edge_cases(plan):
    """(shape, chunks) at the DMA kernel's edges, for its launch plan at
    the probe's shape: chunks 3; one row per chunk, with more chunks than
    the grid holds at once; chunks of half a tile, of one tile plus 16
    bytes and of three tiles plus 16 bytes (16-byte rows), in 2 chunks and
    in more chunks than the grid holds at once."""
    tile_rows = plan["tile_bytes"] // 16  # rows of 8 bf16 in one tile
    # Twice the resident grid: one block per chunk, in two waves.
    many = 4 * plan["blocks_per_chunk"]
    cases = [((12, 7), 3), ((768, 1024), 3), ((12, 7), 12),
             ((512, 1024), 512)]
    for rows_per in (tile_rows // 2, tile_rows + 1, 3 * tile_rows + 1):
        cases += [((2 * rows_per, 8), 2), ((many * rows_per, 8), many)]
    return cases


def check_canaries(shape, chunks, n, gen, pad, in_offset, out_offset):
    """The C entry point on an input `in_offset` and an output
    `out_offset` elements past a 16-byte boundary, the output inside a
    buffer of SENTINEL with `pad` elements on each side: the output is the
    input, and no element around it changed."""
    numel = shape[0] * shape[1]
    x = random_bf16(shape, gen, in_offset)
    buf = torch.full((pad + out_offset + numel + pad,), SENTINEL,
                     dtype=torch.int16, device=DEVICE)
    out = buf[pad + out_offset:pad + out_offset + numel]
    err = dma_copy._kernel()(x.data_ptr(), out.data_ptr(), *shape, chunks, n,
                             torch.cuda.current_stream(DEVICE).cuda_stream)
    label = (f"shape {shape} chunks {chunks} n {n} offsets {in_offset}/"
             f"{out_offset}")
    require(err == 0, f"tpufd_dma_copy returned CUDA error {err} at {label}")
    torch.cuda.synchronize()
    require(torch.equal(out, x.reshape(-1).view(torch.int16)),
            f"tpufd_dma_copy output is not its input at {label}")
    require(bool((buf[:pad + out_offset] == SENTINEL).all()),
            f"tpufd_dma_copy wrote before its output at {label}")
    require(bool((buf[pad + out_offset + numel:] == SENTINEL).all()),
            f"tpufd_dma_copy wrote past its output at {label}")


def phase_kernel(family):
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    max_err = 0.0
    cases = 0
    for shape in (PROBE_SHAPE, (64, 1024), (12, 7)):
        x = (torch.randn(shape, generator=gen, device=DEVICE) * 100).to(
            torch.bfloat16)
        for chunks in (1, 2, 4):
            for n in (1, 3) if shape != PROBE_SHAPE else (1, 3, 2):
                max_err = max(max_err, check_dma_copy(x, n, chunks))
                cases += 1
    plan = dma_copy.launch_plan(*PROBE_SHAPE, 2, DEVICE)
    print(f"[3 kernel] dma_copy launch at {PROBE_SHAPE} in 2 chunks: "
          f"{plan['threads']} threads per block, {plan['blocks_per_chunk']} "
          f"blocks per chunk, {plan['resident_per_sm']} resident blocks per "
          f"SM, tile {plan['tile_bytes']} B, {plan['stages']} stages, "
          f"{plan['smem_bytes']} B dynamic shared memory per block")
    edges = dma_edge_cases(plan)
    for shape, chunks in edges:
        x = random_bf16(shape, gen)
        for n in (1, 3):
            max_err = max(max_err, check_dma_copy(x, n, chunks))
            cases += 1
    # A tile's worth of canary elements (two tiles of bytes) on each side.
    pad = plan["tile_bytes"]
    canaries = 0
    for shape, chunks in [(PROBE_SHAPE, 2), *edges]:
        # Aligned; both 6 bytes off a 16-byte boundary (the head path);
        # aligned unlike (element by element).
        for in_offset, out_offset in ((0, 0), (3, 3), (3, 0)):
            check_canaries(shape, chunks, 2, gen, pad, in_offset, out_offset)
            canaries += 1
    # Every bf16 bit pattern class, NaN and inf payloads included.
    bits = torch.randint(-32768, 32768, (256, 1024), dtype=torch.int16,
                         device=DEVICE, generator=gen)
    got = dma_copy.dma_copy(bits.view(torch.bfloat16), 2, 2)
    require(torch.equal(got.view(torch.int16), bits),
            "dma_copy kernel does not copy every bit pattern")
    # A contiguous input whose address is 6 bytes off the output's
    # 16-byte alignment takes the element-by-element path.
    base = torch.randn(64 * 1024 + 3, generator=gen, device=DEVICE).to(
        torch.bfloat16)
    max_err = max(max_err, check_dma_copy(base[3:].view(64, 1024), 2, 2))
    try:
        dma_copy.dma_copy(torch.zeros((5, 1024), dtype=torch.bfloat16,
                                      device=DEVICE), 1, 2)
    except ValueError:
        pass
    else:
        fail("dma_copy accepted 5 rows in 2 chunks")
    print(f"[3 kernel] dma_copy bit-exact against dma_copy_plain in "
          f"{cases + 2} cases (probe shape {PROBE_SHAPE}, small, ragged, "
          f"misaligned, all bit patterns, {len(edges)} edge shapes); "
          f"{canaries} canary runs of tpufd_dma_copy untouched around the "
          f"output; rejects rows % chunks != 0")

    x = torch.randn(PROBE_SHAPE, generator=gen, device=DEVICE).to(
        torch.bfloat16)
    out = torch.empty_like(x)
    n = 16
    ms_n = cuda_ms(lambda: dma_copy.dma_copy(x, n, 2), reps=5)
    ms_2n = cuda_ms(lambda: dma_copy.dma_copy(x, 2 * n, 2), reps=5)
    ratio = ms_2n / ms_n
    require(1.8 <= ratio <= 2.2,
            f"kernel time at 2n over n is {ratio:.3f}, not about 2: the "
            f"repeat loop is not doing n repeats")
    ms = ms_2n / (2 * n)
    plain_ms = cuda_ms(lambda: dma_copy.dma_copy_plain(x, n, 2),
                       reps=3) / n
    library_ms = cuda_ms(lambda: out.copy_(x), reps=20)
    hbm_gbps = health.RATED_HBM_GBPS.get(family or "h100-sxm")
    moved = 2 * x.numel() * x.element_size()  # read once + write once
    bound_ms = moved / (hbm_gbps * 1e9) * 1e3
    print(f"[3 kernel] dma_copy per repeat at {PROBE_SHAPE} bf16, chunks 2: "
          f"kernel {ms:.4f} ms ({moved / ms / 1e6:.0f} GB/s), bound "
          f"{bound_ms:.4f} ms ({moved} B at {hbm_gbps:.0f} GB/s, "
          f"{bound_ms / ms:.1%} of it), plain {plain_ms:.4f} ms, "
          f"library copy_ {library_ms:.4f} ms; t(2n)/t(n) {ratio:.3f} "
          f"(n {n}: {ms_n:.3f} ms, 2n: {ms_2n:.3f} ms)")
    require(ms * COPY_NOISE >= library_ms,
            f"kernel {ms:.4f} ms per repeat beats copy_ {library_ms:.4f} ms "
            f"by more than {COPY_NOISE}x: repeats are not all from HBM")
    return {"name": "dma_copy", "route": "cuda",
            "source": "tpufd_torch/csrc/dma_copy.cu",
            "replaces": "tpufd/health.py:248", "launches": None,
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": library_ms, "per": "repeat",
            "shape": list(PROBE_SHAPE), "ratio_2n_n": ratio}


def ulp_distance(got, want):
    """Elementwise distance in bf16 ulps between two bf16 tensors of
    finite values: their bit patterns as ordered integers (-0 == +0)."""
    def ordered(t):
        b = t.reshape(-1).view(torch.int16).int()
        return torch.where(b < 0, -(b + 32768), b)
    return (ordered(got) - ordered(want)).abs()


def at_offset(values, offset):
    """A copy of `values` `offset` elements past the start of its (16-byte
    aligned) allocation."""
    flat = torch.empty(values.numel() + offset, dtype=values.dtype,
                       device=values.device)
    out = flat[offset:].view(values.shape)
    out.copy_(values)
    return out


def check_chain_tail(p, acc, p_offset=0, acc_offset=0):
    """Kernel against plain version on the same inputs, p and acc placed
    at the given element offsets: at most 1 bf16 ulp apart. Returns (max
    abs difference, elements that differ)."""
    want = chain_tail.chain_tail_plain(p, acc.clone())
    got = chain_tail.chain_tail(at_offset(p, p_offset),
                                at_offset(acc, acc_offset))
    torch.cuda.synchronize()
    ulps = ulp_distance(got, want)
    require(int(ulps.max()) <= 1,
            f"chain_tail kernel is {int(ulps.max())} bf16 ulps from its "
            f"plain version at shape {tuple(p.shape)}, offsets "
            f"{p_offset}/{acc_offset}")
    return (float((got.float() - want.float()).abs().max()),
            int((ulps > 0).sum()))


def chain_tail_canary(p, acc, pad, p_offset, acc_offset):
    """The C entry point with acc inside a buffer of SENTINEL, `pad`
    elements on each side: acc within 1 ulp of the plain version, and no
    element around it changed."""
    numel = acc.numel()
    want = chain_tail.chain_tail_plain(p, acc.clone())
    buf = torch.full((pad + acc_offset + numel + pad,), SENTINEL,
                     dtype=torch.int16, device=DEVICE)
    region = buf[pad + acc_offset:pad + acc_offset + numel]
    region.copy_(acc.reshape(-1).view(torch.int16))
    p_at = at_offset(p, p_offset)
    err = chain_tail._kernel()(p_at.data_ptr(), region.data_ptr(), numel,
                               torch.cuda.current_stream(DEVICE).cuda_stream)
    label = f"shape {tuple(p.shape)} offsets {p_offset}/{acc_offset}"
    require(err == 0, f"tpufd_chain_tail returned CUDA error {err} at {label}")
    torch.cuda.synchronize()
    require(int(ulp_distance(region.view(torch.bfloat16), want).max()) <= 1,
            f"tpufd_chain_tail differs from its plain version at {label}")
    require(bool((buf[:pad + acc_offset] == SENTINEL).all()),
            f"tpufd_chain_tail wrote before acc at {label}")
    require(bool((buf[pad + acc_offset + numel:] == SENTINEL).all()),
            f"tpufd_chain_tail wrote past acc at {label}")


def chain_inputs(shape, gen):
    """(p, acc) in bf16: p spread over tanh's curved range, acc O(1)."""
    p = (torch.randn(shape, generator=gen, device=DEVICE) * 2).to(
        torch.bfloat16)
    acc = torch.randn(shape, generator=gen, device=DEVICE).to(torch.bfloat16)
    return p, acc


def phase_chain_tail(family):
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    max_err, differ, cases = 0.0, 0, 0
    # Probe shape; ragged; shorter than a vector; p and acc both 6 bytes
    # off a 16-byte boundary (head path); aligned unlike (element path).
    plan = [(CHAIN_SHAPE, 0, 0), ((37, 29), 0, 0), ((1, 7), 0, 0),
            ((257, 129), 3, 3), ((1, 7), 3, 3), ((257, 129), 0, 3),
            ((257, 129), 3, 0), (CHAIN_SHAPE, 3, 3)]
    for shape, p_offset, acc_offset in plan:
        err, n = check_chain_tail(*chain_inputs(shape, gen), p_offset,
                                  acc_offset)
        max_err, differ, cases = max(max_err, err), differ + n, cases + 1
    # Every finite bf16 bit pattern class, subnormals and signed zeros
    # included (exponent all ones, inf and NaN, left out).
    bits = torch.randint(-32768, 32768, (2, 512, 1024), dtype=torch.int16,
                         device=DEVICE, generator=gen)
    bits = torch.where((bits & 0x7f80) == 0x7f80, bits & 0x007f, bits)
    err, n = check_chain_tail(bits[0].view(torch.bfloat16),
                              bits[1].view(torch.bfloat16))
    max_err, differ, cases = max(max_err, err), differ + n, cases + 1
    canaries = 0
    for shape, p_offset, acc_offset in [(CHAIN_SHAPE, 0, 0), *plan[1:]]:
        chain_tail_canary(*chain_inputs(shape, gen), 4096, p_offset,
                          acc_offset)
        canaries += 1
    print(f"[3 kernel] chain_tail within 1 bf16 ulp of chain_tail_plain in "
          f"{cases} cases ({CHAIN_SHAPE}, ragged, 6 bytes off a 16-byte "
          f"boundary, aligned unlike, all finite bit patterns): {differ} "
          f"elements differ by 1 ulp, max abs difference {max_err:.3g}; "
          f"{canaries} canary runs of tpufd_chain_tail untouched around "
          f"acc")

    p, acc = chain_inputs(CHAIN_SHAPE, gen)
    ms = cuda_ms(lambda: chain_tail.chain_tail(p, acc), reps=50)
    plain_ms = cuda_ms(lambda: chain_tail.chain_tail_plain(p, acc), reps=20)
    three_ms = cuda_ms(lambda: torch.tanh(p).add_(acc).mul_(0.5), reps=20)
    hbm_gbps = health.RATED_HBM_GBPS.get(family or "h100-sxm")
    moved = 3 * acc.numel() * acc.element_size()  # read p, acc; write acc
    bytes_ms = moved / (hbm_gbps * 1e9) * 1e3
    ops_ms = 3 * acc.numel() / FP32_FLOPS * 1e3  # tanh, add, mul
    bound_ms = max(bytes_ms, ops_ms)
    print(f"[3 kernel] chain_tail per step at {CHAIN_SHAPE} bf16: kernel "
          f"{ms:.4f} ms ({moved / ms / 1e6:.0f} GB/s), bound {bound_ms:.4f} "
          f"ms ({moved} B at {hbm_gbps:.0f} GB/s, {bound_ms / ms:.1%} of "
          f"it; operations {ops_ms:.5f} ms), plain {plain_ms:.4f} ms, three "
          f"eager passes (tanh, add_, mul_) {three_ms:.4f} ms")
    require(ms < three_ms,
            f"fused tail {ms:.4f} ms is not faster than the three passes "
            f"{three_ms:.4f} ms")
    return {"name": "chain_tail", "route": "cuda",
            "source": "tpufd_torch/csrc/chain_tail.cu",
            "replaces": "tpufd/health.py:188", "launches": None,
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None, "per": "step", "shape": list(CHAIN_SHAPE),
            "three_pass_ms": three_ms, "ulps_differ": differ}


def phase_matmul_read(phase, when):
    """The matmul probe as health_labels runs it (median of 3)."""
    t0 = time.perf_counter()
    tflops = health.median_probe(
        lambda: health.matmul_tflops(device=DEVICE))
    print(f"[{phase} matmul] matmul-tflops {when}: {tflops:.1f} "
          f"(median of 3, {time.perf_counter() - t0:.1f} s)")


def chain_step_split():
    """Device ms of one chain step at the probe's shape and input, split
    into its product, the three eager passes and the fused tail, and of
    a 64-step chain with either tail."""
    acc = torch.full(CHAIN_SHAPE, 0.001 * 0.25, dtype=torch.bfloat16,
                     device=DEVICE)
    p = acc @ acc
    gemm = cuda_ms(lambda: torch.matmul(acc, acc, out=p), reps=50)
    three = cuda_ms(lambda: torch.tanh(p).add_(acc).mul_(0.5), reps=50)
    work = acc.clone()  # the fused tail runs in place on it
    fused = cuda_ms(lambda: chain_tail.chain_tail(p, work), reps=50)

    def three_pass_chain(x, n):
        for _ in range(n):
            x = torch.tanh(x @ x).add_(x).mul_(0.5)
        return x

    steps = 64
    chain_three = cuda_ms(lambda: three_pass_chain(acc.clone(), steps),
                          reps=3) / steps
    chain_fused = cuda_ms(
        lambda: health._matmul_chain(acc.clone(), steps), reps=3) / steps
    print(f"    chain step at {CHAIN_SHAPE} bf16: GEMM {gemm:.4f} ms, "
          f"three-pass tail {three:.4f} ms, fused tail {fused:.4f} ms; "
          f"{steps}-step chain {chain_three:.4f} ms/step with the three "
          f"passes, {chain_fused:.4f} ms/step fused")


def probe_iteration_times(name, fn, n):
    """Device, wall and enqueue milliseconds per iteration of one probe
    body: if enqueueing an iteration takes far less than the device
    spends on it, the launches keep the device busy."""
    fn(n, 0.125)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    result = fn(n, 0.25)
    enqueue = time.perf_counter() - t0
    end.record()
    end.synchronize()
    wall = time.perf_counter() - t0
    require(bool(torch.isfinite(result.reshape(-1)[0].float())),
            f"{name} probe body produced a non-finite value")
    device_ms = start.elapsed_time(end) / n
    print(f"    {name}: device {device_ms:.4f} ms/iter, wall "
          f"{wall * 1e3 / n:.4f} ms/iter, enqueue "
          f"{enqueue * 1e3 / n:.4f} ms/iter (n {n})")


def phase_slice(family, copy_gbps):
    dma_copy.launches = 0
    chain_tail.launches = 0
    t0 = time.perf_counter()
    labels = health.health_labels(extended=True, device=DEVICE)
    seconds = time.perf_counter() - t0
    launches = {"dma_copy": dma_copy.launches,
                "chain_tail": chain_tail.launches}
    require(labels.get(PREFIX + "ok") == "true", f"ok is not true: {labels}")
    for leaf in ("matmul-tflops", "hbm-gbps", "dma-copy-gbps"):
        value = labels.get(PREFIX + leaf)
        require(value is not None and float(value) > 0,
                f"{leaf} missing or not positive: {labels}")
        if family is not None:
            for suffix in ("-rated", "-pct-of-rated"):
                require(PREFIX + leaf + suffix in labels,
                        f"{leaf}{suffix} missing for a {family} card")
    for name, count in launches.items():
        require(count > 0, f"{name} kernel never launched on the main path")
    dma_gbps = float(labels[PREFIX + "dma-copy-gbps"])
    require(dma_gbps <= copy_gbps * COPY_NOISE,
            f"dma-copy-gbps={dma_gbps} beats copy_'s {copy_gbps:.0f} GB/s by "
            f"more than {COPY_NOISE}x: repeats are not all from HBM")
    registry = metrics.default_registry()
    probe_seconds = {
        leaf: round(registry.histogram(
            "tpufd_probe_duration_seconds", "", labels={"probe": leaf}).sum,
            2)
        for leaf in ("matmul-tflops", "hbm-gbps", "dma-copy-gbps")}
    print(f"[4 slice] health_labels(extended=True) on {DEVICE} in "
          f"{seconds:.1f} s (per probe, median of 3 included: "
          f"{probe_seconds} s), kernel launches {launches}")
    for key in sorted(labels):
        print(f"    {key}={labels[key]}")
    probe_iteration_times("matmul-tflops",
                          health._matmul_probe_fn(DEVICE, 4096), 64)
    probe_iteration_times("hbm-gbps", health._stream_probe_fn(DEVICE, 512),
                          64)
    probe_iteration_times("dma-copy-gbps",
                          health._dma_copy_probe_fn(DEVICE, 256, 2), 64)
    chain_step_split()
    return launches, labels, seconds


def phase_perfmodel():
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = perfmodel.main(device=DEVICE)
    seconds = time.perf_counter() - t0
    lines = out.getvalue().splitlines()
    require(rc == 0, f"perfmodel.main returned {rc}")
    keys = []
    for line in lines:
        match = re.fullmatch(r"(matmul-tflops|hbm-gbps|ici-gbps)=([0-9.]+)",
                             line)
        require(match is not None and float(match.group(2)) > 0,
                f"perfmodel line the daemon would not take: {line!r}")
        keys.append(match.group(1))
    require(keys[:2] == ["matmul-tflops", "hbm-gbps"],
            f"perfmodel printed {lines}")
    print(f"[5 perfmodel] {' '.join(lines)} in {seconds:.1f} s")
    return dict(line.split("=") for line in lines), seconds


def phase_burnin():
    model, (x,) = graft_entry.entry(device=DEVICE)
    with torch.no_grad():
        got = model(x)
        torch.cuda.synchronize()
        reference = burnin.BurninMLP(256, 1024, dtype=torch.float32)
        reference.load_state_dict(
            {k: v.float().cpu() for k, v in model.state_dict().items()})
        want = reference(x.float().cpu())
    require(got.shape == (4, 16, 256) and got.dtype == torch.bfloat16,
            f"forward gave {tuple(got.shape)} {got.dtype}")
    got = got.float().cpu()
    require(bool(torch.isfinite(got).all()), "forward is not finite")
    err = float((got - want).abs().max())
    torch.testing.assert_close(got, want, rtol=BURNIN_RTOL, atol=BURNIN_ATOL)
    print(f"[6 burn-in] forward (4, 16, 256) bf16 on the card vs float32 on "
          f"the host: max abs err {err:.4g} (rtol {BURNIN_RTOL}, atol "
          f"{BURNIN_ATOL})")


def sample(text, name, labels=None):
    """The value of sample `name` carrying `labels` in a Prometheus
    textfile, read by metrics.sample_value; fails the run if absent."""
    value = metrics.sample_value(text, name, labels)
    require(value is not None, f"{name}{labels or ''} missing from the "
            f"textfile")
    return value


def phase_train():
    t0 = time.perf_counter()
    loss = burnin.run_burnin(device=DEVICE, steps=2)
    require(math.isfinite(loss), f"run_burnin loss is {loss}")
    print(f"[6 burn-in] run_burnin(cuda:0, steps 2) at d_model 256, d_ff "
          f"1024: final loss {loss:.6f} in {time.perf_counter() - t0:.2f} s")

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "burnin.prom")
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cli.main(["burnin", "--device", "cuda", "--metrics-out",
                           path])
        lines = out.getvalue().splitlines()
        require(rc == 0, f"burnin command returned {rc}: {lines}")
        require(lines[:2] == [
            f"devices: 1 x {torch.cuda.get_device_name(DEVICE)}",
            "mesh: data=1 model=1"], f"burnin command printed {lines}")
        match = re.fullmatch(r"final loss after 2 steps: (\S+) \(ok\)",
                             lines[2] if len(lines) == 3 else "")
        require(match is not None, f"burnin command printed {lines}")
        with open(path) as f:
            text = f.read()
    hist = "tpufd_burnin_step_duration_seconds_count"
    for phase in ("compile", "steady"):
        require(sample(text, hist, {"phase": phase}) >= 1,
                f"no {phase} step in the burnin textfile")
    require(abs(sample(text, "tpufd_burnin_final_loss")
                - float(match.group(1))) <= 1e-6,
            "burnin textfile's final loss is not the printed one")
    print(f"[6 burn-in] `burnin --device cuda --metrics-out`: "
          f"{' | '.join(lines)}; textfile holds both step phases and the "
          f"final loss")

    # The same 2 steps from the same parameters and inputs: bf16 on the
    # card, float32 on the host.
    card = burnin.init_params(torch.Generator().manual_seed(0),
                              device=DEVICE)
    host = burnin.BurninMLP(256, 1024, dtype=torch.float32)
    host.load_state_dict({k: v.float().cpu()
                          for k, v in card.state_dict().items()})
    init = burnin.params_to_numpy(card)
    x = torch.randn((4, 8, 256), generator=torch.Generator().manual_seed(0))
    x = x.to(torch.bfloat16)
    y = torch.zeros_like(x)
    step_card = burnin.make_train_step(card)
    step_host = burnin.make_train_step(host)
    losses = []
    for _ in range(2):
        losses.append((float(step_card(x.to(DEVICE), y.to(DEVICE))),
                       float(step_host(x.float(), y.float()))))
    for got, want in losses:
        require(math.isfinite(got) and abs(got - want) <= (
            TRAIN_LOSS_RTOL * abs(want)),
                f"card loss {got} against host {want}")
    got, want = burnin.params_to_numpy(card), burnin.params_to_numpy(host)
    worst = 0.0
    for name in ("w_in", "w_out", "gamma"):
        g, w = torch.from_numpy(got[name]), torch.from_numpy(want[name])
        update = float((w - torch.from_numpy(init[name])).abs().max())
        limit = TRAIN_PARAM_RTOL * w.abs() + TRAIN_UPDATE_SHARE * update
        excess = float(((g - w).abs() - limit).max())
        require(excess <= 0, f"card {name} after 2 steps differs from the "
                             f"host's beyond tolerance by {excess:.3g}")
        worst = max(worst, float((g - w).abs().max()))

    x_card, y_card = x.to(DEVICE), y.to(DEVICE)
    card_ms = cuda_ms(lambda: step_card(x_card, y_card), reps=20)
    t0 = time.perf_counter()
    for _ in range(3):
        step_host(x.float(), y.float())
    host_ms = (time.perf_counter() - t0) / 3 * 1e3
    print(f"[6 burn-in] train step, 2 steps from the same parameters: card "
          f"bf16 loss {losses[0][0]:.6f}, {losses[1][0]:.6f}; host float32 "
          f"{losses[0][1]:.6f}, {losses[1][1]:.6f}; parameters max abs diff "
          f"{worst:.3g} (rtol {TRAIN_PARAM_RTOL} + {TRAIN_UPDATE_SHARE} of "
          f"the largest update); per step: card {card_ms:.4f} device ms, "
          f"host {host_ms:.3f} wall ms")
    return loss


def multicard_rank():
    """One NCCL rank of phase 7; returns what rank 0 measured."""
    world = dist.get_world_size()
    out = {"world": world}
    dm = mesh.data_model_mesh("cuda")
    out["mesh"] = (dm["data"].size(), dm["model"].size())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out["loss"] = burnin.run_burnin(mesh=dm, steps=2)
    out["burnin_s"] = time.perf_counter() - t0

    # One sharded step alone under CommDebugMode, from the same start.
    model = burnin.init_params(torch.Generator().manual_seed(0),
                               device=health.resolve_device("cuda"))
    burnin.shard_model(model, dm)
    batch, seq = 4 * out["mesh"][0], 8 * out["mesh"][1]
    x = torch.randn((batch, seq, 256),
                    generator=torch.Generator().manual_seed(0))
    x = distribute_tensor(x.to(model.gamma.device, torch.bfloat16), dm,
                          burnin.batch_placements(dm))
    step = burnin.make_train_step(model)
    with CommDebugMode() as comm:
        step(x, torch.zeros_like(x))
    out["collectives"] = {str(op).split(".")[-1]: n for op, n in
                          comm.get_comm_counts().items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(x, torch.zeros_like(x))
    torch.cuda.synchronize()
    out["step_ms"] = (time.perf_counter() - t0) * 1e3

    ring_mesh = init_device_mesh("cuda", (world,),
                                 mesh_dim_names=("context",))
    out["ring"] = {}
    for causal in (False, True):
        t0 = time.perf_counter()
        err = burnin.run_ring_attention_burnin(ring_mesh, causal=causal)
        out["ring"]["causal" if causal else "bidirectional"] = (
            err, time.perf_counter() - t0)

    all_mesh = init_device_mesh("cuda", (world,), mesh_dim_names=("all",))
    t0 = time.perf_counter()
    out["allreduce_gbps"] = health.allreduce_gbps(all_mesh, mib=64)
    out["allreduce_s"] = time.perf_counter() - t0
    return out


def phase_multicard(one_card_loss):
    world = torch.cuda.device_count()
    print(f"[7 multi-card] world size {world} (one NCCL rank per card), "
          f"NCCL {'.'.join(map(str, torch.cuda.nccl.version()))}")
    t0 = time.perf_counter()
    out = launch.spawn_ranks(multicard_rank, world, "cuda", timeout=240)
    spawn_s = time.perf_counter() - t0
    data_n, model_n = out["mesh"]
    if (data_n, model_n) != (1, 1):  # phase 6 ran batch 4, seq 8
        one_card_loss = burnin.run_burnin(device=DEVICE, batch=4 * data_n,
                                          seq=8 * model_n, steps=2)
    loss = out["loss"]
    require(math.isfinite(loss) and abs(loss - one_card_loss) <= (
        SHARDED_LOSS_RTOL * abs(one_card_loss)),
            f"sharded loss {loss} against one card's {one_card_loss}")
    print(f"[7 multi-card] sharded run_burnin over mesh data={data_n} "
          f"model={model_n} (batch {4 * data_n}, seq {8 * model_n}, d_model "
          f"256, d_ff 1024, bf16, 2 steps): final loss {loss:.6f}, one card "
          f"at the same shape {one_card_loss:.6f}; {out['burnin_s']:.3f} s "
          f"with first use; one sharded step {out['step_ms']:.3f} wall ms; "
          f"collectives in one step (CommDebugMode) {out['collectives']}")
    for mode, (err, seconds) in out["ring"].items():
        require(err <= RING_TOL, f"{mode} ring attention err {err}")
        print(f"[7 multi-card] {mode} ring attention over context={world} "
              f"(heads 2, seq {8 * world}, d_head 64, float32): max abs err "
              f"{err:.3g} vs full attention (tol {RING_TOL}), {seconds:.3f} s")
    gbps = out["allreduce_gbps"]
    require(math.isfinite(gbps), f"allreduce_gbps is {gbps}")
    print(f"[7 multi-card] allreduce_gbps(64 MiB) over {world} rank(s): "
          f"{gbps:.4g} GB/s in {out['allreduce_s']:.2f} s"
          + (" (one rank: the reference's byte count 2 n 2 (k-1)/k is 0; "
             "only a finite value that returns is required)"
             if world == 1 else ""))
    print(f"[7 multi-card] spawn, rendezvous, NCCL init and the rank work: "
          f"{spawn_s:.2f} s")
    # The multi-card `burnin` command's second process group: the ring
    # check alone, each mode agreed over a gloo group beside NCCL.
    t0 = time.perf_counter()
    rings = launch.spawn_ranks(burnin.ring_acceptance, world, "cuda",
                               args=("cuda",), timeout=240)["ring"]
    ring_s = time.perf_counter() - t0
    require([mode for mode, _, _ in rings] == list(burnin.RING_MODES) and all(
        error is None and err <= RING_TOL for _, err, error in rings),
            f"ring_acceptance over {world} rank(s): {rings}")
    print(f"[7 multi-card] ring_acceptance in a process group of its own "
          f"(the `burnin` command's second spawn): "
          + ", ".join(f"{mode} max abs err {err:.3g}"
                      for mode, err, _ in rings)
          + f"; {ring_s:.2f} s from spawn to result")
    if world > 1:
        labels = health.health_labels(extended=False, device=DEVICE)
        require(labels.get(PREFIX + "ok") == "true" and float(
            labels.get(PREFIX + "allreduce-gbps", "0")) > 0,
                f"health_labels over {world} cards: {labels}")
        print(f"[7 multi-card] health_labels over {world} cards: "
              f"allreduce-gbps={labels[PREFIX + 'allreduce-gbps']}")


def run_or_fail(argv, what):
    proc = subprocess.run(argv, cwd=REPO, capture_output=True, text=True)
    require(proc.returncode == 0,
            f"{what} exited {proc.returncode}: "
            f"{(proc.stdout + proc.stderr)[-3000:]}")


def build_daemon():
    """Builds build/tpu-feature-discovery from the checkout's C++
    sources: cmake + ninja where both are on PATH; otherwise g++ on the
    core sources CMakeLists.txt lists plus the daemon's main.cc, one
    compile per source in parallel, then one link. Returns the route."""
    build = REPO / "build"
    if shutil.which("cmake") and shutil.which("ninja"):
        run_or_fail(["cmake", "-S", str(REPO), "-B", str(build), "-G",
                     "Ninja"], "cmake")
        run_or_fail(["ninja", "-C", str(build), DAEMON.name], "ninja")
        return "cmake + ninja"
    obj_dir = build / "obj"
    obj_dir.mkdir(parents=True, exist_ok=True)
    version = (REPO / "VERSION").read_text().strip()
    common = ["g++", "-std=c++17", "-O1", f"-I{REPO}/src",
              f"-I{REPO}/third_party", f'-DTFD_VERSION="{version}"',
              '-DTFD_GIT_COMMIT="unknown"']
    sources = [s for s in re.findall(r"^\s+(src/tfd/\S+\.cc)$",
                                     (REPO / "CMakeLists.txt").read_text(),
                                     flags=re.M)
               if "tests/" not in s and "testing/" not in s]
    objects = [str(obj_dir / (s.replace("/", "_") + ".o")) for s in sources]
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 2) as pool:
        for job in [pool.submit(run_or_fail,
                                [*common, "-c", str(REPO / s), "-o", o],
                                f"g++ {s}")
                    for s, o in zip(sources, objects)]:
            job.result()
    run_or_fail([*common, str(REPO / "cmd/tpu-feature-discovery/main.cc"),
                 *objects, "-o", str(DAEMON), "-ldl", "-lpthread"],
                "g++ link")
    return f"g++ ({len(sources)} core sources + main.cc)"


def kill_tagged(tag):
    """SIGKILLs every process whose environment carries DAEMON_TAG=tag:
    the daemon and whatever it started, orphans included."""
    marker = f"{DAEMON_TAG}={tag}".encode()
    for entry in Path("/proc").iterdir():
        if not entry.name.isdigit() or int(entry.name) == os.getpid():
            continue
        try:
            if marker in (entry / "environ").read_bytes().split(b"\0"):
                os.kill(int(entry.name), signal.SIGKILL)
        except OSError:  # gone meanwhile, or not ours to read
            pass


def feature_labels(path):
    try:
        return dict(line.split("=", 1)
                    for line in path.read_text().splitlines() if "=" in line)
    except FileNotFoundError:
        return {}


def stderr_tail(path, lines=40):
    return "\n".join(path.read_text(errors="replace").splitlines()[-lines:])


def port_journal(env, *args):
    """`python -m tpufd_torch journal ARGS`: its stdout; fails the run if
    the command fails."""
    proc = subprocess.run([sys.executable, "-m", "tpufd_torch", "journal",
                           *args], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=60)
    require(proc.returncode == 0,
            f"journal {' '.join(args)} exited {proc.returncode}: "
            f"{proc.stderr[-3000:]}")
    return proc.stdout


def scrape_journal(env, port, events):
    """Merges the daemon's whole journal, read with `tpufd_torch journal
    --raw` over HTTP, into `events` ({seq: event}) by
    journal.merge_events; returns `events`."""
    doc = journal.parse_journal(port_journal(
        env, "--url", f"http://127.0.0.1:{port}", "--raw"))
    return journal.merge_events(events, doc)


def check_transitions(events, how, say):
    """Every health-transition the daemon journaled is an edge of the
    port's healthsm."""
    transitions = healthsm.health_transitions(events)
    illegal = healthsm.illegal_transitions(events)
    require(not illegal, f"illegal health transitions {how}: {illegal}")
    say(f"healthsm: {len(events)} journal events merged {how}, "
        f"{len(transitions)} health transition(s), none illegal"
        + (f": {transitions}" if transitions else ""))


def stand_in_rated_specs(tmp):
    """A --rated-specs-file rating the mock topology's family at this
    card's figures from tpufd_torch/rated_specs.json. A stand-in: the
    daemon has no CUDA family, and the file replaces its baked table
    whole, so the port's readings are rated against the card under the
    name `v5e`. Returns (path, the card's family, the specs)."""
    family = health.family_of(DEVICE)
    if family is None:
        fail(f"{torch.cuda.get_device_name(DEVICE)} has no rated figures "
             f"in tpufd_torch/rated_specs.json")
    specs = {MOCK_FAMILY: perfmodel.load_rated_specs()[family]}
    path = tmp / "rated_specs.json"
    path.write_text(json.dumps({"families": specs}))
    return path, family, specs


def check_perf_class(labels, fields, family, specs, say):
    """The daemon's tpu.perf.* labels equal perfmodel.expected_labels of
    the perf-measure event's readings, classed by perfmodel.classify of
    their percentages of the stand-in rating."""
    matmul, hbm, ici = (float(fields[k]) for k in
                        ("matmul_tflops", "hbm_gbps", "ici_gbps"))
    rated = specs[MOCK_FAMILY]
    class_name = perfmodel.classify(
        perfmodel.pct_of_rated(matmul, rated["matmul_tflops"]),
        perfmodel.pct_of_rated(hbm, rated["hbm_gbps"]))
    want = perfmodel.expected_labels(matmul, hbm, ici, MOCK_FAMILY,
                                     class_name, specs=specs)
    got = {k: v for k, v in labels.items() if k.startswith(PERF_PREFIX)}
    require(got == want, f"the daemon's perf labels {got} are not "
            f"perfmodel.expected_labels {want}")
    say(f"perf class rated against {family} {rated} (as {MOCK_FAMILY}): "
        f"the daemon published {got}; perfmodel.expected_labels of "
        f"perf-measure matmul_tflops={fields['matmul_tflops']} "
        f"hbm_gbps={fields['hbm_gbps']} gives {want}")


def deployment_env(tag, kernel_dir):
    """The daemon's environment as a node without the CUDA toolkit gives
    it: the kernel libraries built ahead in `kernel_dir`, no directory
    holding nvcc on PATH, and `tag`, which every process it starts
    inherits."""
    path = [p for p in os.environ.get("PATH", "").split(os.pathsep)
            if p and not (Path(p) / "nvcc").exists()]
    # PYTHONPATH is prepended, not replaced: a site may register plugins
    # through it.
    return {**os.environ, "GCE_METADATA_HOST": "127.0.0.1:1", DAEMON_TAG: tag,
            _build.KERNEL_DIR_ENV: str(kernel_dir),
            "PATH": os.pathsep.join(path),
            "PYTHONPATH": os.pathsep.join(
                p for p in (str(REPO), os.environ.get("PYTHONPATH")) if p)}


def kernel_listing(directory):
    """Every file of `directory`: name, size and modification time."""
    return sorted((p.name, p.stat().st_size, p.stat().st_mtime_ns)
                  for p in directory.iterdir())


def build_ahead(kernel_dir, say):
    """`python -m tpufd_torch._build` into `kernel_dir`, as an image build
    runs it on a machine with the toolkit."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "tpufd_torch._build"], cwd=REPO,
        env={**os.environ, _build.KERNEL_DIR_ENV: str(kernel_dir)},
        capture_output=True, text=True, timeout=300)
    require(proc.returncode == 0,
            f"`{_build.BUILD_AHEAD}` exited {proc.returncode}: "
            f"{proc.stderr[-3000:]}")
    lines = proc.stdout.splitlines()
    require([line.split()[0] for line in lines] == list(_build.KERNELS),
            f"`{_build.BUILD_AHEAD}` printed {lines}")
    say(f"`{_build.BUILD_AHEAD}` in {time.perf_counter() - t0:.1f} s: "
        f"{'; '.join(lines)}")


# A fresh `python -m tpufd_torch health` up to its first probe: the
# command's imports, the first CUDA op, each kernel's library loaded, then
# each kernel launched once. Prints its clock marks as one JSON line.
STARTUP_CHILD = """
import json, time
marks = {"start": time.time()}
import tpufd_torch.__main__
from tpufd_torch import health
marks["imported"] = time.time()
import torch
torch.ones(1, device="cuda").add_(1)
torch.cuda.synchronize()
marks["cuda"] = time.time()
from tpufd_torch import chain_tail, dma_copy
chain_tail._kernel()
dma_copy._kernel()
marks["loaded"] = time.time()
x = torch.zeros((2, 8), dtype=torch.bfloat16, device="cuda")
chain_tail.chain_tail(x, x.clone())
dma_copy.dma_copy(x, 1, 1)
torch.cuda.synchronize()
marks["launched"] = time.time()
print(json.dumps(marks))
"""


def startup_split(env, say):
    """Where a fresh exec's start-up goes, STARTUP_CHILD run in the
    daemon's environment: the interpreter and site, the imports, the first
    CUDA op, loading and first launching the kernels, and exiting. Then
    the same child under `python -X importtime`: its total import time,
    and the largest imports one level below the top (a module's cost
    counts where it was first imported). Returns the plain run's wall
    seconds."""
    def child(*flags):
        t0 = time.time()
        proc = subprocess.run([sys.executable, *flags, "-c", STARTUP_CHILD],
                              cwd=REPO, env=env, capture_output=True,
                              text=True, timeout=300)
        wall = time.time() - t0
        require(proc.returncode == 0, f"start-up child exited "
                f"{proc.returncode}: {proc.stderr[-3000:]}")
        marks = json.loads(proc.stdout.splitlines()[-1])
        return wall, {
            "interpreter and site": marks["start"] - t0,
            "imports": marks["imported"] - marks["start"],
            "first CUDA op": marks["cuda"] - marks["imported"],
            "kernel libraries loaded": marks["loaded"] - marks["cuda"],
            "first kernel launches": marks["launched"] - marks["loaded"],
            "exit": t0 + wall - marks["launched"]}, proc.stderr

    wall, split, _ = child()
    say(f"start-up of a fresh exec, {wall:.2f} s in all: "
        + ", ".join(f"{k} {v:.3f} s" for k, v in split.items()))
    profiled, split, stderr = child("-X", "importtime")
    rows = [m for m in (re.fullmatch(r"import time:\s+(\d+) \|\s+(\d+) \| "
                                     r"( *)(\S+)", line)
                        for line in stderr.splitlines()) if m]
    top = sorted(((int(m.group(2)), m.group(4)) for m in rows
                  if len(m.group(3)) == 2), reverse=True)[:8]
    total = sum(int(m.group(1)) for m in rows) / 1e6
    say(f"    under -X importtime ({profiled:.2f} s in all, imports "
        f"{split['imports']:.3f} s): {total:.3f} s in {len(rows)} imports; "
        f"largest one level down (cumulative): "
        + ", ".join(f"{name} {us / 1e6:.3f} s" for us, name in top))
    return wall


@contextlib.contextmanager
def daemon(argv, env, stderr_path):
    """The daemon started in daemon mode; on any exit it is killed if
    still running, and so is every process carrying env's tag."""
    with open(stderr_path, "wb") as stderr:
        proc = subprocess.Popen(argv, cwd=REPO, env=env, stderr=stderr,
                                stdout=subprocess.DEVNULL)
    try:
        yield proc
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        kill_tagged(env[DAEMON_TAG])


def wait_for_labels(proc, read, keys, stderr_path, say,
                    where="the feature file"):
    """The daemon's published labels, as read() returns them, once every
    one of `keys` is in them; fails if the daemon exits, publishes health
    ok=false, or takes longer than DAEMON_DEADLINE_S. The basic health
    layer may publish ok before an exec lands, so `keys` are labels the
    execs alone publish."""
    deadline = time.monotonic() + DAEMON_DEADLINE_S
    seen = set()
    while True:
        labels = read()
        require(proc.poll() is None,
                f"daemon exited {proc.returncode}:\n"
                f"{stderr_tail(stderr_path)}")
        for key in keys:
            if key in labels and key not in seen:
                seen.add(key)
                say(f"{key}={labels[key]} in {where}")
        require(labels.get(PREFIX + "ok") != "false",
                f"health exec failed under the daemon: {labels}\n"
                f"{stderr_tail(stderr_path)}")
        if len(seen) == len(keys):
            return labels
        require(time.monotonic() < deadline,
                f"no {keys} within {DAEMON_DEADLINE_S} s: {labels}\n"
                f"{stderr_tail(stderr_path)}")
        time.sleep(0.5)


def check_health_labels(labels, slice_labels, prom, how, say):
    """The exec's health labels under the daemon: ok, the three probes
    positive, none degraded, each within PERF_TOL of phase 4's in-process
    read, the enumeration cross-check against the mock chips, and the DMA
    probe's time in the exec's textfile `prom`."""
    require(labels.get(PREFIX + "ok") == "true",
            f"ok is not true {how}: {labels}")
    n_cards = torch.cuda.device_count()
    for leaf in ("matmul-tflops", "hbm-gbps", "dma-copy-gbps"):
        value = labels.get(PREFIX + leaf)
        require(value is not None and float(value) > 0,
                f"{leaf} missing or not positive {how}: {labels}")
        require(PREFIX + leaf + "-degraded" not in labels,
                f"{leaf} degraded {how}: {labels}")
        if health.family_of(DEVICE) is not None:
            require(PREFIX + leaf + "-pct-of-rated" in labels,
                    f"{leaf}-pct-of-rated missing {how}: {labels}")
        inproc = float(slice_labels[PREFIX + leaf])
        ratio = float(value) / inproc
        require(abs(ratio - 1) <= PERF_TOL,
                f"health {leaf}={value} {how} against {inproc:g} in-process "
                f"(tol {PERF_TOL})")
        say(f"health {leaf}: {value} {how}, phase 4 in-process {inproc:g} "
            f"(ratio {ratio:.4f})")
    consistent = "true" if n_cards == MOCK_CHIPS else "false"
    require(labels.get(PREFIX + "devices-consistent") == consistent and (
        consistent == "true"
        or labels.get(PREFIX + "devices-jax") == str(n_cards)),
            f"enumeration cross-check against {MOCK_CHIPS} mock chips and "
            f"{n_cards} card(s) {how}: {labels}")
    text = prom.read_text()
    metrics.validate_exposition(text)
    require(sample(text, "tpufd_health_ok") == 1,
            f"tpufd_health_ok is not 1 in the exec's textfile {how}")
    dma = {"probe": "dma-copy-gbps"}
    runs = sample(text, "tpufd_probe_duration_seconds_count", dma)
    require(runs >= 1, f"no DMA probe in the exec's textfile {how}")
    say(f"health exec textfile: passes metrics.validate_exposition "
        f"({len(list(metrics.parse_samples(text)))} samples), "
        f"tpufd_health_ok 1; DMA probe ran {runs:.0f} time(s) in "
        f"{sample(text, 'tpufd_probe_duration_seconds_sum', dma):.2f} s; "
        f"devices-consistent={consistent} ({MOCK_CHIPS} mock chips, "
        f"{n_cards} card(s))")


def journal_events(env, port, kind):
    """The daemon's journal events of type `kind`, read with
    `tpufd_torch journal --raw` over HTTP."""
    return json.loads(port_journal(env, "--url", f"http://127.0.0.1:{port}",
                                   "--type", kind, "--raw"))["events"]


def probe_seconds(env, port, source):
    """duration_s of the newest probe-ok event of `source`."""
    events = [e for e in journal_events(env, port, "probe-ok")
              if e.get("source") == source]
    require(events, f"no probe-ok event of source {source}")
    return float(events[-1]["fields"]["duration_s"])


def stop(proc, say):
    proc.send_signal(signal.SIGTERM)
    rc = proc.wait(timeout=30)
    say(f"daemon stopped by SIGTERM, exit {rc}")


def daemon_exec_run(env, tmp, slice_labels, perf_run, say):
    """The daemon with --device-health=full execing `tpufd_torch health
    --extended` and --perf-characterize execing `tpufd_torch perfmodel`;
    returns the health exec's wall seconds under it."""
    perf_values, perf_seconds = perf_run
    out_file, dump, prom = tmp / "tfd", tmp / "dump.json", tmp / "h.prom"
    python = shlex.quote(sys.executable)
    health_exec = (f"{python} -m tpufd_torch health --extended "
                   f"--metrics-out {shlex.quote(str(prom))}")
    perf_exec = f"{python} -m tpufd_torch perfmodel"
    rated_specs, family, specs = stand_in_rated_specs(tmp)
    port = free_loopback_port()
    argv = [str(DAEMON), "--sleep-interval=1s", "--backend=mock",
            f"--mock-topology-file={MOCK_TOPOLOGY}",
            "--machine-type-file=/dev/null",
            f"--output-file={out_file}", f"--state-file={tmp / 'state'}",
            f"--debug-dump-file={dump}",
            f"--introspection-addr=127.0.0.1:{port}",
            # Room for every event of the run: the mock source alone
            # journals a probe each second.
            "--journal-capacity=4096",
            "--device-health=full", f"--health-exec={health_exec}",
            "--perf-characterize", f"--perf-exec={perf_exec}",
            f"--rated-specs-file={rated_specs}"]
    stderr_path = tmp / "daemon.stderr"
    with daemon(argv, env, stderr_path) as proc:
        say(f"daemon pid {proc.pid} on 127.0.0.1:{port}: health exec "
            f"`{health_exec}`, perf exec `{perf_exec}`, "
            f"--rated-specs-file={rated_specs}")
        labels = wait_for_labels(proc, lambda: feature_labels(out_file), (
            PREFIX + "dma-copy-gbps", PERF_PREFIX + "matmul-tflops"),
            stderr_path, say)
        events = scrape_journal(env, port, {})
        check_health_labels(labels, slice_labels, prom, "under the daemon",
                            say)
        for leaf in ("matmul-tflops", "hbm-gbps"):
            value = float(labels.get(PERF_PREFIX + leaf, "0"))
            want = float(perf_values[leaf])
            require(abs(value - want) <= PERF_TOL * want,
                    f"perf {leaf}={value} under the daemon against "
                    f"{want} in-process (tol {PERF_TOL})")
            say(f"perf {leaf}: daemon {value:g}, phase 5 in-process "
                f"{want:g} (ratio {value / want:.4f})")
        shown = {k: v for k, v in sorted(labels.items())
                 if k.startswith(PERF_PREFIX) or "pct-of-rated" in k
                 or k in ("google.com/tpu.family", "google.com/tpu.count")}
        say(f"also published (not asserted): {shown}")

        exec_seconds = probe_seconds(env, port, "health")
        say(f"journal --type probe-ok: health exec {exec_seconds:.1f} s "
            f"under the daemon")
        measured = journal_events(env, port, "perf-measure")
        require(measured, "no perf-measure event")
        fields = measured[-1]["fields"]
        check_perf_class(labels, fields, family, specs, say)
        say(f"journal --type perf-measure --raw: perf exec "
            f"{fields['duration_s']} s under the daemon against phase "
            f"5's {perf_seconds:.1f} s in-process; "
            + ", ".join(f"{k}={fields[k]}" for k in
                        ("matmul_tflops", "hbm_gbps", "pct_of_rated",
                         "class", "reason")))

        proc.send_signal(signal.SIGUSR1)
        deadline = time.monotonic() + 30
        while True:
            try:
                json.loads(dump.read_text())
                break
            except (FileNotFoundError, json.JSONDecodeError):
                require(time.monotonic() < deadline,
                        "no SIGUSR1 dump within 30 s")
                time.sleep(0.2)
        lines = port_journal(env, "--file", str(dump)).splitlines()
        dumps = [line for line in lines
                 if re.match(r"  #\d+ \S+ g\d+ dump: ", line)]
        require(lines[0].startswith("journal: ") and dumps,
                f"journal --file printed no dump event: {lines[:3]}")
        say(f"journal --file (SIGUSR1 dump): {lines[0]}; "
            f"{dumps[-1].strip()}")
        check_transitions(scrape_journal(env, port, events),
                          "under --device-health=full", say)
        stop(proc, say)
    return exec_seconds


def plugin_run(env, tmp, slice_labels, say):
    """The daemon with --device-health=off and the in-tree device-health
    plugin in its --plugin-dir, the plugin execing `tpufd_torch health
    --extended` through TFD_PLUGIN_HEALTH_EXEC under a raised
    --plugin-timeout; returns the plugin round's wall seconds."""
    plugin_dir = tmp / "plugins"
    plugin_dir.mkdir()
    shutil.copyfile(PLUGIN, plugin_dir / PLUGIN.name)
    (plugin_dir / PLUGIN.name).chmod(0o755)
    out_file, prom = tmp / "tfd-plugin", tmp / "plugin.prom"
    health_exec = (f"{shlex.quote(sys.executable)} -m tpufd_torch health "
                   f"--extended --metrics-out {shlex.quote(str(prom))}")
    port = free_loopback_port()
    argv = [str(DAEMON), "--sleep-interval=1s", "--backend=mock",
            f"--mock-topology-file={MOCK_TOPOLOGY}",
            "--machine-type-file=/dev/null", f"--output-file={out_file}",
            f"--introspection-addr=127.0.0.1:{port}",
            "--journal-capacity=4096", "--device-health=off",
            f"--plugin-dir={plugin_dir}",
            f"--plugin-timeout={PLUGIN_TIMEOUT_S}s"]
    stderr_path = tmp / "daemon-plugin.stderr"
    with daemon(argv, {**env, "TFD_PLUGIN_HEALTH_EXEC": health_exec},
                stderr_path) as proc:
        say(f"daemon pid {proc.pid} on 127.0.0.1:{port}: --device-health="
            f"off, the device-health plugin in {plugin_dir} under "
            f"--plugin-timeout={PLUGIN_TIMEOUT_S}s, TFD_PLUGIN_HEALTH_EXEC="
            f"`{health_exec}`")
        labels = wait_for_labels(proc, lambda: feature_labels(out_file),
                                 (PREFIX + "dma-copy-gbps",), stderr_path,
                                 say)
        events = scrape_journal(env, port, {})
        check_health_labels(labels, slice_labels, prom,
                            "behind the plugin", say)
        discovered = [e for e in journal_events(env, port,
                                                "plugin-discovered")
                      if e["fields"].get("plugin") == PLUGIN.name]
        kills = journal_events(env, port, "plugin-kill")
        require(discovered and not kills,
                f"plugin-discovered {discovered}, plugin-kill {kills}")
        seconds = probe_seconds(env, port, "plugin." + PLUGIN.name)
        say(f"journal: plugin-discovered {PLUGIN.name}, no plugin-kill; "
            f"the plugin round (its exec) {seconds:.1f} s")
        scrape_journal(env, port, events)
        check_transitions(events, "behind the plugin", say)
        violations = plugin.plugin_violations(events)
        require(not violations, f"plugin violations: {violations}")
        say("plugin.plugin_violations: none")
        stop(proc, say)
    return seconds


def phase_daemon(slice_run, perf_run):
    """Phase 8: the port under the real daemon (see the module doc)."""
    slice_labels, slice_seconds = slice_run
    t0 = time.perf_counter()

    def say(text):
        print(f"[8 daemon +{time.perf_counter() - t0:.1f} s] {text}")

    route = build_daemon()
    say(f"built {DAEMON.relative_to(REPO)} by {route} in "
        f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()  # this process keeps its CUDA context
    with tempfile.TemporaryDirectory() as tmp_name:
        tmp = Path(tmp_name)
        kernel_dir = tmp / "kernels"
        build_ahead(kernel_dir, say)
        libraries = kernel_listing(kernel_dir)
        env = deployment_env(tmp_name, kernel_dir)
        say(f"the execs run with {_build.KERNEL_DIR_ENV}={kernel_dir} and "
            f"PATH={env['PATH']}")
        startup = startup_split(env, say)
        full = daemon_exec_run(env, tmp, slice_labels, perf_run, say)
        plugin = plugin_run(env, tmp, slice_labels, say)
        require(kernel_listing(kernel_dir) == libraries,
                f"the execs changed {kernel_dir}: {libraries} became "
                f"{kernel_listing(kernel_dir)}")
        say(f"{kernel_dir} unchanged after the execs ({len(libraries)} "
            f"files): no kernel was compiled at run time")
    say(f"health --extended wall time: in-process (phase 4) "
        f"{slice_seconds:.1f} s; under --device-health=full {full:.1f} s; "
        f"behind the device-health plugin {plugin:.1f} s; a fresh exec's "
        f"start-up to its first probe {startup:.2f} s")


def debug_get(port, path):
    """(status, body) of GET path on a daemon's loopback port; (None, "")
    while nothing listens there yet."""
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=5) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()
    except OSError:
        return None, ""


def fleet_env(base, server, sa_dir):
    """`base` plus what a daemon needs to reach the fake apiserver: its
    URL, the namespace, and an empty service-account directory (no
    token, no CA)."""
    return {**base, "TFD_APISERVER_URL": server.url,
            "KUBERNETES_NAMESPACE": FLEET_NS,
            "TFD_SERVICEACCOUNT_DIR": str(sa_dir)}


def fleet_objects(server):
    """{CR name: (spec.labels, metadata.annotations)} of every NodeFeature
    in the fake's namespace, copied under its lock."""
    with server._handler.lock:
        return {name: (dict(obj["spec"]["labels"]),
                       dict(obj["metadata"].get("annotations") or {}))
                for (ns, name), obj in sorted(server.store.items())
                if ns == FLEET_NS and "spec" in obj}


def node_crs(server):
    """{node: (labels, annotations)} of every node's CR in the fake."""
    prefix = agg.CR_NAME_PREFIX
    return {name[len(prefix):]: cr for name, cr in
            fleet_objects(server).items() if name.startswith(prefix)}


def seed_peers(server, say):
    """Seeds three peer CRs drawn from PEER_SEED, one per class of
    PEERS."""
    rng = np.random.default_rng(PEER_SEED)
    peers = {}
    for node, (cls, matmul, hbm) in PEERS.items():
        labels = {agg.TPU_COUNT: str(int(rng.choice([4, 8]))),
                  agg.PERF_CLASS: cls,
                  agg.PERF_MATMUL: agg.fixed3(float(rng.uniform(*matmul))),
                  agg.PERF_HBM: agg.fixed3(float(rng.uniform(*hbm)))}
        server.seed(FLEET_NS, agg.CR_NAME_PREFIX + node, labels,
                    {sink.NODE_NAME_LABEL: node})
        peers[node] = labels
    say(f"seeded {len(peers)} peer CRs (numpy seed {PEER_SEED}): {peers}")


def wait_equal(proc, read, want, what, stderr_path):
    """read() once it equals `want`; fails if the daemon exits first or
    FLEET_DEADLINE_S passes, showing the last reading beside `want`."""
    deadline = time.monotonic() + FLEET_DEADLINE_S
    while True:
        got = read()
        if got == want:
            return got
        require(proc.poll() is None, f"{what}: the daemon exited "
                f"{proc.returncode}:\n{stderr_tail(stderr_path)}")
        require(time.monotonic() < deadline,
                f"{what}: {got} is not its twin's {want} after "
                f"{FLEET_DEADLINE_S} s\n{stderr_tail(stderr_path)}")
        time.sleep(0.2)


def fleet_aggregator(binary, server, env, tmp, say):
    """--mode=aggregator against the fake: the tfd-cluster-inventory CR's
    labels must equal, string for string, agg.InventoryStore fed every
    node CR (labels and stage-SLO annotation), with the fleet stages the
    port's BurnEvaluator calls burning on those sketches. Returns the
    inventory's labels."""
    store = agg.InventoryStore()
    for node, (labels, notes) in node_crs(server).items():
        store.apply(node, labels, notes.get(sink.SLO_ANNOTATION, ""))
    want = store.build_output_labels()
    burn = agg.BurnEvaluator(agg.slo_budgets_ms_from_spec(
        env.get("TFD_SLO_BUDGETS_MS", "")))
    burn.note(0.0, store.stage)  # the sketches stand still: one tick
    for stage in burn.burning_stages():
        want[agg.SLO_BURN_PREFIX + stage + ".burn"] = "true"
    port = free_loopback_port()
    argv = [str(binary), "--mode=aggregator", "--agg-debounce=1s",
            "--agg-lease-duration=4s",
            f"--introspection-addr=127.0.0.1:{port}"]
    stderr_path = tmp / "aggregator.stderr"
    with daemon(argv, {**env, "POD_NAME": "agg-0"}, stderr_path) as proc:
        got = wait_equal(
            proc, lambda: fleet_objects(server).get(INVENTORY, ({},))[0],
            want, f"the {INVENTORY} CR", stderr_path)
        stop(proc, say)
    say(f"--mode=aggregator: {INVENTORY} equals agg.InventoryStore of "
        f"{len(store.nodes)} node CRs, {len(got)} labels: {got}")
    return got


def post_placement(port, doc):
    """(status, body) of one POST /v1/placements."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/placements", method="POST",
        data=json.dumps(doc).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=5) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"null")
    except OSError:
        return None, None


def fleet_placement(binary, server, env, tmp, card, say):
    """--mode=placement against the fake: a battery of POST
    /v1/placements (a job of the card's class floor and chip count, a
    gold job, a job larger than any node; some with the explanation),
    each answer equal to placement.PlacementIndex.query fed the same node
    CRs and inventory. Returns the card's node's rank for the first."""
    crs = node_crs(server)
    index = placement.PlacementIndex()
    for node, (labels, notes) in crs.items():
        index.apply_node(node, labels, notes.get(sink.CHANGE_ANNOTATION, ""))
    inventory = fleet_objects(server).get(INVENTORY)
    if inventory is not None:
        index.apply_inventory(inventory[0],
                              inventory[1].get(sink.CHANGE_ANNOTATION, ""))
    chips = int(crs[card][0][agg.TPU_COUNT])
    largest = max(int(labels.get(agg.TPU_COUNT, "0"))
                  for labels, _ in crs.values())
    battery = [{"class": "silver", "chips": chips, "limit": 64},
               {"class": "silver", "chips": chips, "limit": 64,
                "explain": True},
               {"class": "gold", "chips": 1, "limit": 64, "explain": True},
               {"class": "any", "chips": largest + 1, "explain": True}]
    qport, port = free_loopback_port(), free_loopback_port()
    argv = [str(binary), "--mode=placement",
            f"--placement-listen-addr=127.0.0.1:{qport}",
            f"--introspection-addr=127.0.0.1:{port}"]
    stderr_path = tmp / "placement.stderr"
    answers = []
    with daemon(argv, {**env, "POD_NAME": "placement-0"},
                stderr_path) as proc:
        wait_equal(proc, lambda: debug_get(qport, "/readyz")[0], 200,
                   "/readyz", stderr_path)
        for doc in battery:
            want = index.query(wanted=doc["class"], chips=doc["chips"],
                               slice=doc.get("slice", False),
                               limit=doc.get("limit", 1),
                               explain=doc.get("explain", False))
            answers.append(wait_equal(
                proc, lambda: post_placement(qport, doc), (200, want),
                f"POST /v1/placements {doc}", stderr_path)[1])
            answer = answers[-1]
            say(f"POST /v1/placements {json.dumps(doc)}: {answer['status']} "
                f"{[c['node'] for c in answer['candidates']]}, equal to "
                f"placement.PlacementIndex.query"
                + (f"; {answer['explain']['counterfactual'] or 'placed'}"
                   if "explain" in answer else ""))
        stop(proc, say)
    ranked = [c["node"] for c in answers[0]["candidates"]]
    require(card in ranked, f"the card's node {card} is not among the "
            f"candidates for a {battery[0]} job: {answers[0]}")
    say(f"the card's node ranks {ranked.index(card) + 1} of {len(ranked)} "
        f"for a silver job of {chips} chips: {ranked}")
    return ranked.index(card) + 1


def fleet_remedy(binary, server, env, tmp, card, flapper, say):
    """--mode=remedy (dry run, its default) against the fake. Once the
    controller has listed the fleet, `flapper`'s CR goes eligible and
    back to its own labels REMEDY_FLAPS times, and the inventory CR asks
    for QUEUED_CHIPS chips. Its journal, read with `tpufd_torch journal`,
    must hold a cordon intent for `flapper`, none for `card`, and the
    same intents as remedy.RemedyEngine fed the same streams; its engine
    state (/debug/labels) must be the twin's render_json. Returns the
    intents."""
    engine = remedy.RemedyEngine(remedy.RemedyConfig(
        window_s=float(REMEDY_WINDOW_S), heal_dwell_s=2.0, cooldown_s=1.0))
    port = free_loopback_port()
    argv = [str(binary), "--mode=remedy", "--agg-lease-duration=3s",
            f"--remedy-window={REMEDY_WINDOW_S}s", "--remedy-heal-dwell=2s",
            "--remedy-node-cooldown=1s",
            f"--introspection-addr=127.0.0.1:{port}"]
    stderr_path = tmp / "remedy.stderr"
    kinds = ("remedy-cordon", "remedy-rollback", "remedy-drain",
             "remedy-rebuild", "remedy-write-failed")

    def journaled(kind):
        status, body = debug_get(port, f"/debug/journal?type={kind}")
        return json.loads(body)["events"] if status == 200 else []

    with daemon(argv, {**env, "POD_NAME": "remedy-0"}, stderr_path) as proc:
        wait_equal(proc, lambda: bool(journaled("remedy-synced")), True,
                   "remedy-synced", stderr_path)
        # What the controller listed: every node CR and the inventory.
        now = 0.0
        crs = node_crs(server)
        for node, (labels, _) in crs.items():
            engine.observe_node(node, labels, now)
        inventory = fleet_objects(server).get(INVENTORY, ({},))[0]
        engine.observe_inventory(inventory, now)
        own = crs[flapper][0]
        eligible = {**own, agg.PERF_CLASS: "silver"}
        for _ in range(REMEDY_FLAPS):
            for labels in (eligible, own):
                now += 0.1
                server.seed(FLEET_NS, agg.CR_NAME_PREFIX + flapper, labels)
                engine.observe_node(flapper, labels, now)
        demand = {**inventory, QUEUE_DEMAND: str(QUEUED_CHIPS)}
        server.seed(FLEET_NS, INVENTORY, demand)
        engine.observe_inventory(demand, now)
        engine.observe_demand(QUEUED_CHIPS, now)
        actions, blocked = engine.tick(now + 1.0)
        for action in actions:
            engine.note_action_result(action.node, action.kind, True,
                                      now + 1.0)
        want = sorted((a.kind, a.node, a.evidence) for a in actions)
        wait_equal(proc, lambda: len([e for k in kinds
                                      for e in journaled(k)]) >= len(want),
                   True, f"{len(want)} remedy intents", stderr_path)
        doc = json.loads(port_journal(env, "--url",
                                      f"http://127.0.0.1:{port}", "--raw"))
        intents = sorted((e["fields"]["action"], e["fields"]["node"],
                          e["fields"]["evidence"])
                         for e in doc["events"] if e["type"] in kinds)
        require(intents == want, f"the controller's intents {intents} are "
                f"not remedy.RemedyEngine's {want}")
        require(("cordon", flapper, "crash-loop") in intents,
                f"no cordon intent for {flapper}: {intents}")
        require(not [i for i in intents if i[1] == card],
                f"an intent names the card's node {card}: {intents}")
        dry = {e["fields"]["dry_run"] for e in doc["events"]
               if e["type"] in kinds}
        require(dry == {"true"}, f"intents not journaled as dry runs: {dry}")
        state = wait_equal(
            proc, lambda: debug_get(port, "/debug/labels")[1].strip(),
            '{"remedy":%s}' % engine.render_json(),
            "the engine state at /debug/labels", stderr_path)
        stop(proc, say)
    patched = [r for r in server.requests
               if r[0] == "PATCH" and r[1].startswith("/api/v1/nodes")]
    require(not patched, f"the dry run patched nodes: {patched}")
    say(f"--mode=remedy (dry run): intents {intents}, blocked {blocked}, "
        f"equal to remedy.RemedyEngine; none for {card}; no node patched; "
        f"/debug/labels {state}")
    return intents


def cr_node_run(server, env, tmp, slice_labels, say):
    """The daemon on the card as phase 8 runs it, publishing through the
    NodeFeature CR sink into the fake: its CR's tpu.health.* labels
    against phase 4, its tpu.perf.* labels against
    perfmodel.expected_labels of the perf-measure event, and the change
    named by the CR's change-id annotation read back from /debug/trace
    up to publish-acked. Returns the CR's labels."""
    prom = tmp / "fleet-health.prom"
    python = shlex.quote(sys.executable)
    health_exec = (f"{python} -m tpufd_torch health --extended "
                   f"--metrics-out {shlex.quote(str(prom))}")
    perf_exec = f"{python} -m tpufd_torch perfmodel"
    rated_specs, family, specs = stand_in_rated_specs(tmp)
    port = free_loopback_port()
    argv = [str(DAEMON), "--sleep-interval=1s", "--backend=mock",
            f"--mock-topology-file={MOCK_TOPOLOGY}",
            "--machine-type-file=/dev/null", "--use-node-feature-api",
            "--output-file=", f"--introspection-addr=127.0.0.1:{port}",
            "--journal-capacity=4096",
            "--device-health=full", f"--health-exec={health_exec}",
            "--perf-characterize", f"--perf-exec={perf_exec}",
            f"--rated-specs-file={rated_specs}"]
    name = agg.CR_NAME_PREFIX + CARD_NODE
    stderr_path = tmp / "daemon-cr.stderr"
    with daemon(argv, {**env, "NODE_NAME": CARD_NODE}, stderr_path) as proc:
        say(f"daemon pid {proc.pid} on 127.0.0.1:{port}: "
            f"--use-node-feature-api into {server.url} as {CARD_NODE}, "
            f"the execs of phase 8")
        labels = wait_for_labels(
            proc, lambda: fleet_objects(server).get(name, ({},))[0],
            (PREFIX + "dma-copy-gbps", PERF_PREFIX + "class"),
            stderr_path, say, where=f"the CR {name}")
        check_health_labels(labels, slice_labels, prom, "in the CR", say)
        measured = journal_events(env, port, "perf-measure")
        require(measured, "no perf-measure event")
        check_perf_class(labels, measured[-1]["fields"], family, specs, say)
        note = fleet_objects(server)[name][1].get(sink.CHANGE_ANNOTATION)
        require(note and note.isdigit(),
                f"the CR carries no {sink.CHANGE_ANNOTATION}: {note!r}")
        change = int(note)
        deadline = time.monotonic() + FLEET_DEADLINE_S
        while True:
            status, body = debug_get(port, f"/debug/trace?change={change}")
            records = (trace.records_for_change(trace.parse_trace(body),
                                                change)
                       if status == 200 else [])
            if records and trace.PUBLISH_ACKED in records[0]["stages"]:
                break
            require(time.monotonic() < deadline,
                    f"change {change} did not reach {trace.PUBLISH_ACKED} "
                    f"in /debug/trace: {body[-2000:]}")
            time.sleep(0.2)
        record = records[0]
        durations = trace.stage_durations_ms(
            {"minted_ts": record["minted_ts"],
             "stages": list(record["stages"].items())})
        say(f"/debug/trace?change={change} (the CR's "
            f"{sink.CHANGE_ANNOTATION}): origin {record['origin']} "
            f"source {record.get('source')}, generation "
            f"{record['generation']}, reached {trace.PUBLISH_ACKED}; "
            f"stage_durations_ms "
            + ", ".join(f"{k} {v:.3f}" for k, v in durations.items()))
        stop(proc, say)
    return labels


def phase_fleet(slice_labels):
    """Phase 9: the card's labels through the fleet consumers (see the
    module doc)."""
    t0 = time.perf_counter()

    def say(text):
        print(f"[9 fleet +{time.perf_counter() - t0:.1f} s] {text}")

    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp_name:
        tmp = Path(tmp_name)
        kernel_dir = tmp / "kernels"
        build_ahead(kernel_dir, say)
        sa_dir = tmp / "serviceaccount"
        sa_dir.mkdir()
        with FakeApiServer() as server:
            env = fleet_env(deployment_env(tmp_name, kernel_dir), server,
                            sa_dir)
            say(f"fake apiserver {server.url}, namespace {FLEET_NS}")
            labels = cr_node_run(server, env, tmp, slice_labels, say)
            seed_peers(server, say)
            inventory = fleet_aggregator(DAEMON, server, env, tmp, say)
            say(f"inventory fleet matmul p10/p50 "
                f"{inventory.get(agg.FLEET_MATMUL_P10)}/"
                f"{inventory.get(agg.FLEET_MATMUL_P50)} TFLOP/s with the "
                f"card's {labels[agg.PERF_MATMUL]}; capacity by class "
                + ", ".join(f"{k[len(agg.CAPACITY_PREFIX):]} {v}"
                            for k, v in inventory.items()
                            if k.startswith(agg.CAPACITY_PREFIX)))
            fleet_placement(DAEMON, server, env, tmp, CARD_NODE, say)
            fleet_remedy(DAEMON, server, env, tmp, CARD_NODE,
                         "peer-degraded", say)
    say(f"phase 9 in {time.perf_counter() - t0:.1f} s")


def main():
    family = phase_card()
    phase_build()
    phase_matmul_read(2, "first in the process")
    kernels = [phase_kernel(family), phase_chain_tail(family)]
    phase_matmul_read(3, "after the kernel checks")
    moved = 2 * PROBE_SHAPE[0] * PROBE_SHAPE[1] * 2  # bf16, read + write
    launches, slice_labels, slice_seconds = phase_slice(
        family, moved / kernels[0]["library_ms"] / 1e6)
    for kernel in kernels:
        kernel["launches"] = launches[kernel["name"]]
    perf_run = phase_perfmodel()
    phase_burnin()
    phase_multicard(phase_train())
    phase_daemon((slice_labels, slice_seconds), perf_run)
    phase_fleet(slice_labels)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
