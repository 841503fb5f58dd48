"""On-card health / performance probes: the PyTorch port of tpufd/health.py.

The daemon's --device-health=full mode execs ``python3 -m tpufd_torch
health`` and merges the label lines this module renders; --perf-exec
runs the same probes through ``tpufd_torch.perfmodel``. Three probes:

  - the bf16 matmul chain (``_matmul_chain``), TFLOP/s, whose elementwise
    tail runs the hand-written CUDA kernel of ``tpufd_torch.chain_tail``;
  - the HBM sign-flip stream (``_stream``), GB/s read+write;
  - with ``extended=True``, the DMA-copy probe (``dma_copy_gbps``), which
    runs the hand-written CUDA copy kernel of ``tpufd_torch.dma_copy``.

With more than one card, two multi-device probes run on every rank of a
process group, one rank per card (``tpufd_torch.launch``): the all-reduce
(``allreduce_gbps``, NCCL) and, over a coordinate grid of devices, the
per-axis ring (``ici_axis_gbps``, point-to-point sends).

Timing is differential, as in the reference: t(2n) - t(n) over salted
inputs, median of 3 pairs, loop length grown until the difference is
measurable, so launch latency, allocation and host round-trips cancel.
PyTorch runs eagerly, so where the reference runs one executable with a
traced n, a probe here enqueues n iterations from a Python loop. At the
card sizes every iteration holds the device for far longer than its
launches take to enqueue.

Probes run on a CUDA card unless the caller passes device="cpu" (the
tests do). With no card and no explicit CPU request they raise.
"""

import itertools
import os
import statistics
import sys
import time

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from tpufd_torch import chain_tail as chain_tail_lib
from tpufd_torch import dma_copy as dma_copy_lib
from tpufd_torch import launch
from tpufd_torch import metrics
from tpufd_torch import sched as sched_lib
from tpufd_torch.perfmodel import load_rated_specs

_RATED = load_rated_specs()
RATED_MATMUL_TFLOPS = {fam: s["matmul_tflops"] for fam, s in _RATED.items()}
RATED_HBM_GBPS = {fam: s["hbm_gbps"] for fam, s in _RATED.items()}
# Below this share of rated throughput the card is flagged degraded. Wide
# on purpose: a streaming loop lands well below the data-sheet pin rate on
# healthy silicon, so only a genuinely sick card may cross it.
DEGRADED_PCT = 50


def pct_of_rated(measured, family, rated_table):
    """Measured throughput as a percentage of the family's rated peak;
    None when the family (or its rating) is unknown."""
    rated = rated_table.get(family) if family else None
    if not rated:
        return None
    return round(100.0 * measured / rated, 1)


def family_of_name(name):
    """Rated-table key of a CUDA device name ("NVIDIA H100 80GB HBM3" ->
    "h100-sxm", "NVIDIA H100 PCIe" -> "h100-pcie"); None for any other
    card, so an unknown SKU never borrows another SKU's peaks."""
    name = name.lower()
    if "h100" not in name:
        return None
    if "pcie" in name:
        return "h100-pcie"
    if "hbm3" in name or "sxm" in name:
        return "h100-sxm"
    return None


def family_of(device):
    """Rated-table key of a torch device; None for the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return family_of_name(torch.cuda.get_device_name(device))


def _visible_devices(device):
    """The devices a probe on `device` can span: every visible CUDA card
    for a card, the host alone for the CPU."""
    if device.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [device]


def resolve_device(device=None):
    """The device the probes run on: the current CUDA card by default,
    the CPU only when asked for. Raises RuntimeError when a card is
    wanted and none is visible; never falls back to the CPU."""
    if device is None:
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible; pass device='cpu' "
                "(--device cpu) to run the probes on the host")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    elif device.type != "cpu":
        raise ValueError(f"probes run on 'cuda' or 'cpu', not {device}")
    return device


def _fetch_scalar(result):
    """Forces completion by reading ONE element back to the host (which
    synchronises the stream); only a scalar crosses to the host."""
    return float(result.reshape(-1)[0])


_salt_counter = itertools.count(1)


def _salt():
    """A fresh scalar per invocation, sized to be exactly representable in
    bf16 next to O(1) data (0.125 steps — a raw tiny epsilon would round
    away and leave inputs bit-identical), so no layer between host and
    device can serve a memoized result."""
    return (next(_salt_counter) % 13 + 1) * 0.125


def _agree_max(value, device):
    """The largest of every rank's `value` (an all-reduce on `device`);
    `value` itself when device is None (this process alone)."""
    if device is None:
        return value
    agreed = torch.tensor([value], dtype=torch.float64, device=device)
    dist.all_reduce(agreed, op=dist.ReduceOp.MAX)
    return float(agreed)


def _time_iters(fn, iters, settle_s=0.5, agree_on=None):
    """Seconds attributable to `iters` loop iterations alone.

    `fn(n, salt)` must run `n` loop iterations and fold `salt` into its
    input. Times runs at n and 2n and returns the difference, so fixed
    per-call overhead cancels instead of polluting the throughput number.

    When `fn` runs collectives, every rank of the process group must run
    the same sequence of n: `agree_on` (the device of the ranks'
    collectives) makes every calibration step judge the largest median
    difference of all ranks, agreed outside the timed runs, and all ranks
    return that time.

    Raises RuntimeError when the difference is not measurable (jitter or
    caching swamped it); callers must treat that as probe failure, not as
    infinite throughput.
    """
    warmed = False

    def run(n):
        nonlocal warmed
        if not warmed:  # first-use costs (kernel build, allocator) excluded
            _fetch_scalar(fn(n, _salt()))
            warmed = True
        start = time.perf_counter()
        _fetch_scalar(fn(n, _salt()))
        return time.perf_counter() - start

    # Calibrate on the DIFFERENTIAL, not single-run wall time, and judge
    # every step by the median of 3 pairs: a single pair can be faked by
    # jitter. Grow the loop until median(t(2n) - t(n)) is measurable.
    n = iters
    while True:
        diffs = sorted(run(2 * n) - run(n) for _ in range(3))
        median = _agree_max(diffs[1], agree_on)  # median rides out jitter
        if median >= settle_s or n >= iters * 1024:
            break
        n *= 4
    seconds_for_n = median
    if seconds_for_n < settle_s / 2:
        # Hitting the calibration cap with the diff still below the floor
        # means device time never grew with the loop length — a tiny
        # positive diff here would report an absurd throughput as healthy.
        raise RuntimeError(
            f"unmeasurable device time (median diff {seconds_for_n:.2g}s "
            f"at {n} iterations); not reporting a throughput")
    return seconds_for_n * iters / n  # normalize back to `iters`


def _settle_s(device):
    """A card's differential must clear launch and clock jitter by a wide
    margin; CPU/test runs keep probes fast."""
    return 0.15 if device.type == "cuda" else 0.02


def _matmul_chain(x, n):
    """n steps of acc <- tanh(acc @ acc) * 0.5 + acc * 0.5 (the reference's
    _matmul_chain), in place on x, which it returns. Each step is one
    product and one fused elementwise pass (chain_tail: the CUDA kernel
    on the card, its plain version on the CPU), as XLA fuses the
    reference's tail. The tail is computed in float32 and rounded once;
    halving is exact away from underflow, so (tanh(p) + acc) * 0.5 is the
    reference's form."""
    for _ in range(n):
        chain_tail_lib.chain_tail(x @ x, x)
    return x


def _matmul_probe_fn(device, size):
    """fn(n, salt): n chain steps on a salted (size, size) bf16 input."""
    x = torch.full((size, size), 0.001, dtype=torch.bfloat16, device=device)
    return lambda n, salt: _matmul_chain(x * salt, n)


def matmul_tflops(device=None, size=4096, iters=8):
    """Measured bf16 matmul TFLOP/s on one card."""
    device = resolve_device(device)
    seconds = _time_iters(_matmul_probe_fn(device, size), iters,
                          settle_s=_settle_s(device))
    return 2.0 * size * size * size * iters / seconds / 1e12


def _stream(x, n):
    """n sign flips of x in place (the counterpart of the reference's
    donated _stream loop): the cheapest per-element transform, so each
    iteration is one read and one write of the buffer. Returns x."""
    for _ in range(n):
        x.neg_()
    return x


def _stream_probe_fn(device, mib):
    """fn(n, salt): n in-place sign flips of a salted mib-MiB bf16 buffer."""
    x = torch.zeros(mib * 1024 * 1024 // 2, dtype=torch.bfloat16,
                    device=device)
    return lambda k, salt: _stream(x + salt, k)


def hbm_gbps(device=None, mib=512, iters=16):
    """Measured HBM streaming bandwidth (GB/s, read+write) on one card."""
    device = resolve_device(device)
    n = mib * 1024 * 1024 // 2  # bf16 elements
    seconds = _time_iters(_stream_probe_fn(device, mib), iters,
                          settle_s=_settle_s(device))
    return 2.0 * n * 2 * iters / seconds / 1e9  # read + write per iter


def _dma_copy_shape(mib, chunks):
    """(rows, 1024) bf16 of about mib MiB, rows a multiple of chunks."""
    cols = 1024
    return max(mib * 1024 * 1024 // 2 // cols // chunks, 1) * chunks, cols


def _dma_copy_probe_fn(device, mib, chunks):
    """fn(n, salt): the copy kernel, n repeats, on a salted bf16 array."""
    x = torch.zeros(_dma_copy_shape(mib, chunks), dtype=torch.bfloat16,
                    device=device)
    return lambda k, salt: dma_copy_lib.dma_copy(x + salt, k, chunks)


def dma_copy_gbps(device=None, mib=256, iters=16, chunks=2):
    """Measured HBM->HBM bandwidth (GB/s, read+write) of the copy kernel
    in `chunks` row blocks: a diagnostic companion to hbm_gbps, since a
    card where the two disagree sharply has a sick path, not sick HBM.
    On the CPU the plain version runs: the plumbing is covered, the
    number means nothing."""
    device = resolve_device(device)
    rows, cols = _dma_copy_shape(mib, chunks)
    seconds = _time_iters(_dma_copy_probe_fn(device, mib, chunks), iters,
                          settle_s=_settle_s(device))
    return 2.0 * rows * cols * 2 * iters / seconds / 1e9


# ---- multi-device probes: run on every rank of a process group -------------

def _allreduce_loop(acc, n, group):
    """n steps of acc <- acc + all_reduce(acc) * 1e-6 (the reference's
    reduce_loop: the sum over the ranks' rows, kept bounded). all_reduce
    works in place, so each step reduces a copy."""
    for _ in range(n):
        summed = acc.clone()
        dist.all_reduce(summed, group=group)
        acc = acc + summed * 1e-6
    return acc


def allreduce_gbps(mesh, mib=64, iters=8):
    """All-reduce bandwidth (GB/s) over the first axis of `mesh`, on every
    rank: each rank holds one row of n // k bf16 elements (n = mib MiB,
    k ranks), as the reference shards its (k, n // k) array.

    The byte count is the reference's, 2 (k - 1) / k of all n elements per
    step, though each rank reduces its one row of n / k: the label reads
    k times the bus bandwidth of that reduction. At k = 1 it is 0."""
    axis = mesh.mesh_dim_names[0]
    k = mesh.size()
    n = mib * 1024 * 1024 // 2
    device = resolve_device(mesh.device_type)
    x = torch.ones(n // k, dtype=torch.bfloat16, device=device)
    group = mesh.get_group(axis)
    seconds = _time_iters(
        lambda it, salt: _allreduce_loop(x * salt, it, group), iters,
        settle_s=_settle_s(device), agree_on=device)
    bytes_moved = 2.0 * n * 2 * (k - 1) / k * iters
    return bytes_moved / seconds / 1e9


def _coords_grid(devices):
    """Arranges devices into a dense coordinate grid: (ndarray, axis
    names) with size-1 axes dropped, or (None, None) when the devices
    don't form one: coords missing (CUDA and CPU devices expose none),
    duplicated, or sparse (a non-contiguous box). The reference's
    arrangement logic, unchanged."""
    coords = [getattr(d, "coords", None) for d in devices]
    if (any(c is None for c in coords)
            or len({tuple(c) for c in coords}) != len(devices)):
        return None, None
    dims = len(coords[0])
    lo = [min(c[i] for c in coords) for i in range(dims)]
    shape = [max(c[i] for c in coords) - lo[i] + 1 for i in range(dims)]
    if int(np.prod(shape)) != len(devices):
        return None, None  # sparse box: no well-defined ring per axis
    grid = np.empty(shape, dtype=object)
    for d, c in zip(devices, coords):
        grid[tuple(ci - li for ci, li in zip(c, lo))] = d
    keep = [i for i, s in enumerate(shape) if s > 1] or [0]
    return (grid.reshape([shape[i] for i in keep]),
            tuple("xyz"[i] if i < 3 else f"d{i}" for i in keep))


def physical_mesh(devices, device_type):
    """DeviceMesh over the devices' coordinate grid (axes x/y/z), rank r
    standing for devices[r], or a flat ("all",) mesh when they form none,
    as for every CUDA card. Runs on every rank, with the same devices."""
    grid, names = _coords_grid(devices)
    if grid is None:
        return init_device_mesh(device_type, (len(devices),),
                                mesh_dim_names=("all",))
    rank_of = {id(d): r for r, d in enumerate(devices)}
    ranks = np.vectorize(lambda d: rank_of[id(d)], otypes=[np.int64])(grid)
    return DeviceMesh(device_type, torch.from_numpy(ranks),
                      mesh_dim_names=names)


def ring_shift(tensors, mesh, axis):
    """Sends this rank's `tensors` to its +1 neighbour along `axis` of
    `mesh` (in mesh order, wrapping) and returns the -1 neighbour's, in
    fresh buffers, in one batch_isend_irecv: the reference's
    lax.ppermute over perm [(i, i + 1 mod n)]. An axis of one rank keeps
    its own tensors."""
    dim = mesh.mesh_dim_names.index(axis)
    coord = mesh.get_coordinate()
    line = mesh.mesh[tuple(slice(None) if d == dim else c
                           for d, c in enumerate(coord))].tolist()
    n, me = len(line), coord[dim]
    if n == 1:
        return list(tensors)
    group = mesh.get_group(axis)
    dst, src = line[(me + 1) % n], line[(me - 1) % n]
    tensors = [t.contiguous() for t in tensors]  # what P2P sends take
    received = [torch.empty_like(t) for t in tensors]
    ops = []
    for tag, (t, r) in enumerate(zip(tensors, received)):
        ops += [dist.P2POp(dist.isend, t, dst, group, tag),
                dist.P2POp(dist.irecv, r, src, group, tag)]
    for request in dist.batch_isend_irecv(ops):
        request.wait()
    return received


def _shift_loop(x, n, mesh, axis):
    """n ring shifts of x along `axis`."""
    for _ in range(n):
        (x,) = ring_shift([x], mesh, axis)
    return x


def ici_axis_gbps(mesh, axis, mib=64, iters=8):
    """Per-device send throughput (GB/s) around ONE mesh axis, on every
    rank: each rank's shard of a (rows, 1024) bf16 array of about mib MiB
    goes to its +1 neighbour on the axis, `iters` times, so the traffic
    rides that axis's links alone (the reference's ppermute ring)."""
    n_axis = mesh.size(mesh.mesh_dim_names.index(axis))
    cols = 1024
    rows = max(mib * 1024 * 1024 // 2 // cols // n_axis, 1) * n_axis
    device = resolve_device(mesh.device_type)
    # ones, not zeros: the salt folds in multiplicatively.
    x = torch.ones((rows // n_axis, cols), dtype=torch.bfloat16,
                   device=device)
    seconds = _time_iters(
        lambda k, salt: _shift_loop(x * salt, k, mesh, axis), iters,
        settle_s=_settle_s(device), agree_on=device)
    bytes_sent_per_device = rows * cols * 2 / n_axis
    return bytes_sent_per_device * iters / seconds / 1e9


def _allreduce_rank(device_type, mib):
    """Rank body of the all-reduce label: median of 3 over every rank."""
    mesh = init_device_mesh(device_type, (dist.get_world_size(),),
                            mesh_dim_names=("all",))
    return median_probe(lambda: allreduce_gbps(mesh, mib=mib))


def _ici_axis_rank(devices, device_type, axis, mib):
    """Rank body of one ici-<axis>-gbps label: median of 3."""
    mesh = physical_mesh(devices, device_type)
    return median_probe(lambda: ici_axis_gbps(mesh, axis, mib=mib))


def median_probe(fn, runs=3):
    """Median of `runs` independent probe executions: a single
    differential pair can still catch jitter and read above peak."""
    return statistics.median(fn() for _ in range(runs))


def timed_probe(name, fn):
    """Runs `fn` and records its wall time (and failure, if it raises)
    into the metrics registry under probe=`name`, surfaced through
    ``python -m tpufd_torch health --metrics-out``. Re-raises, so callers
    keep their own failure policy."""
    reg = metrics.default_registry()
    start = time.perf_counter()
    try:
        return fn()
    except Exception:
        reg.counter("tpufd_probe_failures_total",
                    "Health probes that raised, per probe.",
                    labels={"probe": name}).inc()
        raise
    finally:
        reg.histogram("tpufd_probe_duration_seconds",
                      "Wall time of one health probe (median-of-N "
                      "included), per probe.",
                      labels={"probe": name}).observe(
                          time.perf_counter() - start)


def health_labels(prefix="google.com/tpu.health.", extended=False,
                  device=None):
    """Runs the probes and returns a label dict, e.g.
    {"google.com/tpu.health.matmul-tflops": "612", ...}, with the label
    names and prefix the daemon merges. Values are whole numbers at card
    scale; below 10 they carry two significant digits — parse with
    float(). Probe sizes are the card's on a card and small on the CPU.

    extended=True adds the DMA-copy kernel's probe (dma-copy-gbps). Its
    failure is written to stderr and leaves ok=true: it is an opt-in
    diagnostic, and the core probes already measured the card.

    With more than one visible card, allreduce-gbps (median of 3) runs
    over all of them, one rank per card (launch.spawn_ranks: NCCL on the
    cards); its failure sets ok=false. Then, where the cards form a
    coordinate grid (_coords_grid; CUDA cards expose none, so never on a
    CUDA node), one ici-<axis>-gbps label per axis, each in its own try:
    a failed axis writes a stderr note and leaves ok alone.
    """
    device = resolve_device(device)
    on_card = device.type == "cuda"
    devices = _visible_devices(device)
    n_devices = len(devices)
    size = 4096 if on_card else 512
    mib = 512 if on_card else 32
    family = family_of(device)
    labels = {}

    def fmt(v):
        """Throughput as a label value: whole numbers at card scale, two
        significant digits below 10, so a small-but-real measurement never
        publishes as "0" (which reads as probe failure)."""
        return str(int(v)) if v >= 10 else f"{v:.2g}"

    def with_rated(measured, rated_table, name):
        """Publishes measured + rated + pct-of-rated (+ degraded flag)."""
        labels[prefix + name] = fmt(measured)
        pct = pct_of_rated(measured, family, rated_table)
        if pct is not None:
            labels[prefix + name + "-rated"] = str(int(rated_table[family]))
            labels[prefix + name + "-pct-of-rated"] = str(int(round(pct)))
            if pct < DEGRADED_PCT:
                labels[prefix + name + "-degraded"] = "true"

    # Core probes retry through the probe scheduler: a transient raise
    # retries with the shared jittered backoff instead of flipping
    # ok=false at once.
    scheduler = sched_lib.ProbeScheduler(
        retry_budget=int(os.environ.get("TPUFD_PROBE_RETRIES", "1")))

    probe_t0 = time.perf_counter()
    try:
        with_rated(scheduler.run("matmul-tflops", lambda: timed_probe(
            "matmul-tflops", lambda: median_probe(
                lambda: matmul_tflops(device=device, size=size)))),
                   RATED_MATMUL_TFLOPS, "matmul-tflops")
        with_rated(scheduler.run("hbm-gbps", lambda: timed_probe(
            "hbm-gbps", lambda: median_probe(
                lambda: hbm_gbps(device=device, mib=mib)))),
                   RATED_HBM_GBPS, "hbm-gbps")
        if extended:
            try:
                with_rated(timed_probe("dma-copy-gbps",
                                       lambda: median_probe(
                                           lambda: dma_copy_gbps(
                                               device=device,
                                               mib=mib // 2))),
                           RATED_HBM_GBPS, "dma-copy-gbps")
            except Exception as e:  # noqa: BLE001 — opt-in diagnostic
                sys.stderr.write(f"dma-copy probe skipped: {e}\n")
        if n_devices > 1:
            labels[prefix + "allreduce-gbps"] = fmt(timed_probe(
                "allreduce-gbps", lambda: launch.spawn_ranks(
                    _allreduce_rank, n_devices, device.type,
                    args=(device.type, 64 if on_card else 8))))
            try:
                _, axes = _coords_grid(devices)
            except Exception as e:  # noqa: BLE001 — hostile coords must
                # not flip ok=false on cards the core probes measured.
                sys.stderr.write(f"ici sweep mesh skipped: {e}\n")
                axes = None
            for ax in axes or ():
                try:
                    labels[prefix + f"ici-{ax}-gbps"] = fmt(timed_probe(
                        f"ici-{ax}-gbps", lambda ax=ax: launch.spawn_ranks(
                            _ici_axis_rank, n_devices, device.type,
                            args=(devices, device.type, ax,
                                  64 if on_card else 4))))
                except Exception as e:  # noqa: BLE001 — a localisation
                    # diagnostic: one axis failing hides no other.
                    sys.stderr.write(f"ici sweep axis {ax} skipped: {e}\n")
        labels[prefix + "ok"] = "true"
    except Exception as e:  # noqa: BLE001 — any device failure: unhealthy
        sys.stderr.write(f"health probe failed: {e!r}\n")
        labels[prefix + "ok"] = "false"

    reg = metrics.default_registry()
    reg.gauge("tpufd_health_duration_seconds",
              "Wall time of the whole health_labels run.").set(
                  time.perf_counter() - probe_t0)
    reg.gauge("tpufd_health_ok",
              "1 when the core probes measured healthy, else 0.").set(
                  1 if labels.get(prefix + "ok") == "true" else 0)
    # Enumeration cross-check: the daemon exports ITS chip count
    # (TFD_CHIP_COUNT) when exec'ing this probe. A mismatch labels loudly
    # but does NOT flip ok=false: the cards this process saw measured
    # healthy. The label names are the daemon's (devices-jax included).
    count_env = os.environ.get("TFD_CHIP_COUNT", "")
    if count_env.isdigit():
        consistent = n_devices == int(count_env)
        labels[prefix + "devices-consistent"] = (
            "true" if consistent else "false")
        if not consistent:
            labels[prefix + "devices-jax"] = str(n_devices)
    return labels
