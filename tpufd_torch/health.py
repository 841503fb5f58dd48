"""On-card health / performance probes: the PyTorch port of tpufd/health.py.

The daemon's --device-health=full mode execs ``python3 -m tpufd_torch
health`` and merges the label lines this module renders; --perf-exec
runs the same probes through ``tpufd_torch.perfmodel``. Three probes:

  - the bf16 matmul chain (``_matmul_chain``), TFLOP/s, each of whose
    steps on a card runs the hand-written CUDA kernel of
    ``tpufd_torch.chain_step``, the product with the elementwise tail in
    its epilogue;
  - the HBM sign-flip stream (``_stream``), GB/s read+write;
  - with ``extended=True``, the DMA-copy probe (``dma_copy_gbps``), which
    runs the hand-written CUDA copy kernel of ``tpufd_torch.dma_copy``.

With more than one card, the all-reduce (``allreduce_gbps``, NCCL) runs
on every rank of a process group, one rank per card
(``tpufd_torch.launch``). The reference also sweeps a ring along each
axis of a TPU slice's coordinate grid; CUDA cards expose no coordinates,
so a CUDA node has no per-axis ring and the port publishes no
``ici-<axis>-gbps`` label.

Timing is differential, as in the reference: t(2n) - t(n) over salted
inputs, median of 3 pairs, loop length grown until the difference is
measurable, so launch latency, allocation and host round-trips cancel.
Unlike the reference, which grows the length by 4, the timer goes on at
the length that a measured cost per iteration predicts just over the
threshold, so a label rests on a difference just past it.
PyTorch runs eagerly, so where the reference runs one executable with a
traced n, a probe here enqueues n iterations from a Python loop. At the
card sizes every iteration holds the device for far longer than its
launches take to enqueue.

Every probe reading is a ``probe`` span on ``tpufd_torch.spans``'
recorder, and the timer records its calibration steps and runs under
it (``_time_iters``); ``tpufd_timer_iterations_total`` counts the loop
iterations it ran, those the label rests on apart, and
``tpufd_timer_jumps_total`` the calls that aimed a length at the
threshold.

Probes run on a CUDA card unless the caller passes device="cpu" (the
tests do). With no card and no explicit CPU request they raise.
"""

import itertools
import math
import os
import statistics
import sys
import time

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from tpufd_torch import chain_step as chain_step_lib
from tpufd_torch import chain_tail as chain_tail_lib
from tpufd_torch import dma_copy as dma_copy_lib
from tpufd_torch import launch
from tpufd_torch import metrics
from tpufd_torch import sched as sched_lib
from tpufd_torch import spans
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


# After a step that falls short of settle_s with a median m > 0 at n, the
# timer goes on at the least multiple of iters whose median a cost per
# iteration predicts at _AIM times settle_s, at least 2n, but never past
# the least iters * 4**k predicted at settle_s (the length at which the
# reference's ladder stops when the cost holds) nor past the cap. _AIM
# covers how far a step's cost per iteration falls below the cost it was
# aimed from: on an H100 by 12.8% at most where a first step of a few
# milliseconds set it (459 calls of the three card probes); where an
# accepted step or a pilot set it, no aimed step read under 1.12 times
# settle_s (579 calls).
_AIM = 1.15
# The cost is the step's own, m / n, where m reaches this share of
# settle_s. Below it a cost is not close enough to aim from: an H100's
# matmul, at its power cap, runs a few milliseconds up to 4% off its
# mean pace, and an aim that far off moves the card time of the reading.
# There the timer aims from the cost per iteration of the last step it
# accepted for the same work (``key``), or, with none, first runs a pilot
# step aimed at this share of _AIM times settle_s: on an H100 a pilot of
# that length read the matmul's cost within 1.3% (0.4% standard
# deviation), one of 1/16 within 3.5% (1.2%).
_PILOT = 1 / 4
# seconds per iteration of the last accepted step, per key
_accepted_cost = {}


def _next_length(n, median, iters, settle_s, known=None):
    """(the next length, whether it is aimed at settle_s) after a step
    at `n` whose median difference `median` ended nothing: aimed from a
    cost per iteration (see _AIM and _PILOT; `known`, the last accepted
    cost of the same work, or None), four times `n` where the step
    measured no cost; at most iters * 1024, the cap. The length is aimed
    unless it is a pilot short of the cap or four times `n`."""
    cap = iters * 1024
    if median <= 0:
        return min(4 * n, cap), False
    coarse = median < _PILOT * settle_s
    cost = known if coarse and known is not None else median / n
    pilot = coarse and known is None
    aim = _AIM * settle_s * (_PILOT if pilot else 1)
    rung = 4 * iters
    while rung < cap and (rung <= n or cost * rung < settle_s):
        rung *= 4
    aimed = iters * math.ceil(min(aim / (cost * iters), 1024))
    following = min(max(aimed, 2 * n), rung)
    return following, not pilot or following == cap


def _time_iters(fn, iters, settle_s=0.5, agree_on=None, key=None):
    """Seconds attributable to `iters` loop iterations alone.

    `fn(n, salt)` must run `n` loop iterations and fold `salt` into its
    input. Times runs at n and 2n and returns the difference, so fixed
    per-call overhead cancels instead of polluting the throughput number.

    The first step runs at n = iters; a step whose median difference
    reaches `settle_s` is accepted, as in the reference, and so is one at
    the cap, iters * 1024, unless its median is under settle_s / 2 (then
    it raises). Unlike the reference, which goes on at 4n, the timer goes
    on at the least multiple of iters whose median a measured cost per
    iteration predicts at _AIM times settle_s (``_next_length``), so the
    label rests on a difference just over settle_s, not on one up to four
    times it. That length is never past the least iters * 4**k predicted
    at settle_s: with a cost linear in n the timer accepts a multiple of
    iters no larger than the reference's n and returns the reference's
    seconds. A step too short to measure its cost closely (under _PILOT
    of settle_s) aims from the last cost accepted under `key`, a hashable
    that names the work of one iteration on one device; with no `key` or
    none accepted yet, a pilot step at _PILOT of that aim comes first.

    When `fn` runs collectives, every rank of the process group must run
    the same sequence of n: `agree_on` (the device of the ranks'
    collectives) makes every calibration step judge the largest median
    difference of all ranks, agreed outside the timed runs, and all ranks
    return that time; each next length, and the cost kept under `key`,
    comes from that agreed median too.

    Raises RuntimeError when the difference is not measurable (jitter or
    caching swamped it); callers must treat that as probe failure, not as
    infinite throughput.

    Records a ``timer`` span (``settle_s``; ``iterations_run``: every
    loop iteration fn was asked for, the warm-up's included;
    ``iterations_label``: those of the step the result rests on, 0 when
    it raises), a ``timer.step`` span per calibration step (``n``, the
    three ``differences`` in the order run, ``accepted``, and ``jumped``
    on the first step aimed at settle_s) and a ``timer.run`` span per run
    of fn, from its call to the fetch's return (``n``, ``salt``,
    ``role``: warm, n or 2n). The enclosing ``probe`` span names the
    probe in ``tpufd_timer_iterations_total`` and
    ``tpufd_timer_jumps_total``.
    """
    recorder = spans.default_recorder()
    request = recorder.current_request()
    probe = (request.attrs.get("probe", "")
             if request is not None and request.name == "probe" else "")
    warmed = False
    iterations_run = iterations_label = 0
    jumped_to = jump_outcome = None

    def once(n, role):
        nonlocal iterations_run
        salt = _salt()
        iterations_run += n
        with recorder.span("timer.run", n=n, salt=salt, role=role):
            start = time.perf_counter()
            _fetch_scalar(fn(n, salt))
            return time.perf_counter() - start

    def run(n, role):
        nonlocal warmed
        if not warmed:  # first-use costs (kernel build, allocator) excluded
            once(n, "warm")
            warmed = True
        return once(n, role)

    with recorder.span("timer", settle_s=settle_s) as timer:
        try:
            # Calibrate on the DIFFERENTIAL, not single-run wall time, and
            # judge every step by the median of 3 pairs: a single pair can
            # be faked by jitter. Grow the loop until median(t(2n) - t(n))
            # is measurable.
            n = iters
            while True:
                with recorder.span("timer.step", n=n) as step:
                    if n == jumped_to:
                        step.attrs["jumped"] = True
                    diffs = [run(2 * n, "2n") - run(n, "n")
                             for _ in range(3)]
                    step.attrs["differences"] = diffs
                    diffs = sorted(diffs)
                    # median rides out jitter
                    median = _agree_max(diffs[1], agree_on)
                    ended = median >= settle_s or n >= iters * 1024
                    accepted = ended and not median < settle_s / 2
                    step.attrs["accepted"] = accepted
                if n == jumped_to:
                    jump_outcome = ("accepted" if accepted else
                                    "unmeasurable" if ended else "climbed")
                if ended:
                    break
                n_next, aimed = _next_length(n, median, iters, settle_s,
                                             _accepted_cost.get(key))
                if aimed and jumped_to is None:
                    jumped_to = n_next
                n = n_next
            seconds_for_n = median
            if seconds_for_n < settle_s / 2:
                # Hitting the calibration cap with the diff still below the
                # floor means device time never grew with the loop length
                # — a tiny positive diff here would report an absurd
                # throughput as healthy.
                raise RuntimeError(
                    f"unmeasurable device time (median diff "
                    f"{seconds_for_n:.2g}s at {n} iterations); not "
                    f"reporting a throughput")
            iterations_label = n
            if key is not None:
                _accepted_cost[key] = seconds_for_n / n
            return seconds_for_n * iters / n  # normalize back to `iters`
        finally:
            timer.attrs["iterations_run"] = iterations_run
            timer.attrs["iterations_label"] = iterations_label
            _count_iterations(probe, iterations_run, iterations_label)
            _count_jump(probe, jump_outcome)


def _count_iterations(probe, run, label):
    """Adds one timer call's body iterations to the registry: `label`,
    those of the step the label rests on, and the rest of `run`, the
    warm-up's and the calibration ladder's."""
    reg = metrics.default_registry()
    help_text = ("Loop iterations of a probe body that the differential "
                 "timer ran, per probe: role=label those of the step the "
                 "label rests on, role=calibration the warm-up's and the "
                 "calibration ladder's.")
    for role, count in (("label", label), ("calibration", run - label)):
        reg.counter("tpufd_timer_iterations_total", help_text,
                    labels={"probe": probe, "role": role}).inc(count)


_JUMP_OUTCOMES = ("accepted", "climbed", "unmeasurable")


def _count_jump(probe, outcome):
    """Counts one timer call that aimed a step at settle_s under the
    `outcome` of its first such step (None: it aimed none, or that step
    never ended); every outcome's series is kept, at 0 until it
    happens."""
    reg = metrics.default_registry()
    help_text = ("Differential timer calls that aimed a calibration "
                 "length at the settle threshold from a measured cost per "
                 "iteration, per probe, by what the first such step did: "
                 "outcome=accepted the label rests on it, outcome=climbed "
                 "the timer went on to longer runs, outcome=unmeasurable "
                 "it was the last length and the timer raised.")
    for name in _JUMP_OUTCOMES:
        reg.counter("tpufd_timer_jumps_total", help_text,
                    labels={"probe": probe, "outcome": name}).inc(
                        int(outcome == name))


def _settle_s(device):
    """A card's differential must clear launch and clock jitter by a wide
    margin; CPU/test runs keep probes fast."""
    return 0.15 if device.type == "cuda" else 0.02


def probe_sizes(device):
    """(matmul size, stream MiB, all-reduce MiB) of the probes that
    health_labels and perfmodel.measure run on `device`: the card's on a
    card (the benchmark's configurations cite them), small on the CPU.
    The DMA-copy probe copies half the stream's MiB."""
    if device.type == "cuda":
        return 4096, 512, 64
    return 512, 32, 8


def _matmul_chain(x, n):
    """n steps of acc <- tanh(acc @ acc) * 0.5 + acc * 0.5 (the reference's
    _matmul_chain), in place on x, which it returns. The tail is computed
    in float32 from the product rounded to x's dtype and rounded once;
    halving is exact away from underflow, so (tanh(p) + acc) * 0.5 is the
    reference's form.

    An x that chain_step takes (a CUDA bf16 square matrix of a size that
    is a multiple of 8: every card caller) runs each step as one kernel,
    the product with the tail in its epilogue, as XLA fuses the
    reference's body. A step cannot write the matrix it reads, so the
    steps alternate between x and a second buffer, and an odd n ends
    with one copy back into x. Any other x runs each step as one product
    and one fused elementwise pass (chain_tail: the CUDA kernel on the
    card, its plain version on the CPU), in place."""
    if not chain_step_lib.takes_fused_step(x):
        for _ in range(n):
            chain_tail_lib.chain_tail(x @ x, x)
        return x
    src, dst = x, torch.empty_like(x)
    for _ in range(n):
        chain_step_lib.chain_step(src, dst)
        src, dst = dst, src
    if src is not x:
        x.copy_(src)
    return x


def _matmul_probe_fn(device, size):
    """fn(n, salt): n chain steps on a salted (size, size) bf16 input."""
    x = torch.full((size, size), 0.001, dtype=torch.bfloat16, device=device)
    return lambda n, salt: _matmul_chain(x * salt, n)


def matmul_tflops(device=None, size=4096, iters=8):
    """Measured bf16 matmul TFLOP/s on one card."""
    with spans.span("probe", probe="matmul-tflops"):
        device = resolve_device(device)
        seconds = _time_iters(_matmul_probe_fn(device, size), iters,
                              settle_s=_settle_s(device),
                              key=("matmul-tflops", device, size))
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
    with spans.span("probe", probe="hbm-gbps"):
        device = resolve_device(device)
        n = mib * 1024 * 1024 // 2  # bf16 elements
        seconds = _time_iters(_stream_probe_fn(device, mib), iters,
                              settle_s=_settle_s(device),
                              key=("hbm-gbps", device, mib))
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
    with spans.span("probe", probe="dma-copy-gbps"):
        device = resolve_device(device)
        rows, cols = _dma_copy_shape(mib, chunks)
        seconds = _time_iters(_dma_copy_probe_fn(device, mib, chunks),
                              iters, settle_s=_settle_s(device),
                              key=("dma-copy-gbps", device, mib, chunks))
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
    with spans.span("probe", probe="allreduce-gbps"):
        axis = mesh.mesh_dim_names[0]
        k = mesh.size()
        n = mib * 1024 * 1024 // 2
        device = resolve_device(mesh.device_type)
        x = torch.ones(n // k, dtype=torch.bfloat16, device=device)
        group = mesh.get_group(axis)
        seconds = _time_iters(
            lambda it, salt: _allreduce_loop(x * salt, it, group), iters,
            settle_s=_settle_s(device), agree_on=device,
            key=("allreduce-gbps", device, mib, k))
        bytes_moved = 2.0 * n * 2 * (k - 1) / k * iters
        return bytes_moved / seconds / 1e9


def _allreduce_rank(device_type, mib):
    """Rank body of the all-reduce label: median of 3 over every rank."""
    mesh = init_device_mesh(device_type, (dist.get_world_size(),),
                            mesh_dim_names=("all",))
    return median_probe(lambda: allreduce_gbps(mesh, mib=mib))


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
    cards); its failure sets ok=false. No ici-<axis>-gbps label follows:
    the reference sweeps the axes of a TPU slice's coordinate grid, and
    CUDA cards form none.
    """
    device = resolve_device(device)
    n_devices = len(_visible_devices(device))
    size, mib, allreduce_mib = probe_sizes(device)
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
                    args=(device.type, allreduce_mib))))
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
