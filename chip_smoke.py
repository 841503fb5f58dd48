#!/usr/bin/env python3
"""Drives the PyTorch port (tpufd_torch) on one CUDA card and checks it.

    python3 chip_smoke.py

Run from the root of a checkout: it builds the kernels from the sources
there. Phases, one line or more each; any failure exits non-zero and no
phase catches an exception:

  1. the card: `nvidia-smi` name and power limit;
  2. build every kernel (one nvcc per source, all started together);
  3. every kernel against its plain PyTorch version on the card: bit-exact
     at the probe's shape and at small, ragged and misaligned ones, and at
     the DMA kernel's edges (chunks 3, one row per chunk, chunks smaller
     than a tile and a tile plus 16 bytes, more chunks than the grid
     holds); its C entry point with the output inside a sentinel-filled
     buffer, which must stay untouched around it; the kernel's launch
     plan; the wrapper's refusal of a bad row count; kernel, plain-version
     and library-call times beside the bound, the kernel's time at 2n
     over its time at n, and the kernel no faster than `copy_` beyond
     COPY_NOISE;
  4. the slice: health_labels(extended=True) on cuda:0, with every kernel
     launch count set to 0 just before and read just after, and the
     `dma-copy-gbps` label no higher than `copy_`'s rate beyond
     COPY_NOISE; then each probe's device, wall and enqueue time per
     iteration;
  5. perfmodel's output lines, in the grammar the daemon parses;
  6. the burn-in forward at entry() width, bf16 on the card against the
     port's float32 forward on the host;
  7. a `{"kernels": [...]}` line;
  8. as the last line, `{"ok": true, "device": {...}}`.
"""

import contextlib
import io
import json
import re
import subprocess
import sys
import time

import torch

from tpufd_torch import _build, burnin, dma_copy, graft_entry, health
from tpufd_torch import metrics, perfmodel

PREFIX = "google.com/tpu.health."
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
    t0 = time.perf_counter()
    labels = health.health_labels(extended=True, device=DEVICE)
    seconds = time.perf_counter() - t0
    launches = {"dma_copy": dma_copy.launches}
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
    return launches


def phase_perfmodel():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = perfmodel.main(device=DEVICE)
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
    print(f"[5 perfmodel] {' '.join(lines)}")


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


def main():
    family = phase_card()
    phase_build()
    kernels = [phase_kernel(family)]
    moved = 2 * PROBE_SHAPE[0] * PROBE_SHAPE[1] * 2  # bf16, read + write
    launches = phase_slice(family, moved / kernels[0]["library_ms"] / 1e6)
    for kernel in kernels:
        kernel["launches"] = launches[kernel["name"]]
    phase_perfmodel()
    phase_burnin()
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
