"""The DMA-copy kernel's plain version against the Pallas kernel it
replaces (tpufd.health._dma_copy_fn, in interpret mode as the JAX
package's own tests run it), and the wrapper's checks on this CPU-only
host. The CUDA kernel itself is checked on the card by chip_smoke.py."""

import re

import numpy as np
import pytest
import torch

from portbench.metrics import dma_copy_roofline_pct
from tpufd_torch import _build, dma_copy, health


def bf16_pair(rows, cols, seed):
    """The same bf16 values as a jax array and a torch tensor, from
    float32 numpy data (both round to nearest even)."""
    import jax.numpy as jnp

    data = np.random.default_rng(seed).standard_normal(
        (rows, cols), dtype=np.float32) * 4
    return (jnp.asarray(data, dtype=jnp.bfloat16),
            torch.from_numpy(data).to(torch.bfloat16))


def bits(t):
    return t.view(torch.int16).numpy().view(np.uint16)


@pytest.mark.parametrize("chunks", [1, 2, 3, 4, "rows"])
@pytest.mark.parametrize("n", [1, 3])
def test_plain_matches_pallas_bit_exact(cpu_jax, chunks, n):
    """8 rows per chunk, or ("rows") one row per chunk in 8 chunks."""
    from tpufd import health as ref

    rows, chunks = (8, 8) if chunks == "rows" else (8 * chunks, chunks)
    x_jax, x_torch = bf16_pair(rows, 1024, seed=10 * chunks + n)
    want = ref._dma_copy_fn(rows, 1024, chunks, True)(
        x_jax, cpu_jax.numpy.int32(n))
    got = dma_copy.dma_copy_plain(x_torch, n, chunks)
    np.testing.assert_array_equal(bits(got),
                                  np.asarray(want).view(np.uint16))
    # The wrapper takes the plain version for a CPU tensor, and only that.
    np.testing.assert_array_equal(bits(dma_copy.dma_copy(x_torch, n, chunks)),
                                  bits(got))


@pytest.mark.parametrize("rows, cols, chunks", [
    (12, 7, 3), (12, 7, 12), (24, 8, 2), (6, 9, 6)])
def test_plain_matches_pallas_at_ragged_shapes(cpu_jax, rows, cols, chunks):
    """The shapes of the kernel's edges on the card: rows of 7 and 9
    elements, whose chunks start off a 16-byte boundary, one row per
    chunk, and 16-byte rows."""
    from tpufd import health as ref

    x_jax, x_torch = bf16_pair(rows, cols, seed=rows * cols + chunks)
    want = ref._dma_copy_fn(rows, cols, chunks, True)(
        x_jax, cpu_jax.numpy.int32(2))
    np.testing.assert_array_equal(bits(dma_copy.dma_copy(x_torch, 2, chunks)),
                                  np.asarray(want).view(np.uint16))


def test_cpu_path_is_not_counted_as_a_launch():
    before = dma_copy.launches
    dma_copy.dma_copy(torch.zeros((4, 16), dtype=torch.bfloat16), 2, 2)
    assert dma_copy.launches == before


@pytest.mark.parametrize("fn", [dma_copy.dma_copy, dma_copy.dma_copy_plain])
def test_rows_not_divisible_by_chunks_raise(fn):
    with pytest.raises(ValueError, match="chunks"):
        fn(torch.zeros((5, 1024), dtype=torch.bfloat16), 1, 2)


@pytest.mark.parametrize("x, error", [
    (torch.zeros((4, 8), dtype=torch.float32), TypeError),
    (torch.zeros((2, 4, 8), dtype=torch.bfloat16), ValueError),
    (torch.zeros((8, 4), dtype=torch.bfloat16).t(), ValueError),
    (torch.zeros((0, 8), dtype=torch.bfloat16), ValueError),
], ids=["float32", "3-d", "non-contiguous", "empty"])
def test_wrapper_rejects_what_the_kernel_does_not_take(x, error):
    with pytest.raises(error):
        dma_copy.dma_copy(x, 1, 1)


def test_wrapper_rejects_n_below_one():
    with pytest.raises(ValueError, match="n must be"):
        dma_copy.dma_copy(torch.zeros((4, 8), dtype=torch.bfloat16), 0, 1)


def test_non_cpu_tensor_never_takes_the_plain_version():
    """Only a CPU tensor runs the plain version: a tensor elsewhere goes to
    the kernel or raises."""
    x = torch.empty((4, 8), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        dma_copy.dma_copy(x, 1, 1)


def test_cuda_request_raises_on_a_host_without_a_card():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        health.dma_copy_gbps(device="cuda", mib=1, iters=2)


def test_build_targets_hopper(tmp_path):
    cmd = _build.nvcc_command("dma_copy", tmp_path / "lib.so")
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert "-shared" in cmd and cmd[-1].endswith("csrc/dma_copy.cu")


def test_plan_keys_match_what_the_c_query_fills():
    """launch_plan() names tpufd_dma_copy_plan's plan[0..] in order: one
    key for each slot the C function writes, the bytes of a sweep last
    (chip_smoke.py's edge cases are cut from them)."""
    text = (_build.CSRC / "dma_copy.cu").read_text()
    slots = dict(re.findall(r"^  plan\[(\d+)\] = (.*);$", text, flags=re.M))
    assert sorted(map(int, slots)) == list(range(len(dma_copy.PLAN_KEYS)))
    assert dma_copy.PLAN_KEYS[-1] == "sweep_bytes"
    assert slots[str(len(slots) - 1)] == "kThreads * 16"


def _global_functions():
    text = (_build.CSRC / "dma_copy.cu").read_text()
    return re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)"
                      r"\s+)?(\w+)\s*\(", text)


def _cpu_counters():
    """A CPU call, on an input one element off its allocation's 16-byte
    alignment, changes neither counter, which no CPU call ever moves."""
    assert (dma_copy.launches, dma_copy.unaligned_launches) == (0, 0)
    flat = torch.arange(4 * 16 + 1, dtype=torch.float32).to(torch.bfloat16)
    got = dma_copy.dma_copy(flat[1:].view(4, 16), 3, 2)
    assert torch.equal(got.view(torch.int16),
                       flat[1:].view(4, 16).view(torch.int16))
    return dma_copy.launches, dma_copy.unaligned_launches


@pytest.mark.parametrize("what, got, want", [
    ("kernel name", _global_functions, lambda: [dma_copy_roofline_pct.KERNEL]),
    ("cpu counters", _cpu_counters, lambda: (0, 0)),
], ids=["kernel-name", "cpu-counters"])
def test_what_the_benchmark_and_the_probe_read(what, got, want):
    """The source's one __global__ function is the kernel the benchmark's
    dma_copy_roofline_pct finds by name; on the CPU, launches and
    unaligned_launches stay 0."""
    assert got() == want(), what


def test_library_is_keyed_on_the_source(tmp_path, monkeypatch):
    src = tmp_path / "dma_copy.cu"
    src.write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build.library_path("dma_copy")
    src.write_text("// two\n")
    assert _build.library_path("dma_copy") != first
    assert first.parent == _build.BUILD_DIR


def test_dma_copy_probe_runs_on_cpu():
    """The probe's plumbing (shape, salt, differential timer) end to end
    through the plain version; the number itself means nothing here."""
    assert health.dma_copy_gbps(device="cpu", mib=1, iters=2, chunks=2) > 0
    assert health._dma_copy_shape(256, 2) == (131072, 1024)
    assert health._dma_copy_shape(0, 4) == (4, 1024)
