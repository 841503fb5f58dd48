"""The matmul chain's fused step: its plain version against the chain-tail
on the product and against the reference's chain body
(tpufd.health._matmul_chain), the wrapper's checks, the rule that sends
a matrix to the kernel, and _matmul_chain's in-place contract over the
buffers the fused path alternates between, on this CPU-only host. The
CUDA kernel itself is checked on the card (test_torch_chain_step_card.py
and chip_smoke.py)."""

import re

import numpy as np
import pytest
import torch

from conftest import REPO
from tpufd_torch import _build, chain_step, chain_tail, health

SOURCE = REPO / "tpufd_torch" / "csrc" / "chain_step.cu"


def normal(shape, seed, scale=1.0):
    return np.random.default_rng(seed).standard_normal(
        shape, dtype=np.float32) * scale


def bf16(values):
    return torch.from_numpy(values).to(torch.bfloat16)


def bits(t):
    return t.view(torch.int16)


@pytest.mark.parametrize("width", [40, 37, 8])
def test_plain_is_the_tail_on_the_rounded_product(width):
    """chain_step_plain(x, out) is chain_tail_plain(x @ x, x) bit for bit,
    written into out, with x left as it was."""
    x = bf16(normal((width, width), width, 0.3))
    before = x.clone()
    out = torch.empty_like(x)
    got = chain_step.chain_step_plain(x, out)
    want = chain_tail.chain_tail_plain(x @ x, x.clone())
    assert got is out
    assert torch.equal(bits(out), bits(want))
    assert torch.equal(bits(x), bits(before))


@pytest.mark.parametrize("width", [40, 37])
def test_plain_matches_the_reference_chain_body_at_a_ragged_width(cpu_jax,
                                                                 width):
    """One plain step against one step of the reference's chain in bf16:
    rtol 2e-2, atol 1e-3, as the chain tests hold the port's chain (the
    reference on the CPU rounds after each elementwise op, the step
    once)."""
    from tpufd import health as ref

    jnp = cpu_jax.numpy
    x = normal((width, width), 20 + width, 0.1)
    want = np.asarray(ref._matmul_chain(jnp.asarray(x, dtype=jnp.bfloat16),
                                        jnp.int32(1)), dtype=np.float32)
    xt = bf16(x)
    got = chain_step.chain_step_plain(xt, torch.empty_like(xt))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2,
                               atol=1e-3)


def test_wrapper_runs_the_plain_version_on_cpu_and_never_counts():
    x = bf16(normal((16, 16), 7, 0.2))
    out = torch.empty_like(x)
    before = chain_step.launches
    assert chain_step.chain_step(x, out) is out
    want = chain_step.chain_step_plain(x, torch.empty_like(x))
    assert torch.equal(bits(out), bits(want))
    assert chain_step.launches == before


def _square(n=8, dtype=torch.bfloat16):
    return torch.zeros((n, n), dtype=dtype)


@pytest.mark.parametrize("x, out, error", [
    (torch.zeros((8, 8), dtype=torch.bfloat16, device="meta"),
     torch.zeros((8, 8), dtype=torch.bfloat16, device="meta"), ValueError),
    (_square(dtype=torch.int32), _square(dtype=torch.int32), TypeError),
    (_square(), _square(dtype=torch.float32), TypeError),
    (torch.zeros((8, 4), dtype=torch.bfloat16),
     torch.zeros((8, 4), dtype=torch.bfloat16), ValueError),
    (torch.zeros(8, dtype=torch.bfloat16),
     torch.zeros(8, dtype=torch.bfloat16), ValueError),
    (_square(0), _square(0), ValueError),
    (_square(), _square(16), ValueError),
    (torch.zeros((16, 8), dtype=torch.bfloat16)[::2], _square(), ValueError),
    (_square(), torch.zeros((16, 8), dtype=torch.bfloat16)[::2], ValueError),
], ids=["meta-device", "integer", "dtype-mismatch", "not-square", "1-d",
        "empty", "out-shape", "x-non-contiguous", "out-non-contiguous"])
@pytest.mark.parametrize("fn", [chain_step.chain_step,
                                chain_step.chain_step_plain])
def test_wrapper_rejects_what_the_kernel_does_not_take(fn, x, out, error):
    with pytest.raises(error):
        fn(x, out)


@pytest.mark.parametrize("fn", [chain_step.chain_step,
                                chain_step.chain_step_plain])
def test_wrapper_rejects_out_that_is_or_overlaps_x(fn):
    """The kernel reads x while it writes out: out may not be x, nor share
    any of its bytes."""
    x = _square()
    with pytest.raises(ValueError, match="another buffer"):
        fn(x, x)
    flat = torch.zeros(8 * 8 + 8, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="another buffer"):
        fn(flat[:64].view(8, 8), flat[8:].view(8, 8))
    apart = torch.zeros(2 * 64, dtype=torch.bfloat16)
    fn(apart[:64].view(8, 8), apart[64:].view(8, 8))  # adjacent is fine


@pytest.mark.parametrize("kwargs, takes", [
    ({}, True),
    ({"shape": (1000, 1000)}, True),
    ({"shape": (8, 8)}, True),
    ({"device_type": "cpu"}, False),
    ({"device_type": "meta"}, False),
    ({"dtype": torch.float32}, False),
    ({"dtype": torch.float16}, False),
    ({"shape": (4096, 2048)}, False),
    ({"shape": (1001, 1001)}, False),
    ({"shape": (4, 4)}, False),
    ({"shape": (0, 0)}, False),
    ({"shape": (4096,)}, False),
    ({"shape": (2, 8, 8)}, False),
    ({"contiguous": False}, False),
    ({"address": 0x7f0000000008}, False),
    ({"address": 0x7f0000000010}, True),
], ids=["probe", "ragged-1000", "smallest", "cpu", "meta", "float32",
        "float16", "not-square", "not-multiple-of-8", "below-8", "empty",
        "1-d", "3-d", "non-contiguous", "8-byte-aligned", "16-byte-aligned"])
def test_which_matrices_take_the_fused_step(kwargs, takes):
    """The dispatch rule, as a pure function of what the code can observe:
    a CUDA bf16 square contiguous matrix, its size a positive multiple of
    8, 16-byte aligned. Every card caller runs 4096."""
    props = {"device_type": "cuda", "dtype": torch.bfloat16,
             "shape": (4096, 4096), "contiguous": True,
             "address": 0x7f0000000000, **kwargs}
    assert chain_step.fused_step_fits(**props) is takes


def test_cpu_matrices_never_take_the_fused_step():
    assert not chain_step.takes_fused_step(_square(64))
    sizes = health.probe_sizes(torch.device("cpu"))
    assert not chain_step.takes_fused_step(_square(sizes[0]))


def _fused_path(monkeypatch):
    """_matmul_chain's fused path on the CPU: the dispatch says yes and
    chain_step runs its plain version. Returns the (x, out) pointers of
    each step."""
    calls = []

    def step(x, out):
        calls.append((x.data_ptr(), out.data_ptr()))
        return chain_step.chain_step_plain(x, out)

    monkeypatch.setattr(chain_step, "takes_fused_step", lambda x: True)
    monkeypatch.setattr(chain_step, "chain_step", step)
    return calls


@pytest.mark.parametrize("n", [1, 2, 3, 8])
def test_matmul_chain_keeps_its_in_place_contract(monkeypatch, n):
    """Through the fused path, n steps alternate between x and one second
    buffer, the result ends in x (one copy back after an odd n), x is
    returned, and every bit equals the in-place path's."""
    x0 = bf16(normal((24, 24), 30 + n, 0.2))
    want = health._matmul_chain(x0.clone(), n)  # the in-place path
    calls = _fused_path(monkeypatch)
    x = x0.clone()
    got = health._matmul_chain(x, n)
    assert got is x
    assert torch.equal(bits(x), bits(want))
    assert len(calls) == n
    other = calls[0][1]
    assert other != x.data_ptr()
    assert calls == [(x.data_ptr(), other) if i % 2 == 0 else
                     (other, x.data_ptr()) for i in range(n)]


def test_matmul_chain_with_no_steps_leaves_x(monkeypatch):
    calls = _fused_path(monkeypatch)
    x = bf16(normal((16, 16), 40, 0.2))
    before = x.clone()
    assert health._matmul_chain(x, 0) is x
    assert calls == [] and torch.equal(bits(x), bits(before))


def test_cpu_chain_stays_on_the_tail(monkeypatch):
    """On the CPU each step is still one product and one chain_tail call
    on x, in place: the fused path is never taken."""
    tails = []
    real = chain_tail.chain_tail

    def spy(p, acc):
        tails.append(acc.data_ptr())
        return real(p, acc)

    def no_step(x, out):
        raise AssertionError("chain_step ran on the CPU")

    monkeypatch.setattr(chain_tail, "chain_tail", spy)
    monkeypatch.setattr(chain_step, "chain_step", no_step)
    x = bf16(normal((32, 32), 41, 0.1))
    assert health._matmul_chain(x, 2) is x
    assert tails == [x.data_ptr()] * 2


def test_build_lists_and_targets_the_kernel(tmp_path):
    assert "chain_step" in _build.KERNELS
    cmd = _build.nvcc_command("chain_step", tmp_path / "lib.so")
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert "-shared" in cmd and cmd[-1].endswith("csrc/chain_step.cu")


def test_kernel_keeps_the_tails_arithmetic():
    """The kernel's source and flags: the accurate tanhf, p rounded to
    bf16 before the tail and one round-to-nearest-even rounding after it;
    no approximate tanh, fast math, TF32 or fp8 anywhere."""
    text = SOURCE.read_text()
    code = re.sub(r"//[^\n]*", "", text)
    flags = " ".join(_build.NVCC_FLAGS)
    for banned in ("tanh.approx", "__tanhf", "fast", "tf32", "e4m3", "e5m2",
                   "__expf", "__fdividef"):
        assert banned not in code.lower(), banned
        assert banned not in flags.lower(), banned
    assert "tanhf(" in code
    assert code.count("__floats2bfloat162_rn(") == 1  # pack_bf16, the one
    assert "bf16.bf16" in code and "f32.bf16.bf16" in code  # f32 accumulate
