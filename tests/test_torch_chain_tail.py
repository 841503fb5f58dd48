"""The matmul chain's fused tail: its plain version against the
reference's chain body (tpufd.health._matmul_chain) and a numpy
computation of the same function, and the wrapper's checks on this
CPU-only host. The CUDA kernel itself is checked on the card by
chip_smoke.py."""

import numpy as np
import pytest
import torch

from tpufd_torch import _build, chain_tail, health


def normal(shape, seed, scale=1.0):
    return np.random.default_rng(seed).standard_normal(
        shape, dtype=np.float32) * scale


def bf16(values):
    return torch.from_numpy(values).to(torch.bfloat16)


# Each float32 tail against the float64 one, in absolute terms (|tail| < 4
# here, where one float32 ulp is 2**-22). PyTorch's float32 tanh and two
# roundings: within 2 ulps. XLA's CPU tanh is its own polynomial
# approximation, and on some hosts it has read 3.9e-5 from PyTorch's on
# the tail: within 1e-4.
PORT_TAIL_BOUND = 2 * 2.0 ** -22
JAX_TAIL_BOUND = 1e-4


def test_plain_float32_matches_jax_chain_body(cpu_jax):
    """tanh(p) * 0.5 + acc * 0.5 in float32, as the reference writes it:
    JAX's tail and the port's each against the float64 tail within its
    own bound, and the two against each other within the sum."""
    jnp = cpu_jax.numpy
    p, a = normal((64, 48), 1, 2.0), normal((64, 48), 2)
    exact = 0.5 * (np.tanh(p.astype(np.float64)) + a.astype(np.float64))
    assert np.abs(exact).max() < 4
    want = np.asarray(jnp.tanh(jnp.asarray(p)) * 0.5 + jnp.asarray(a) * 0.5)
    got = chain_tail.chain_tail_plain(torch.from_numpy(p),
                                      torch.from_numpy(a.copy())).numpy()
    assert want.dtype == got.dtype == np.float32
    np.testing.assert_allclose(got, exact, rtol=0, atol=PORT_TAIL_BOUND)
    np.testing.assert_allclose(want, exact, rtol=0, atol=JAX_TAIL_BOUND)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=PORT_TAIL_BOUND + JAX_TAIL_BOUND)


@pytest.mark.parametrize("shape", [(4096,), (37, 29), (8, 8)])
def test_plain_bf16_rounds_once(shape):
    """bf16: the tail is computed in float32 and rounded once, so every
    element lies within half a bf16 ulp (2**-8 of its magnitude) of the
    float64 tail, beside float32's own error."""
    p, a = bf16(normal(shape, 3, 3.0)), bf16(normal(shape, 4))
    exact = 0.5 * (np.tanh(p.double().numpy()) + a.double().numpy())
    got = chain_tail.chain_tail_plain(p, a.clone())
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.double().numpy(), exact,
                               rtol=2 ** -8 + 2 ** -20, atol=0)


def test_fused_tail_is_at_most_the_three_pass_tail_in_error():
    """Against float64, the fused tail (one rounding) is never further off
    than the three eager passes it replaced (three roundings)."""
    p, a = bf16(normal((256, 256), 5, 3.0)), bf16(normal((256, 256), 6))
    exact = 0.5 * (np.tanh(p.double().numpy()) + a.double().numpy())
    fused = chain_tail.chain_tail(p, a.clone()).double().numpy()
    three = torch.tanh(p).add_(a).mul_(0.5).double().numpy()
    assert np.abs(fused - exact).max() <= np.abs(three - exact).max()


def test_wrapper_runs_the_plain_version_in_place_on_cpu():
    p, a = bf16(normal((16, 8), 7)), bf16(normal((16, 8), 8))
    want = chain_tail.chain_tail_plain(p, a.clone())
    before = chain_tail.launches
    out = chain_tail.chain_tail(p, a)
    assert out is a and torch.equal(a.view(torch.int16),
                                    want.view(torch.int16))
    assert chain_tail.launches == before  # the plain version never counts


@pytest.mark.parametrize("p, acc, error", [
    (torch.zeros(8), torch.zeros(8, dtype=torch.bfloat16), TypeError),
    (torch.zeros(8, dtype=torch.int32), torch.zeros(8, dtype=torch.int32),
     TypeError),
    (torch.zeros(8, dtype=torch.bfloat16),
     torch.zeros(9, dtype=torch.bfloat16), ValueError),
    (torch.zeros(0, dtype=torch.bfloat16),
     torch.zeros(0, dtype=torch.bfloat16), ValueError),
    (torch.zeros((4, 8), dtype=torch.bfloat16).t(),
     torch.zeros((8, 4), dtype=torch.bfloat16), ValueError),
    (torch.zeros((8, 4), dtype=torch.bfloat16),
     torch.zeros((4, 8), dtype=torch.bfloat16).t(), ValueError),
], ids=["dtype-mismatch", "integer", "shape", "empty", "p-non-contiguous",
        "acc-non-contiguous"])
@pytest.mark.parametrize("fn", [chain_tail.chain_tail,
                                chain_tail.chain_tail_plain])
def test_wrapper_rejects_what_the_kernel_does_not_take(fn, p, acc, error):
    with pytest.raises(error):
        fn(p, acc)


def test_non_cpu_tensor_never_takes_the_plain_version():
    """Only CPU tensors run the plain version: tensors elsewhere go to the
    kernel or raise."""
    x = torch.empty((4, 8), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        chain_tail.chain_tail(x, torch.empty_like(x))


def test_build_lists_and_targets_the_kernel(tmp_path):
    assert "chain_tail" in _build.KERNELS
    cmd = _build.nvcc_command("chain_tail", tmp_path / "lib.so")
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert "-shared" in cmd and cmd[-1].endswith("csrc/chain_tail.cu")


def test_matmul_chain_runs_in_place_through_the_tail(monkeypatch):
    """Each chain step is one product and one chain_tail call on acc."""
    calls = []
    real = chain_tail.chain_tail

    def spy(p, acc):
        calls.append(acc.data_ptr())
        return real(p, acc)

    monkeypatch.setattr(chain_tail, "chain_tail", spy)
    x = bf16(normal((32, 32), 9, 0.1))
    assert health._matmul_chain(x, 3) is x
    assert calls == [x.data_ptr()] * 3


@pytest.mark.parametrize("n", [1, 4])
def test_matmul_chain_bf16_matches_jax_at_a_ragged_width(cpu_jax, n):
    """The bf16 chain against the reference at width 40: rtol 2e-2, atol
    1e-3, as at width 64 (the reference on the CPU rounds after each
    elementwise op, the fused tail once)."""
    from tpufd import health as ref

    jnp = cpu_jax.numpy
    x = normal((40, 40), 10 + n, 0.1)
    want = np.asarray(ref._matmul_chain(jnp.asarray(x, dtype=jnp.bfloat16),
                                        jnp.int32(n)), dtype=np.float32)
    got = health._matmul_chain(bf16(x), n)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2,
                               atol=1e-3)
