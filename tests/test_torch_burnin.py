"""The burn-in block's forward and loss against tpufd.burnin, with the
JAX package's own weights carried across by params_from_jax."""

import numpy as np
import pytest
import torch

from tpufd_torch import burnin, graft_entry


def jax_params_and_input(jax, d_model, d_ff, dtype, seed):
    from tpufd import burnin as ref

    jnp = jax.numpy
    params = ref.init_params(jax.random.PRNGKey(seed), d_model=d_model,
                             d_ff=d_ff, dtype=dtype)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((4, 16, d_model), dtype=np.float32)
    y = rng.standard_normal((4, 16, d_model), dtype=np.float32)
    # gamma away from 1, so the scale is exercised.
    params["gamma"] = jnp.asarray(
        1 + 0.1 * rng.standard_normal(d_model, dtype=np.float32), dtype=dtype)
    return params, x, y


def as_numpy(params):
    return {k: np.asarray(v) for k, v in params.items()}


def test_forward_and_loss_float32_match_jax(cpu_jax):
    """float32 at a narrow width (d_model 64, d_ff 128): within 1e-5."""
    from tpufd import burnin as ref

    jnp = cpu_jax.numpy
    params, x, y = jax_params_and_input(cpu_jax, 64, 128, jnp.float32, 3)
    model = burnin.params_from_jax(as_numpy(params))
    assert model.w_in.dtype == torch.float32
    want = np.asarray(ref.forward(params, jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
        loss = float(burnin.loss_fn(model, torch.from_numpy(x),
                                    torch.from_numpy(y)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    want_loss = float(ref.loss_fn(params, jnp.asarray(x), jnp.asarray(y)))
    assert loss == pytest.approx(want_loss, rel=1e-5)


def test_forward_bf16_matches_jax_at_entry_width(cpu_jax):
    """bf16 at entry()'s shape (4, 16, 256), d_ff 1024: within 2e-2 (the
    frameworks round bf16 intermediates at different places; values reach
    a few units, where one bf16 ulp is 1.6e-2)."""
    from tpufd import burnin as ref

    jnp = cpu_jax.numpy
    params, x, _ = jax_params_and_input(cpu_jax, 256, 1024, jnp.bfloat16, 0)
    model = burnin.params_from_jax(as_numpy(params))
    assert model.w_in.dtype == torch.bfloat16
    x_jax = jnp.asarray(x, dtype=jnp.bfloat16)
    want = np.asarray(ref.forward(params, x_jax), dtype=np.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(x).to(torch.bfloat16))
    assert got.shape == (4, 16, 256) and got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2,
                               atol=2e-2)


def test_gelu_is_the_tanh_approximation(cpu_jax):
    import jax

    x = np.linspace(-4, 4, 101, dtype=np.float32)
    want = np.asarray(jax.nn.gelu(cpu_jax.numpy.asarray(x)))
    got = torch.nn.functional.gelu(torch.from_numpy(x), approximate="tanh")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_init_params_is_seeded_and_scaled():
    a = burnin.init_params(torch.Generator().manual_seed(5), 64, 256,
                           dtype=torch.float32)
    b = burnin.init_params(torch.Generator().manual_seed(5), 64, 256,
                           dtype=torch.float32)
    assert torch.equal(a.w_in, b.w_in) and torch.equal(a.w_out, b.w_out)
    assert a.w_in.shape == (64, 256) and a.w_out.shape == (256, 64)
    assert torch.equal(a.gamma, torch.ones(64))
    w_in, w_out = a.w_in.detach(), a.w_out.detach()
    assert float(w_in.std()) == pytest.approx(64 ** -0.5, rel=0.1)
    assert float(w_out.std()) == pytest.approx(256 ** -0.5, rel=0.1)


def test_entry_on_cpu_matches_reference_width():
    fn, args = graft_entry.entry(device="cpu")
    (x,) = args
    model = fn
    assert x.shape == (4, 16, 256) and x.dtype == torch.bfloat16
    assert model.w_in.shape == (256, 1024)
    with torch.no_grad():
        out = fn(*args)
    assert out.shape == (4, 16, 256) and torch.isfinite(out.float()).all()


def test_entry_without_a_card_raises_here():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.entry()
