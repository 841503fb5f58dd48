"""The burn-in block's forward, loss and train step against tpufd.burnin,
with the JAX package's own weights carried across by params_from_jax and
back by params_to_numpy, and run_burnin's telemetry."""

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


# ---- the train step ---------------------------------------------------------

def train_both(jax, d_model, d_ff, dtype, seed, steps, lr=None):
    """`steps` train steps of tpufd.burnin's step on a one-device CPU mesh
    and of the port's, from the same parameters and numpy-seeded (x, y)
    of shape (4, 8, d_model). lr None is each package's default. Returns
    ([(ref loss, port loss)] per step, ref params before and after, port
    model)."""
    from tpufd import burnin as ref, mesh as ref_mesh

    jnp = jax.numpy
    params, _, _ = jax_params_and_input(jax, d_model, d_ff, dtype, seed)
    rng = np.random.default_rng(seed + 100)
    x = rng.standard_normal((4, 8, d_model), dtype=np.float32)
    y = 0.5 * rng.standard_normal((4, 8, d_model), dtype=np.float32)
    init = as_numpy(params)
    model = burnin.params_from_jax(init)
    mesh = ref_mesh.data_model_mesh(jax.devices("cpu")[:1])
    ref_args = (mesh,) if lr is None else (mesh, lr)
    ref_step = ref.make_train_step(*ref_args)
    step = burnin.make_train_step(model) if lr is None else (
        burnin.make_train_step(model, lr))
    torch_dtype = model.w_in.dtype
    x_t = torch.from_numpy(x).to(torch_dtype)
    y_t = torch.from_numpy(y).to(torch_dtype)
    x_j, y_j = jnp.asarray(x, dtype=dtype), jnp.asarray(y, dtype=dtype)
    losses = []
    for _ in range(steps):
        params, want = ref_step(params, x_j, y_j)
        losses.append((float(want), float(step(x_t, y_t))))
    return losses, init, as_numpy(params), model


def test_train_step_float32_matches_jax(cpu_jax):
    """float32 at d_model 64 and d_ff 128, lr 0.1 so the update shows:
    the loss of each of 2 steps and every parameter after them within
    rtol 1e-5."""
    losses, init, want, model = train_both(
        cpu_jax, 64, 128, cpu_jax.numpy.float32, 5, 2, lr=0.1)
    for want_loss, got_loss in losses:
        assert got_loss == pytest.approx(want_loss, rel=1e-5)
    assert losses[1][1] < losses[0][1]  # the step descends
    got = burnin.params_to_numpy(model)
    for name in ("w_in", "w_out", "gamma"):
        np.testing.assert_allclose(got[name], want[name], rtol=1e-5,
                                   atol=1e-7, err_msg=name)
    assert not np.allclose(got["w_in"], init["w_in"], rtol=1e-4,
                           atol=0)  # the update is visible


def test_train_step_bf16_matches_jax_at_full_width(cpu_jax):
    """bf16 at d_model 256 and d_ff 1024, the default lr: the loss within
    rel 2e-2; every parameter within one bf16 ulp of its value (rtol
    8e-3), beside half the tensor's largest update (atol). A weight within
    a few updates of zero is mostly update, and the two frameworks round
    the gradient's bf16 intermediates at other places."""
    losses, init, want, model = train_both(cpu_jax, 256, 1024,
                                           cpu_jax.numpy.bfloat16, 6, 2)
    assert model.w_in.dtype == torch.bfloat16
    for want_loss, got_loss in losses:
        assert got_loss == pytest.approx(want_loss, rel=2e-2)
    got = burnin.params_to_numpy(model)
    for name in ("w_in", "w_out", "gamma"):
        want_f = want[name].astype(np.float32)
        update = np.abs(want_f - init[name].astype(np.float32)).max()
        np.testing.assert_allclose(got[name], want_f, rtol=8e-3,
                                   atol=0.5 * update, err_msg=name)


def test_train_step_returns_the_loss_before_the_update():
    model = burnin.init_params(torch.Generator().manual_seed(2), 16, 32,
                               dtype=torch.float32)
    x = torch.randn((2, 4, 16), generator=torch.Generator().manual_seed(3))
    y = torch.zeros_like(x)
    with torch.no_grad():
        before = float(burnin.loss_fn(model, x, y))
    loss = burnin.make_train_step(model, 0.1)(x, y)
    assert not loss.requires_grad
    assert float(loss) == before
    with torch.no_grad():
        assert float(burnin.loss_fn(model, x, y)) < before


def test_params_round_trip_through_numpy():
    model = burnin.init_params(torch.Generator().manual_seed(4), 32, 64)
    back = burnin.params_from_jax(burnin.params_to_numpy(model))
    assert back.w_in.dtype == torch.float32  # numpy carries float32
    for name in ("w_in", "w_out", "gamma"):
        assert torch.equal(getattr(back, name),
                           getattr(model, name).detach().float())


def test_run_burnin_on_cpu_records_the_reference_telemetry():
    from tpufd import metrics as ref_metrics
    from tpufd_torch import metrics

    reg = metrics.default_registry()
    loss = burnin.run_burnin(device="cpu", steps=3)
    assert np.isfinite(loss) and loss > 0
    text = reg.render()
    ref_metrics.validate_exposition(text)
    for phase, count in (("compile", 1), ("steady", 2)):
        assert ref_metrics.sample_value(
            text, "tpufd_burnin_step_duration_seconds_count",
            labels={"phase": phase}) >= count
    assert ref_metrics.sample_value(text, "tpufd_burnin_final_loss") == (
        pytest.approx(loss))


def test_run_burnin_shapes_follow_the_one_device_mesh(monkeypatch):
    """batch 4 and seq 8 on a (1, 1) mesh, as the reference on one
    device; bf16 inputs, zero targets."""
    seen = []
    real = burnin.make_train_step

    def spy(model, learning_rate=1e-3):
        step = real(model, learning_rate)

        def wrapped(x, y):
            seen.append((tuple(x.shape), x.dtype, bool((y == 0).all())))
            return step(x, y)
        return wrapped

    monkeypatch.setattr(burnin, "make_train_step", spy)
    burnin.run_burnin(device="cpu", d_model=32, d_ff=64, steps=1)
    assert seen == [((4, 8, 32), torch.bfloat16, True)]


def test_run_burnin_refuses_model_parallelism_on_one_device():
    with pytest.raises(ValueError,
                       match="1 devices not divisible by model_parallelism=2"):
        burnin.run_burnin(device="cpu", model_parallelism=2)


def test_run_burnin_without_a_card_raises_here():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        burnin.run_burnin()
