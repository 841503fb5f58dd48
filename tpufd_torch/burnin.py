"""The burn-in MLP block and its train step on one card: the PyTorch port
of the model and the single-device half of tpufd/burnin.py.

A two-layer MLP block with a scale: x * gamma -> @ w_in -> gelu ->
@ w_out -> + x, at d_model 256 and d_ff 1024 by default. The parameters
keep the reference's names and layouts (w_in is (d_model, d_ff), w_out
is (d_ff, d_model)), so ``params_from_jax`` and ``params_to_numpy`` carry
weights across to and from the JAX package unchanged.

``make_train_step`` is the reference's step (forward, backward, SGD) on
one device and ``run_burnin`` its loop with the reference's telemetry.
The sharded step over a (data, model) mesh and ring attention are not
ported yet: they come with the multi-card slice.
"""

import time

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpufd_torch import mesh as mesh_lib
from tpufd_torch import metrics
from tpufd_torch.health import resolve_device

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           "float32": torch.float32}


class BurninMLP(nn.Module):
    def __init__(self, d_model=256, d_ff=1024, dtype=torch.bfloat16,
                 device=None):
        super().__init__()
        self.w_in = nn.Parameter(
            torch.empty(d_model, d_ff, dtype=dtype, device=device))
        self.w_out = nn.Parameter(
            torch.empty(d_ff, d_model, dtype=dtype, device=device))
        self.gamma = nn.Parameter(
            torch.ones(d_model, dtype=dtype, device=device))

    def forward(self, x):
        """x: [batch, seq, d_model]."""
        # The reference's "layernorm" is this scale alone; kept as written.
        h = x * self.gamma
        # jax.nn.gelu defaults to the tanh approximation.
        h = F.gelu(h @ self.w_in, approximate="tanh")
        return x + h @ self.w_out


def init_params(generator, d_model=256, d_ff=1024, dtype=torch.bfloat16,
                device=None):
    """A BurninMLP with normal weights scaled by 1/sqrt(fan-in), drawn in
    float32 on the host from `generator` (a CPU torch.Generator), so the
    same seed gives the same weights on every device."""
    model = BurninMLP(d_model, d_ff, dtype=dtype, device=device)
    with torch.no_grad():
        model.w_in.copy_(torch.randn(d_model, d_ff, generator=generator)
                         / d_model ** 0.5)
        model.w_out.copy_(torch.randn(d_ff, d_model, generator=generator)
                          / d_ff ** 0.5)
    return model


def params_from_jax(np_params, device=None):
    """A BurninMLP holding the JAX package's {"w_in", "w_out", "gamma"}
    parameters, given as numpy arrays (bfloat16 ones included), in their
    own dtype."""
    w_in = np.asarray(np_params["w_in"])
    dtype = _DTYPES[w_in.dtype.name]
    d_model, d_ff = w_in.shape
    model = BurninMLP(d_model, d_ff, dtype=dtype, device=device)
    with torch.no_grad():
        for name in ("w_in", "w_out", "gamma"):
            value = np.array(np_params[name], dtype=np.float32)
            getattr(model, name).copy_(torch.from_numpy(value))
    return model


def loss_fn(model, x, y):
    pred = model(x)
    return torch.mean((pred.float() - y.float()) ** 2)


def params_to_numpy(model):
    """The model's {"w_in", "w_out", "gamma"} as float32 numpy arrays on
    the host, the reverse of params_from_jax."""
    return {name: getattr(model, name).detach().float().cpu().numpy()
            for name in ("w_in", "w_out", "gamma")}


def make_train_step(model, learning_rate=1e-3):
    """Returns step(x, y) -> loss: the reference's train step (forward,
    backward and an SGD update) on one device. The loss is the one at the
    parameters from before the update, as jax.value_and_grad gives it.
    Each parameter is updated in place as (p - lr * g) in float32, cast
    back to its own dtype, as the reference updates its pytree."""
    params = [model.w_in, model.w_out, model.gamma]

    def step(x, y):
        loss = loss_fn(model, x, y)
        grads = torch.autograd.grad(loss, params)
        with torch.no_grad():
            for p, g in zip(params, grads):
                p.copy_(p.float() - learning_rate * g.float())
        return loss.detach()

    return step


def run_burnin(device=None, batch=None, seq=None, d_model=256, d_ff=1024,
               steps=2, model_parallelism=None):
    """Runs the train step `steps` times on one device (the CUDA card
    unless device="cpu"; raises without a card). Shapes default as in the
    reference on a (data, model) = (1, 1) mesh: batch 4, seq 8. Records
    tpufd_burnin_step_duration_seconds (phase=compile for step 0, which
    carries eager PyTorch's first-use costs, steady for the rest; dispatch
    time, only the final loss is fetched) and tpufd_burnin_final_loss.
    Returns the final loss (float)."""
    device = resolve_device(device)
    data_n, model_n = mesh_lib.data_model_shape(1, model_parallelism)
    if batch is None:
        batch = 4 * data_n
    if seq is None:
        seq = 8 * model_n
    model = init_params(torch.Generator().manual_seed(0), d_model=d_model,
                        d_ff=d_ff, device=device)
    x = torch.randn((batch, seq, d_model),
                    generator=torch.Generator().manual_seed(0))
    x = x.to(device=device, dtype=torch.bfloat16)
    y = torch.zeros((batch, seq, d_model), dtype=torch.bfloat16,
                    device=device)

    reg = metrics.default_registry()
    step = make_train_step(model)
    loss = None
    for i in range(steps):
        step_t0 = time.perf_counter()
        loss = step(x, y)
        reg.histogram(
            "tpufd_burnin_step_duration_seconds",
            "Dispatch wall time per burn-in train step (phase=compile "
            "is step 0, carrying first-use costs).",
            labels={"phase": "compile" if i == 0 else "steady"}).observe(
                time.perf_counter() - step_t0)
    loss = float(loss)
    reg.gauge("tpufd_burnin_final_loss",
              "Final loss of the burn-in train loop.").set(loss)
    return loss
