"""The burn-in MLP block, forward half: the PyTorch port of the model in
tpufd/burnin.py.

A two-layer MLP block with a scale: x * gamma -> @ w_in -> gelu ->
@ w_out -> + x, at d_model 256 and d_ff 1024 by default. The parameters
keep the reference's names and layouts (w_in is (d_model, d_ff), w_out
is (d_ff, d_model)), so ``params_from_jax`` carries the JAX package's
weights across unchanged. The sharded train step and ring attention are
not ported yet.
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

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
