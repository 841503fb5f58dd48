"""Entry hooks of the PyTorch port: the counterparts of
``__graft_entry__``.

entry() -> (fn, args): fn is the burn-in block (a BurninMLP, so fn(*args)
is its forward) at the reference's width, d_model 256 and d_ff 1024, and
args is (x,) with x of shape (4, 16, 256) in bf16; on the card unless
device="cpu" is asked for.

dryrun_multichip(n) -> n gloo ranks on the host run the full sharded
training step (forward, backward, SGD over a ('data', 'model') mesh of
every rank) for one step and assert a finite loss, then ring attention in
both modes over a ('context',) mesh of every rank, each checked against
full attention. It is hermetic: the ranks see no card (launch hides them
from CPU ranks) and each asserts that it never initialised CUDA, so a
card present, absent or broken cannot change the result. The ranks are
fresh processes, so it runs alike from any caller.
"""

import math

import torch

from tpufd_torch import burnin, launch
from tpufd_torch.health import resolve_device


def entry(device=None):
    device = resolve_device(device)
    model = burnin.init_params(torch.Generator().manual_seed(0),
                               d_model=256, d_ff=1024, device=device)
    x = torch.randn((4, 16, 256), generator=torch.Generator().manual_seed(1))
    return model, (x.to(device=device, dtype=torch.bfloat16),)


def _dryrun_rank():
    """One rank of the dry run; raises on any failed check."""
    result = burnin.sharded_acceptance("cpu", steps=1)
    if not math.isfinite(result["loss"]):
        raise RuntimeError(f"burn-in loss not finite: {result['loss']}")
    for mode, _, error in result["ring"]:
        if error is not None:
            raise RuntimeError(error)
    if [mode for mode, _, _ in result["ring"]] != ["bidirectional",
                                                   "causal"]:
        raise RuntimeError(f"ring attention did not run: {result['ring']}")
    if torch.cuda.is_initialized():
        raise RuntimeError("a dry-run rank initialised CUDA")
    return result


def dryrun_multichip(n_devices: int) -> None:
    launch.spawn_ranks(_dryrun_rank, n_devices, "cpu")
