"""Single-card forward step of the burn-in model: the port's counterpart
of ``__graft_entry__.entry``.

entry() -> (fn, args): fn is the burn-in block (a BurninMLP, so fn(*args)
is its forward) at the reference's width, d_model 256 and d_ff 1024, and
args is (x,) with x of shape (4, 16, 256) in bf16; on the card unless
device="cpu" is asked for.
"""

import torch

from tpufd_torch import burnin
from tpufd_torch.health import resolve_device


def entry(device=None):
    device = resolve_device(device)
    model = burnin.init_params(torch.Generator().manual_seed(0),
                               d_model=256, d_ff=1024, device=device)
    x = torch.randn((4, 16, 256), generator=torch.Generator().manual_seed(1))
    return model, (x.to(device=device, dtype=torch.bfloat16),)
