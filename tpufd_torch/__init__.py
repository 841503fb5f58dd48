"""tpufd_torch: the PyTorch/CUDA port of the ``tpufd`` probe package.

The C++ daemon labels what a node *has*; this package measures what the
accelerator *does*, on an NVIDIA GPU:

  - tpufd_torch.health:    timed probes (bf16 matmul chain, HBM stream,
                           DMA-copy kernel) and the health label set
  - tpufd_torch.dma_copy:  the hand-written CUDA copy kernel, its plain
                           PyTorch version and its launch counter
  - tpufd_torch.perfmodel: bare measurement lines for --perf-exec
  - tpufd_torch.burnin:    the burn-in MLP block (forward)
  - tpufd_torch.journal:   the daemon's flight recorder, parsed and
                           printed (``python -m tpufd_torch journal``)

It imports torch, never jax, and nothing of ``tpufd``. Its entry points
run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
