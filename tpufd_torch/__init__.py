"""tpufd_torch: the PyTorch/CUDA port of the ``tpufd`` probe package.

The C++ daemon labels what a node *has*; this package measures what the
accelerator *does*, on an NVIDIA GPU:

  - tpufd_torch.health:    timed probes (bf16 matmul chain, HBM stream,
                           DMA-copy kernel) and the health label set
  - tpufd_torch.dma_copy:  the hand-written CUDA copy kernel, its plain
                           PyTorch version and its launch counter
  - tpufd_torch.perfmodel: bare measurement lines for --perf-exec, and
                           the daemon's perf class model
  - tpufd_torch.burnin:    the burn-in MLP block (forward)
  - tpufd_torch.journal:   the daemon's flight recorder, parsed and
                           printed (``python -m tpufd_torch journal``),
                           and its event helpers
  - tpufd_torch.metrics:   the Prometheus textfile, written and read
  - tpufd_torch.healthsm:  the daemon's health state machine
  - tpufd_torch.plugin:    the probe-plugin contract

The fleet-side twins judge what the daemon's cluster modes make of a
node's labels. They are framework-free copies of ``tpufd``'s, and this
package imports none of them, so that the health and perf execs do not
pay for them at start-up:

  - tpufd_torch.sink:        the NodeFeature CR sink's write flows and
                             cadence desync
  - tpufd_torch.agg:         the cluster-inventory aggregator's rollups
  - tpufd_torch.trace:       the label-propagation trace (/debug/trace)
  - tpufd_torch.placement:   the placement service's query index
  - tpufd_torch.remedy:      the remediation controller's engine
  - tpufd_torch.slicecoord:  slice coherence (ids, leases, verdicts)
  - tpufd_torch.cluster:     the label-driven toy scheduler and the
                             failure-schedule grammar
  - tpufd_torch.fakes:       a fake apiserver and metadata server, and
                             the virtual-clock fleet simulation

It imports torch, never jax, and nothing of ``tpufd``. Its entry points
run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
