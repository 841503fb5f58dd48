"""portbench: the benchmark of the PyTorch and CUDA port, tpufd_torch.

Each cell reads one label of the port's health exec (`tpufd_torch.health`)
again and again on one card, as the daemon's exec reads it, and measures
what a reading costs and what it publishes. `run.py` is the command;
`harness.py` finds everything a cell needs by name.
"""
