"""portbench: the benchmark of the PyTorch and CUDA port, tpufd_torch.

Each label cell reads one label of the port's health exec
(`tpufd_torch.health`) again and again on one card, as the daemon's exec
reads it, and measures what a reading costs and what it publishes; the
exec cell runs the whole exec, one fresh process a reading (`execs.py`).
`run.py` is the command; `harness.py` finds everything a cell needs by
name.
"""
