"""The multi-card `burnin` command when a ring mode fails for a reason
other than divergence, as `python -m tpufd burnin` reports it
(tpufd/__main__.py:68-78): the loss line first, then
`<mode> ring attention FAILED: <error>`, and exit 1.

Two gloo ranks on the host stand in for two cards: the command's spawns
are redirected to the host, and rank 1's ring raises a RuntimeError that
is not divergence, either after the mode's exchange (every collective
done: the ranks agree on the failure and go on to the next mode) or
before it (rank 0 is left waiting in the exchange: the call fails and
every mode is reported failed). The rank function lives at module level
and this module imports no JAX, since every rank imports it."""

import multiprocessing
import re
import time

import pytest
import torch
import torch.distributed as dist

from tpufd_torch import __main__ as cli
from tpufd_torch import burnin, health, launch

INJECTED = "injected: NCCL error 6, remote process exited"
SPAWN_TIMEOUT = 120
OK_LINE = (r"(bidirectional|causal) ring attention over context=2: max abs "
           r"err \S+ vs full attention \(ok\)")


def ring_with_a_fault(mode, before_exchange, agree_timeout_s, device_type):
    """burnin.ring_acceptance on this rank, rank 1's `mode` raising a
    RuntimeError before or after its exchange."""
    burnin.RING_AGREE_TIMEOUT_S = agree_timeout_s
    real = burnin.run_ring_attention_burnin

    def faulty(mesh, causal=False, **kwargs):
        failing = ("causal" if causal else "bidirectional") == mode
        if failing and before_exchange:
            raise RuntimeError(INJECTED)
        err = real(mesh, causal=causal, **kwargs)
        if failing:
            raise RuntimeError(INJECTED)
        return err

    if dist.get_rank() == 1:
        burnin.run_ring_attention_burnin = faulty
    return burnin.ring_acceptance(device_type)


def host_spawn(fault):
    """launch.spawn_ranks as the command calls it for two cards, run on
    two gloo ranks instead, with `fault` injected into the ring call."""
    real = launch.spawn_ranks

    def spawn(fn, world, device_type, args=(), **kwargs):
        assert (world, device_type, args[0]) == (2, "cuda", "cuda")
        args = ("cpu", *args[1:])
        if fn is burnin.ring_acceptance:
            fn, args = ring_with_a_fault, (*fault, *args)
        return real(fn, world, "cpu", args=args, timeout=SPAWN_TIMEOUT)

    return spawn


@pytest.mark.parametrize("mode, before_exchange, agree_timeout_s", [
    ("bidirectional", False, burnin.RING_AGREE_TIMEOUT_S),
    ("causal", True, 3),
])
def test_ring_fault_prints_the_loss_then_failed(monkeypatch, capsys, mode,
                                                before_exchange,
                                                agree_timeout_s):
    monkeypatch.setattr(health, "resolve_device",
                        lambda device: torch.device("cuda", 0))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(launch, "spawn_ranks", host_spawn(
        (mode, before_exchange, agree_timeout_s)))
    t0 = time.monotonic()
    rc = cli.main(["burnin", "--steps", "1"])
    elapsed = time.monotonic() - t0
    out, err = capsys.readouterr()
    lines = out.splitlines()
    assert rc == 1
    assert lines[:2] == ["devices: 2 x NVIDIA H100 80GB HBM3",
                         "mesh: data=1 model=2"]
    assert re.fullmatch(r"final loss after 1 steps: \d+\.\d{6} \(ok\)",
                        lines[2])
    if before_exchange:
        # Rank 0 never leaves the exchange; rank 1 gives up waiting for
        # it, fails, and the launcher ends the call: no mode was reported.
        summary = f"rank 1 of 2 failed: RuntimeError: {INJECTED}"
        assert lines[3:] == [f"bidirectional ring attention FAILED: "
                             f"{summary}",
                             f"causal ring attention FAILED: {summary}"]
        assert "Traceback" in err and INJECTED in err
    else:
        assert lines[3] == (f"bidirectional ring attention FAILED: rank 1 "
                            f"of 2: {INJECTED}")
        assert re.fullmatch(OK_LINE, lines[4]) and lines[4].startswith(
            "causal")
        assert len(lines) == 5
    assert elapsed < SPAWN_TIMEOUT / 2
    assert multiprocessing.active_children() == []
