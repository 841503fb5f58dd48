"""Several ranks, one process each: what JAX's single controller gives the
reference for free.

``spawn_ranks(fn, world, device_type, args)`` starts `world` processes
with the spawn start method (the caller may already hold a CUDA context,
which a forked child must not inherit), joins them into one
``torch.distributed`` process group and runs ``fn(*args)`` in each:

  - ``device_type="cuda"``: NCCL, rank r pinned to ``cuda:cards[r]``
    (``cuda:r`` by default). Never gloo, never the host.
  - ``device_type="cpu"``: gloo, with every card hidden from the ranks,
    so a CPU run cannot initialise CUDA.

Rendezvous goes through a ``FileStore`` in a fresh temporary directory:
no TCP port to pick or race for. Rank 0's return value comes back to the
caller; a rank's exception is re-raised here with that rank's traceback,
and a rank that neither finishes nor fails within `timeout` seconds is a
``TimeoutError``. Every rank process is gone when the call returns.

`fn` and `args` are pickled: `fn` must be a module-level function.
"""

import datetime
import os
import pickle
import queue as queue_lib
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# A rank that exited without a result is reported after this grace, which
# covers a result still in the pipe when the exit was seen.
_DEAD_RANK_GRACE_S = 2.0


def _rank_main(rank, world, device_type, card, store_path, timeout, fn,
               args, results):
    """One rank: join the group, run fn, send (rank, ok, value) pickled."""
    try:
        if device_type == "cuda":
            torch.cuda.set_device(card)
            options = {"backend": "nccl",
                       "device_id": torch.device("cuda", card)}
        elif device_type == "cpu":
            os.environ["CUDA_VISIBLE_DEVICES"] = ""
            # The ranks share the host's cores rather than each taking
            # all of them.
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
            options = {"backend": "gloo"}
        else:
            raise ValueError(f"ranks run on 'cuda' or 'cpu', not "
                             f"{device_type!r}")
        dist.init_process_group(
            store=dist.FileStore(store_path, world), rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=timeout),
            **options)
        value = fn(*args)
        payload = pickle.dumps((rank, True, value if rank == 0 else None))
    except Exception:  # noqa: BLE001 — re-raised in the parent
        payload = pickle.dumps((rank, False, traceback.format_exc()))
    results.put(payload)
    results.close()
    results.join_thread()
    if pickle.loads(payload)[1]:
        dist.destroy_process_group()


def spawn_ranks(fn, world, device_type, args=(), timeout=300, cards=None):
    """Runs fn(*args) on `world` ranks and returns rank 0's value.

    `cards` (cuda only) lists the card of each rank; cuda:r by default.
    Raises RuntimeError naming the rank when one fails or dies, and
    TimeoutError when the ranks are not done within `timeout` seconds."""
    if world < 1:
        raise ValueError(f"world size must be >= 1, got {world}")
    if cards is None:
        cards = list(range(world))
    if device_type == "cuda" and len(cards) != world:
        raise ValueError(f"{world} ranks need {world} cards, got {cards}")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="tpufd_ranks_")
    store_path = os.path.join(tmp, "store")
    procs = [ctx.Process(
        target=_rank_main, daemon=True,
        args=(rank, world, device_type, cards[rank], store_path, timeout,
              fn, args, results)) for rank in range(world)]
    done = False
    try:
        for proc in procs:
            proc.start()
        value = _collect(procs, results, timeout)
        done = True
        return value
    finally:
        # After a failure the other ranks may wait in a collective for
        # the whole group timeout: kill them at once.
        for proc in procs:
            if proc.pid is None:  # never started
                continue
            if done:
                proc.join(timeout=30)
            if proc.is_alive():
                proc.kill()
            proc.join()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)


def _collect(procs, results, timeout):
    """Rank 0's value once every rank has reported; raises at the first
    failure, at a rank dead without a result, or at the deadline (the
    caller then kills the rest)."""
    world = len(procs)
    deadline = time.monotonic() + timeout
    pending = set(range(world))
    dead_since = {}
    value = None
    while pending:
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            raise TimeoutError(
                f"ranks {sorted(pending)} of {world} did not finish within "
                f"{timeout} s")
        try:
            rank, ok, result = pickle.loads(
                results.get(timeout=min(remaining, 1.0)))
        except queue_lib.Empty:
            now = time.monotonic()
            for rank in sorted(pending):
                code = procs[rank].exitcode
                if code is None:
                    continue
                dead_since.setdefault(rank, now)
                if now - dead_since[rank] > _DEAD_RANK_GRACE_S:
                    raise RuntimeError(
                        f"rank {rank} of {world} exited with code {code} "
                        f"without a result") from None
            continue
        if not ok:
            raise RuntimeError(f"rank {rank} of {world} failed:\n{result}")
        pending.discard(rank)
        if rank == 0:
            value = result
    return value
