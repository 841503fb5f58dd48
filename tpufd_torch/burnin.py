"""Slice burn-in: the PyTorch port of tpufd/burnin.py.

A two-layer MLP block with a scale: x * gamma -> @ w_in -> gelu ->
@ w_out -> + x, at d_model 256 and d_ff 1024 by default. The parameters
keep the reference's names and layouts (w_in is (d_model, d_ff), w_out
is (d_ff, d_model)), so ``params_from_jax`` and ``params_to_numpy`` carry
weights across to and from the JAX package unchanged.

``make_train_step`` is the reference's step (forward, backward, SGD) and
``run_burnin`` its loop with the reference's telemetry, on one device or,
given a ('data', 'model') DeviceMesh, sharded as the reference shards it:
DTensor placements stand for its NamedShardings (``param_placements``,
``batch_placements``), and DTensor inserts the collectives XLA inserts.
``ring_attention`` is the reference's context-parallel attention: kv
blocks rotate around one mesh axis by point-to-point exchange under a
streaming softmax, checked against ``full_attention`` by
``run_ring_attention_burnin``. ``sharded_loss`` and ``ring_acceptance``
are the rank-side bodies of the multi-card ``burnin`` command, one
process group each; ``sharded_acceptance`` runs both in one, for the
hermetic dry run.
Mesh functions run on every rank of the process group (see
``tpufd_torch.launch``).
"""

import datetime
import math
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_module, distribute_tensor)

from tpufd_torch import mesh as mesh_lib
from tpufd_torch import metrics
from tpufd_torch.health import resolve_device, ring_shift

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
        if isinstance(h, DTensor):
            # The sequence, sharded over 'model' at the input, is gathered
            # for the tensor-parallel products, as XLA gathers it in the
            # reference: each product flattens (batch, seq), which DTensor
            # allows while the batch alone is sharded.
            h = h.redistribute(h.device_mesh, [h.placements[0], Replicate()])
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


def param_placements(mesh):
    """Tensor-parallel placements over a ('data', 'model') mesh, the
    reference's param_shardings: w_in column-sharded and w_out
    row-sharded over 'model', gamma replicated."""
    del mesh  # the same on every ('data', 'model') mesh
    return {"w_in": [Replicate(), Shard(1)],
            "w_out": [Replicate(), Shard(0)],
            "gamma": [Replicate(), Replicate()]}


def batch_placements(mesh):
    """The reference's batch_sharding: batch over 'data', sequence over
    'model', features whole."""
    del mesh
    return [Shard(0), Shard(1)]


def shard_model(model, mesh):
    """Distributes a BurninMLP's parameters over `mesh` in place at
    param_placements (every rank must hold the same values)."""
    placements = param_placements(mesh)

    def partition(name, module, device_mesh):
        del name
        for pname, param in list(module.named_parameters(recurse=False)):
            module.register_parameter(pname, nn.Parameter(distribute_tensor(
                param.detach(), device_mesh, placements[pname])))

    return distribute_module(model, mesh, partition)


def make_train_step(model, learning_rate=1e-3):
    """Returns step(x, y) -> loss: the reference's train step (forward,
    backward and an SGD update). The loss is the one at the parameters
    from before the update, as jax.value_and_grad gives it. Each
    parameter is updated in place as (p - lr * g) in float32, cast back to
    its own dtype, as the reference updates its pytree.

    On a model sharded by shard_model, with x and y DTensors at
    batch_placements, the step is the reference's sharded step: each
    gradient is brought to its parameter's placements before the update,
    so every parameter keeps the placements it had, and the loss comes
    back replicated, as a plain tensor."""
    params = [model.w_in, model.w_out, model.gamma]

    def step(x, y):
        loss = loss_fn(model, x, y)
        grads = torch.autograd.grad(loss, params)
        with torch.no_grad():
            for p, g in zip(params, grads):
                if isinstance(p, DTensor):
                    g = g.redistribute(p.device_mesh, p.placements)
                p.copy_(p.float() - learning_rate * g.float())
        if isinstance(loss, DTensor):
            loss = loss.full_tensor()
        return loss.detach()

    return step


def run_burnin(device=None, batch=None, seq=None, d_model=256, d_ff=1024,
               steps=2, model_parallelism=None, mesh=None):
    """Runs the train step `steps` times and returns the final loss
    (float).

    Without `mesh`, on one device (the CUDA card unless device="cpu";
    raises without a card), shapes as in the reference on a (data, model)
    = (1, 1) mesh: batch 4, seq 8. With a ('data', 'model') DeviceMesh
    (data_model_mesh), sharded over it on every rank, on the mesh's
    device type, with the reference's defaults batch 4 * data and seq
    8 * model; model_parallelism then is the mesh's. The parameters and
    inputs are drawn on the host from seed 0 alike on every rank.

    Records tpufd_burnin_step_duration_seconds (phase=compile for step 0,
    which carries eager PyTorch's first-use costs, steady for the rest;
    dispatch time, only the final loss is fetched) and
    tpufd_burnin_final_loss."""
    if mesh is None:
        device = resolve_device(device)
        data_n, model_n = mesh_lib.data_model_shape(1, model_parallelism)
    else:
        device = resolve_device(mesh.device_type)
        data_n, model_n = mesh["data"].size(), mesh["model"].size()
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
    if mesh is not None:
        shard_model(model, mesh)
        x = distribute_tensor(x, mesh, batch_placements(mesh))
        y = distribute_tensor(y, mesh, batch_placements(mesh))

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


def full_attention(q, k, v, causal=False):
    """Unsharded softmax(QK^T/sqrt(d))V in float32, cast back to q's dtype:
    the ground truth ring_attention must reproduce. q, k, v: [heads, seq,
    d_head]."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.einsum("hqd,hkd->hqk", q.float(), k.float()) * scale
    if causal:
        pos = torch.arange(q.shape[1], device=q.device)
        s = s.masked_fill(pos[None, None, :] > pos[None, :, None], -math.inf)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("hqk,hkd->hqd", p, v.float()).to(q.dtype)


def ring_attention(q, k, v, mesh, axis, causal=False):
    """Context-parallel attention over one axis of `mesh`, the reference's
    ring: q, k, v are this rank's block [heads, seq / n, d_head] of a
    sequence laid out over `axis` in mesh order; the kv blocks rotate
    around the axis (ring_shift, n steps and n rotations) while a
    streaming softmax in float32 (running max, denominator and output)
    accumulates exact attention. Returns this rank's output block.

    causal=True masks by GLOBAL position: at step t this rank holds the
    block that started on axis position (me - t) mod n. The rotation
    starts on the rank's own block, so every query row sees its diagonal
    first and no running max stays at -inf."""
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    me = mesh.get_local_rank(axis)
    heads, sq, d = q.shape
    sk = k.shape[1]
    q32 = q.float() * (1.0 / (d ** 0.5))
    q_pos = me * sq + torch.arange(sq, device=q.device)
    m = torch.full((heads, sq), -math.inf, device=q.device)
    l = torch.zeros((heads, sq), device=q.device)
    o = torch.zeros((heads, sq, d), device=q.device)
    k_cur, v_cur = k, v
    for t in range(n):
        s = torch.einsum("hqd,hkd->hqk", q32, k_cur.float())
        if causal:
            src = (me - t) % n
            kv_pos = src * sk + torch.arange(sk, device=q.device)
            s = s.masked_fill(kv_pos[None, None, :] > q_pos[None, :, None],
                              -math.inf)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        o = o * alpha[..., None] + torch.einsum("hqk,hkd->hqd", p,
                                                v_cur.float())
        m = m_new
        k_cur, v_cur = ring_shift([k_cur, v_cur], mesh, axis)
    return (o / l[..., None]).to(q.dtype)


class RingDivergedError(RuntimeError):
    """Ring attention disagreed with full attention, on every rank."""


RING_MODES = ("bidirectional", "causal")  # the reference's order
# How long a rank waits, after a ring mode, for every rank's outcome of
# it. Ranks arrive within the mode's own run time of each other unless
# one is stuck in an exchange that a failed rank left.
RING_AGREE_TIMEOUT_S = 60


def run_ring_attention_burnin(mesh, axis=None, heads=2, seq=None, d_head=64,
                              dtype=torch.float32, causal=False):
    """Runs ring_attention over `axis` of `mesh` (default its first) on
    every rank and checks it against full_attention: the max absolute
    error over the whole sequence (float, the same on every rank).
    Raises RingDivergedError when it passes the dtype's tolerance (1e-4 in
    float32, 2e-2 otherwise). q, k, v of [heads, seq, d_head] (seq default
    8 per rank of the axis) come from one seeded host generator alike on
    every rank, which takes its block. Records
    tpufd_burnin_ring_seconds{mode}."""
    axis = axis or mesh.mesh_dim_names[0]
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    if seq is None:
        seq = 8 * n
    device = resolve_device(mesh.device_type)
    gen = torch.Generator().manual_seed(7)
    q, k, v = (torch.randn((heads, seq, d_head), generator=gen).to(
        device=device, dtype=dtype) for _ in range(3))
    want = full_attention(q, k, v, causal=causal)
    block, me = seq // n, mesh.get_local_rank(axis)
    mine = slice(me * block, (me + 1) * block)
    ring_t0 = time.perf_counter()
    got = ring_attention(q[:, mine], k[:, mine], v[:, mine], mesh, axis,
                         causal=causal)
    err = (got.float() - want[:, mine].float()).abs().max().reshape(1)
    dist.all_reduce(err, op=dist.ReduceOp.MAX, group=mesh.get_group(axis))
    err = float(err)
    mode = "causal" if causal else "bidirectional"
    metrics.default_registry().gauge(
        "tpufd_burnin_ring_seconds",
        "Run + equality-check wall time of the ring-attention burn-in, "
        "per mode.", labels={"mode": mode}).set(time.perf_counter() - ring_t0)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    if not err <= tol:
        raise RingDivergedError(
            f"{mode} ring attention diverged from full attention: max abs "
            f"err {err} > {tol} — the {axis}-axis exchange is corrupting "
            f"data")
    return err


def sharded_loss(device_type, steps, model_parallelism=None):
    """The multi-card burn-in's train step, run by every rank of a
    process group (launch.spawn_ranks) on `device_type`: run_burnin over
    a data_model_mesh of every rank. Returns {"loss": float, "metrics":
    this rank's telemetry as textfile text}."""
    mesh = mesh_lib.data_model_mesh(device_type, model_parallelism)
    loss = run_burnin(mesh=mesh, steps=steps)
    return {"loss": loss, "metrics": metrics.default_registry().render()}


def ring_acceptance(device_type):
    """The multi-card burn-in's ring check, run by every rank of a process
    group: run_ring_attention_burnin in each of RING_MODES over a
    ('context',) mesh of every rank.

    Every rank runs the same collectives in the same order. After each
    mode the ranks agree on its outcome over a gloo group made first (on
    the host, so a broken NCCL communicator leaves it working): the mode
    failed if any rank raised a RuntimeError in it, be it divergence,
    which every rank sees alike, or an error of one rank alone. A rank
    whose peers do not reach the agreement within RING_AGREE_TIMEOUT_S
    (one is stuck in the exchange a failed rank left) raises, so the
    launcher ends the call.

    Returns {"ring": [(mode, err or None, error text or None)], "metrics":
    this rank's telemetry as textfile text}, the ring the same on every
    rank. An error every rank raised alike keeps its text; otherwise the
    text of the lowest failed rank is prefixed with "rank r of n: "."""
    world = dist.get_world_size()
    agree = dist.new_group(
        backend="gloo",
        timeout=datetime.timedelta(seconds=RING_AGREE_TIMEOUT_S))
    ring_mesh = init_device_mesh(device_type, (world,),
                                 mesh_dim_names=("context",))
    rings = []
    for mode in RING_MODES:
        try:
            err, error = run_ring_attention_burnin(
                ring_mesh, causal=mode == "causal"), None
        except RuntimeError as e:  # the peers learn of it below
            err, error = None, str(e) or repr(e)
        errors = [None] * world
        try:
            dist.all_gather_object(errors, error, group=agree)
        except RuntimeError as e:
            raise RuntimeError(
                error or f"{mode} ring attention: the ranks did not agree "
                         f"within {RING_AGREE_TIMEOUT_S} s ({e})") from e
        failed = {r: text for r, text in enumerate(errors)
                  if text is not None}
        if not failed:
            rings.append((mode, err, None))
        elif len(failed) == world and len(set(failed.values())) == 1:
            rings.append((mode, None, errors[0]))
        else:
            first = min(failed)
            rings.append((mode, None,
                          f"rank {first} of {world}: {failed[first]}"))
    return {"ring": rings, "metrics": metrics.default_registry().render()}


def sharded_acceptance(device_type, steps):
    """The whole multi-card burn-in in one process group, as the hermetic
    dry run runs it: sharded_loss, then, if the loss is finite,
    ring_acceptance. Returns {"loss": float, "ring": [(mode, err or None,
    error text or None)]}, the same on every rank."""
    loss = sharded_loss(device_type, steps)["loss"]
    rings = ring_acceptance(device_type)["ring"] if math.isfinite(
        loss) else []
    return {"loss": loss, "ring": rings}
