"""The port's multi-device path on gloo ranks, against tpufd on JAX's
virtual CPU devices: the all-reduce and ring probes, the sharded train
step, ring attention, health_labels' multi-card block and the launcher.

Each spawn of ranks costs seconds, so the rank-side checks are grouped:
one module-scoped spawn per world size runs every check and rank 0 hands
back what the tests compare. The rank functions live at module level
(the ranks import this module by name) and this module imports no JAX at
its top, so no rank loads it.
"""

import math
import multiprocessing
import operator
import os
import pickle
import time
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import distribute_tensor
from torch.distributed.tensor.debug import CommDebugMode

from tpufd_torch import burnin, health, launch, mesh as mesh_lib

PREFIX = "google.com/tpu.health."
SECONDS = 0.25  # what the stubbed timer reports in both packages
SPAWN_TIMEOUT = 150
# ici_axis_gbps over a 2x2 coordinate grid (x, y), as the reference's
# physical mesh lays a 2x2 slice out.
GRID_2X2 = [types.SimpleNamespace(coords=(x, y, 0))
            for x in range(2) for y in range(2)]
LR = 0.1


# ---- rank side -------------------------------------------------------------

def gather(t):
    """Every rank's tensor, stacked in rank order, as numpy (float32)."""
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t.contiguous())
    return torch.stack(parts).float().numpy()


def fixed_timer(fn, iters, settle_s=0.5, agree_on=None):
    """_time_iters stand-in: runs the probe body once, reports SECONDS."""
    del settle_s, agree_on
    health._fetch_scalar(fn(iters, 0.125))
    return SECONDS


def sharded_steps(state, x, y, model_parallelism, lr=LR, steps=2):
    """`steps` sharded train steps at `lr` over a data_model_mesh, from
    the parameters in `state` (their dtype is the step's); returns the
    losses, the gathered parameters, their placements before and after
    the steps, and the collectives of the first step."""
    mesh = mesh_lib.data_model_mesh("cpu", model_parallelism)
    d_model, d_ff = state["w_in"].shape
    dtype = state["w_in"].dtype
    model = burnin.BurninMLP(d_model, d_ff, dtype=dtype)
    model.load_state_dict(state)
    burnin.shard_model(model, mesh)
    before = {n: tuple(getattr(model, n).placements)
              for n in ("w_in", "w_out", "gamma")}
    xt, yt = (distribute_tensor(torch.from_numpy(a).to(dtype), mesh,
                                burnin.batch_placements(mesh))
              for a in (x, y))
    step = burnin.make_train_step(model, lr)
    with CommDebugMode() as comm:
        losses = [float(step(xt, yt))]
    losses += [float(step(xt, yt)) for _ in range(steps - 1)]
    return {"shape": (mesh["data"].size(), mesh["model"].size()),
            "losses": losses,
            "params": {n: getattr(model, n).full_tensor().detach().float()
                       .numpy()
                       for n in ("w_in", "w_out", "gamma")},
            "placements": (before, {n: tuple(getattr(model, n).placements)
                                    for n in ("w_in", "w_out", "gamma")}),
            "collectives": comm.get_total_counts()}


def ring_outputs(q, k, v):
    """ring_attention in both modes over a ('context',) mesh of every
    rank, on this rank's block of the numpy q, k, v; gathered."""
    mesh = init_device_mesh("cpu", (dist.get_world_size(),),
                            mesh_dim_names=("context",))
    me, n = dist.get_rank(), dist.get_world_size()
    block = q.shape[1] // n
    mine = slice(me * block, (me + 1) * block)
    out = {}
    for causal in (False, True):
        got = burnin.ring_attention(
            *(torch.from_numpy(a[:, mine]) for a in (q, k, v)), mesh,
            "context", causal=causal)
        # [rank, heads, block, d] -> [heads, seq, d]
        out[causal] = np.concatenate(list(gather(got)), axis=1)
    out["burnin"] = {causal: burnin.run_ring_attention_burnin(
        mesh, causal=causal) for causal in (False, True)}
    real_full = burnin.full_attention
    burnin.full_attention = lambda *a, **kw: real_full(*a, **kw) + 1.0
    try:
        burnin.run_ring_attention_burnin(mesh, seq=4 * n)
    except burnin.RingDivergedError as e:
        out["corrupted"] = str(e)
    finally:
        burnin.full_attention = real_full
    return out


def probe_checks():
    """The all-reduce step and loop, the ring shift and both probes."""
    me, n = dist.get_rank(), dist.get_world_size()
    flat = init_device_mesh("cpu", (n,), mesh_dim_names=("all",))
    grid = health.physical_mesh(GRID_2X2, "cpu")
    group = flat.get_group("all")
    cards = [torch.device("cuda", i) for i in range(n)]
    out = {"grid_names": grid.mesh_dim_names,
           "grid_ranks": grid.mesh.tolist(),
           "cards_names": health.physical_mesh(cards, "cpu").mesh_dim_names}
    rows = allreduce_rows(n)
    for dtype in (torch.float32, torch.bfloat16):
        row = torch.from_numpy(rows[me]).to(dtype)
        out[f"step_{dtype}"] = gather(health._allreduce_loop(row, 1, group))
    # Ring shifts of a rank-stamped shard, on the flat mesh and along
    # each axis of the grid.
    shard = torch.full((4, 8), float(me), dtype=torch.bfloat16)
    out["shift_1"] = gather(health._shift_loop(shard, 1, flat, "all"))
    out["shift_n"] = gather(health._shift_loop(shard, n, flat, "all"))
    for axis in grid.mesh_dim_names:
        out[f"shift_{axis}"] = gather(health._shift_loop(shard, 1, grid,
                                                          axis))
    # Real probes, at small sizes.
    out["allreduce_real"] = health.allreduce_gbps(flat, mib=1, iters=2)
    out["ici_real"] = {axis: health.ici_axis_gbps(grid, axis, mib=1,
                                                  iters=2)
                       for axis in grid.mesh_dim_names}
    # The byte formulas, timer stubbed.
    real_timer = health._time_iters
    health._time_iters = fixed_timer
    try:
        out["allreduce_formula"] = health.allreduce_gbps(flat, mib=8)
        out["ici_formula"] = {axis: health.ici_axis_gbps(grid, axis, mib=4,
                                                         iters=2)
                              for axis in grid.mesh_dim_names}
    finally:
        health._time_iters = real_timer
    return out


def four_rank_checks(state, x, y, q, k, v):
    return {"probes": probe_checks(),
            "step": sharded_steps(state, x, y, 2),
            "ring": ring_outputs(q, k, v),
            "visible_cards": os.environ["CUDA_VISIBLE_DEVICES"]}


def two_rank_checks(state, x, y, q, k, v, bf16_state, bf16_x, bf16_y):
    return {"step": {mp: sharded_steps(state, x, y, mp) for mp in (1, 2)},
            "ring": ring_outputs(q, k, v),
            "bf16": sharded_steps(bf16_state, bf16_x, bf16_y, 2,
                                  lr=1e-3)}


def fail_on_rank_1():
    """Rank 1 raises while rank 0 waits for it in a collective."""
    if dist.get_rank() == 1:
        raise ValueError("rank 1 is broken")
    dist.barrier()


def spawn_then_die():
    dist.barrier()
    os._exit(3)


# ---- inputs and JAX references ----------------------------------------------

def allreduce_rows(n):
    """A seeded (n, 64) array of eighths below 8 in magnitude: every sum
    of its rows is exact in float32 and in bf16, in any order."""
    rng = np.random.default_rng(11)
    return (rng.integers(-63, 64, (n, 64)) / 8).astype(np.float32)


def step_inputs(seed=5, d_model=64, d_ff=128):
    """numpy float32 parameters as tpufd.burnin.init_params draws them at
    float32 (gamma away from 1), and (x, y) of shape (4, 8, d_model)."""
    import jax

    from tpufd import burnin as ref

    params = ref.init_params(jax.random.PRNGKey(seed), d_model=d_model,
                             d_ff=d_ff, dtype=jax.numpy.float32)
    params = {name: np.asarray(value) for name, value in params.items()}
    rng = np.random.default_rng(seed)
    params["gamma"] = (1 + 0.1 * rng.standard_normal(d_model)).astype(
        np.float32)
    x = rng.standard_normal((4, 8, d_model), dtype=np.float32)
    y = 0.5 * rng.standard_normal((4, 8, d_model), dtype=np.float32)
    return params, x, y


def attention_inputs(seed=3, heads=2, seq=32, d_head=16):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((heads, seq, d_head), dtype=np.float32)
                 for _ in range(3))


def jax_steps(jax, params, x, y, k, model_parallelism, steps=2):
    """tpufd.burnin's sharded step over a data_model_mesh of k CPU
    devices: ([loss per step], params after)."""
    from tpufd import burnin as ref, mesh as ref_mesh

    jnp = jax.numpy
    mesh = ref_mesh.data_model_mesh(jax.devices("cpu")[:k],
                                    model_parallelism=model_parallelism)
    p = jax.device_put({n: jnp.asarray(a) for n, a in params.items()},
                       ref.param_shardings(mesh))
    xs, ys = (jax.device_put(jnp.asarray(a), ref.batch_sharding(mesh))
              for a in (x, y))
    step = ref.make_train_step(mesh, LR)
    losses = []
    for _ in range(steps):
        p, loss = step(p, xs, ys)
        losses.append(float(loss))
    return losses, {n: np.asarray(a) for n, a in p.items()}


def jax_ring(jax, q, k, v, n, causal):
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from tpufd import burnin as ref

    mesh = Mesh(np.array(jax.devices("cpu")[:n]), ("context",))
    sharding = NamedSharding(mesh, P(None, "context", None))
    qs, ks, vs = (jax.device_put(jax.numpy.asarray(a), sharding)
                  for a in (q, k, v))
    return np.asarray(ref.ring_attention(qs, ks, vs, mesh, "context",
                                         causal=causal))


def as_state(params):
    return {n: torch.tensor(a) for n, a in params.items()}


@pytest.fixture(scope="module")
def four_ranks(cpu_jax):
    params, x, y = step_inputs()
    return launch.spawn_ranks(
        four_rank_checks, 4, "cpu",
        args=(as_state(params), x, y, *attention_inputs()),
        timeout=SPAWN_TIMEOUT)


def bf16_inputs():
    """The port's bf16 parameters at full width (d_model 256, d_ff 1024)
    and float32 (x, y) of shape (4, 8, 256)."""
    model = burnin.init_params(torch.Generator().manual_seed(6))
    rng = np.random.default_rng(16)
    x = rng.standard_normal((4, 8, 256), dtype=np.float32)
    y = 0.5 * rng.standard_normal((4, 8, 256), dtype=np.float32)
    return {n: t.detach().clone() for n, t in model.state_dict().items()}, x, y


@pytest.fixture(scope="module")
def two_ranks(cpu_jax):
    params, x, y = step_inputs()
    return launch.spawn_ranks(
        two_rank_checks, 2, "cpu",
        args=(as_state(params), x, y, *attention_inputs(seq=16),
              *bf16_inputs()), timeout=SPAWN_TIMEOUT)


# ---- the probes -------------------------------------------------------------

def test_coords_grid_matches_the_reference_cases(cpu_jax):
    """_coords_grid on every case of tpufd's test_coords_grid_arrangement:
    the same shape, axis names and device at each grid position."""
    from tpufd import health as ref

    def dev(*coords):
        return types.SimpleNamespace(coords=coords)

    cases = [
        [dev(x, y, 0) for x in range(2) for y in range(2)],
        [dev(x, 5, 3) for x in range(4)],
        [dev(0, 0, 0)],
        [dev(0, 0, 0), dev(0, 0, 0)],
        [dev(0, 0, 0), dev(1, 1, 0), dev(0, 1, 0)],
        [object(), object()],
        [torch.device("cuda", 0), torch.device("cuda", 1)],
    ]
    for devices in cases:
        got, want = health._coords_grid(devices), ref._coords_grid(devices)
        assert got[1] == want[1]
        if want[0] is None:
            assert got[0] is None
        else:
            assert got[0].shape == want[0].shape
            assert all(a is b for a, b in zip(got[0].flat, want[0].flat))
    grid, names = health._coords_grid(cases[0])
    assert names == ("x", "y") and grid[1, 0] is cases[0][2]


def test_physical_mesh_lays_ranks_out_on_the_grid(four_ranks):
    """A 2x2 coordinate grid becomes an (x, y) mesh, rank r standing for
    devices[r]; CUDA cards, with no coords, give the flat mesh."""
    probes = four_ranks["probes"]
    assert probes["grid_names"] == ("x", "y")
    assert probes["grid_ranks"] == [[0, 1], [2, 3]]
    assert probes["cards_names"] == ("all",)


@pytest.mark.parametrize("dtype", ["torch.float32", "torch.bfloat16"])
def test_one_allreduce_step_equals_the_reference_sum(cpu_jax, four_ranks,
                                                     dtype):
    """One step over 4 ranks equals rows + rows.sum(0) * 1e-6: exactly in
    float32, and within one bf16 ulp of the reference's jnp arithmetic in
    bf16 (the rows sum exactly in either dtype)."""
    jnp = cpu_jax.numpy
    rows = allreduce_rows(4)
    got = four_ranks["probes"][f"step_{dtype}"]
    if dtype == "torch.float32":
        want = rows + rows.sum(0, keepdims=True) * np.float32(1e-6)
        np.testing.assert_array_equal(got, want)
    else:
        acc = jnp.asarray(rows, dtype=jnp.bfloat16)
        want = np.asarray(acc + jnp.sum(acc, axis=0, keepdims=True) * 1e-6,
                          dtype=np.float32)
        np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=0)


def test_ring_shift_moves_each_shard_to_the_next_rank(four_ranks):
    """One shift: rank r holds rank r-1's shard; n shifts: the identity.
    On the grid, each axis shifts along itself alone."""
    probes = four_ranks["probes"]
    stamp = lambda values: [float(v) for v in values]  # noqa: E731
    assert stamp(probes["shift_1"][:, 0, 0]) == [3, 0, 1, 2]
    assert stamp(probes["shift_n"][:, 0, 0]) == [0, 1, 2, 3]
    assert (probes["shift_1"] != probes["shift_n"]).any()
    # ranks [[0, 1], [2, 3]]: x runs down the columns, y along the rows.
    assert stamp(probes["shift_x"][:, 0, 0]) == [2, 3, 0, 1]
    assert stamp(probes["shift_y"][:, 0, 0]) == [1, 0, 3, 2]


def test_probe_byte_formulas_equal_the_reference(cpu_jax, four_ranks,
                                                 monkeypatch):
    """allreduce_gbps and ici_axis_gbps with the timer reporting the same
    seconds in both packages: equal to 1e-9, the reference's count of all
    n elements per all-reduce step included."""
    from jax.sharding import Mesh

    from tpufd import health as ref

    monkeypatch.setattr(ref, "_time_iters", lambda fn, iters, settle_s:
                        SECONDS)
    devices = cpu_jax.devices("cpu")[:4]
    flat = Mesh(np.array(devices), ("all",))
    grid = Mesh(np.array(devices).reshape(2, 2), ("x", "y"))
    probes = four_ranks["probes"]
    assert probes["allreduce_formula"] == pytest.approx(
        ref.allreduce_gbps(flat, mib=8), rel=1e-9)
    for axis in ("x", "y"):
        assert probes["ici_formula"][axis] == pytest.approx(
            ref.ici_axis_gbps(grid, axis, mib=4, iters=2), rel=1e-9)


def test_reference_all_reduce_carries_one_row_per_device(cpu_jax,
                                                         monkeypatch):
    """Why the label reads k times the bus bandwidth: the reference's
    compiled loop all-reduces n / k elements per device (k = 4, 8 MiB),
    while its byte count, kept by the port, counts all n."""
    import re

    from jax.sharding import Mesh

    from tpufd import health as ref

    seen = []

    def compile_loop(fn, iters, settle_s):
        cells = dict(zip(fn.__code__.co_freevars,
                         (c.cell_contents for c in fn.__closure__)))
        seen.append(cells["reduce_loop"].lower(cells["x"], 1).compile()
                    .as_text())
        return SECONDS

    monkeypatch.setattr(ref, "_time_iters", compile_loop)
    ref.allreduce_gbps(Mesh(np.array(cpu_jax.devices("cpu")[:4]), ("all",)),
                       mib=8)
    n = 8 * 1024 * 1024 // 2
    payloads = re.findall(r"= \w+\[(\d+)\]\S* all-reduce\(", seen[0])
    assert payloads == [str(n // 4)]


def test_real_probes_over_gloo_are_finite_and_positive(four_ranks):
    probes = four_ranks["probes"]
    assert math.isfinite(probes["allreduce_real"])
    assert probes["allreduce_real"] > 0
    for axis in ("x", "y"):
        assert probes["ici_real"][axis] > 0


# ---- the sharded train step -------------------------------------------------

@pytest.mark.parametrize("k, model_parallelism", [(4, 2), (2, 1), (2, 2)])
def test_sharded_step_float32_matches_jax(cpu_jax, four_ranks, two_ranks,
                                          k, model_parallelism):
    """2 steps at lr 0.1, d_model 64, d_ff 128, on (data, model) = (2, 2),
    (2, 1) and (1, 2): the losses and the gathered parameters within
    rtol 1e-5 of tpufd's sharded step on the same JAX mesh."""
    params, x, y = step_inputs()
    got = (four_ranks["step"] if k == 4
           else two_ranks["step"][model_parallelism])
    assert got["shape"] == (k // model_parallelism, model_parallelism)
    want_losses, want = jax_steps(cpu_jax, params, x, y, k,
                                  model_parallelism)
    np.testing.assert_allclose(got["losses"], want_losses, rtol=1e-5)
    assert got["losses"][1] < got["losses"][0]
    for name in ("w_in", "w_out", "gamma"):
        np.testing.assert_allclose(got["params"][name], want[name],
                                   rtol=1e-5, atol=1e-7, err_msg=name)
    assert not np.allclose(got["params"]["w_in"], params["w_in"],
                           rtol=1e-4, atol=0)


def test_sharded_step_keeps_the_reference_placements(four_ranks):
    """w_in column-sharded and w_out row-sharded over 'model', gamma
    replicated, before the steps and after the in-place update."""
    before, after = four_ranks["step"]["placements"]
    assert before == after
    assert [str(p) for p in after["w_in"]] == ["R", "S(1)"]
    assert [str(p) for p in after["w_out"]] == ["R", "S(0)"]
    assert [str(p) for p in after["gamma"]] == ["R", "R"]


def test_sharded_step_bf16_full_width_matches_one_device(two_ranks):
    """bf16 at d_model 256, d_ff 1024 on (1, 2): the loss within rel 2e-2
    of the port's one-device step and each parameter within one bf16 ulp
    (rtol 8e-3) beside half its largest update, the tolerances of
    test_train_step_bf16_matches_jax_at_full_width."""
    state, x, y = bf16_inputs()
    model = burnin.BurninMLP(256, 1024)
    model.load_state_dict(state)
    step = burnin.make_train_step(model)
    xt, yt = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, y))
    want_losses = [float(step(xt, yt)) for _ in range(2)]
    got = two_ranks["bf16"]
    np.testing.assert_allclose(got["losses"], want_losses, rtol=2e-2)
    want = burnin.params_to_numpy(model)
    for name in ("w_in", "w_out", "gamma"):
        init = state[name].float().numpy()
        update = np.abs(want[name] - init).max()
        np.testing.assert_allclose(got["params"][name], want[name],
                                   rtol=8e-3, atol=0.5 * update,
                                   err_msg=name)


@pytest.mark.parametrize("k", [4, 2])
def test_tensor_parallel_step_runs_collectives(four_ranks, two_ranks, k):
    """The counterpart of test_burnin_collectives_present: with model = 2
    one step of the sharded step runs collectives."""
    got = four_ranks["step"] if k == 4 else two_ranks["step"][2]
    assert got["collectives"] > 0


# ---- ring attention ---------------------------------------------------------

@pytest.mark.parametrize("k", [4, 2])
@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_matches_jax_and_full_attention(
        cpu_jax, four_ranks, two_ranks, k, causal):
    """Both modes within 1e-5 of tpufd.burnin.ring_attention on the same
    q, k, v over k JAX devices, and within 1e-4 of full attention."""
    q, kk, v = attention_inputs(seq=32 if k == 4 else 16)
    got = (four_ranks if k == 4 else two_ranks)["ring"][causal]
    np.testing.assert_allclose(got, jax_ring(cpu_jax, q, kk, v, k, causal),
                               rtol=0, atol=1e-5)
    full = burnin.full_attention(*(torch.from_numpy(a) for a in (q, kk, v)),
                                 causal=causal).numpy()
    np.testing.assert_allclose(got, full, rtol=0, atol=1e-4)


def test_causal_ring_attention_actually_masks(four_ranks):
    """Causal differs from bidirectional, and under the mask the first
    token attends only to itself: row 0 equals v[0]."""
    _, _, v = attention_inputs()
    ring = four_ranks["ring"]
    assert np.abs(ring[True] - ring[False]).max() > 1e-3
    np.testing.assert_allclose(ring[True][:, 0], v[:, 0], rtol=0, atol=1e-5)


def test_full_attention_matches_jax(cpu_jax):
    from tpufd import burnin as ref

    q, k, v = attention_inputs(seq=12)
    for causal in (False, True):
        want = np.asarray(ref.full_attention(
            *(cpu_jax.numpy.asarray(a) for a in (q, k, v)), causal=causal))
        got = burnin.full_attention(
            *(torch.from_numpy(a) for a in (q, k, v)), causal=causal)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("k", [4, 2])
def test_ring_burnin_passes_and_detects_divergence(four_ranks, two_ranks, k):
    """run_ring_attention_burnin at its defaults passes in both modes; a
    corrupted full_attention fails it on every rank, with the
    reference's text."""
    ring = (four_ranks if k == 4 else two_ranks)["ring"]
    assert all(err <= 1e-4 for err in ring["burnin"].values())
    assert "bidirectional ring attention diverged from full attention" in (
        ring["corrupted"])
    assert "context-axis exchange is corrupting data" in ring["corrupted"]


# ---- health_labels' multi-card block ----------------------------------------

def stub_core_probes(monkeypatch, module):
    for name in ("matmul_tflops", "hbm_gbps", "dma_copy_gbps"):
        monkeypatch.setattr(module, name, lambda **kw: 42.0)


def test_label_keys_equal_jax_at_two_devices(cpu_jax, monkeypatch):
    """Two visible devices: the all-reduce runs for real over 2 gloo
    ranks (8 MiB, median of 3) and the key set equals tpufd's for 2
    devices, allreduce-gbps in and no ici-* (no coordinate grid)."""
    import jax

    from tpufd import health as ref

    stub_core_probes(monkeypatch, ref)
    devices = jax.devices("cpu")[:2]
    monkeypatch.setattr(ref.jax, "devices", lambda *a: devices)
    want = set(ref.health_labels())
    stub_core_probes(monkeypatch, health)
    monkeypatch.setattr(health, "_visible_devices",
                        lambda device: [device, device])
    labels = health.health_labels(device="cpu")
    assert set(labels) == want
    assert PREFIX + "allreduce-gbps" in labels
    assert not any("ici-" in key for key in labels)
    assert float(labels[PREFIX + "allreduce-gbps"]) > 0
    assert labels[PREFIX + "ok"] == "true"


class SpawnRecorder:
    """launch.spawn_ranks stand-in: records each call, returns `value` or
    raises it when it is an exception."""

    def __init__(self, value=1.0, fail=()):
        self.calls = []
        self.value = value
        self.fail = fail

    def __call__(self, fn, world, device_type, args=(), **kwargs):
        self.calls.append((fn.__name__, world, device_type, args, kwargs))
        if fn.__name__ in self.fail:
            raise RuntimeError(f"rank 1 of {world} failed: {fn.__name__}")
        return self.value


def test_allreduce_failure_sets_ok_false(monkeypatch):
    stub_core_probes(monkeypatch, health)
    monkeypatch.setattr(health, "_visible_devices",
                        lambda device: [device, device])
    recorder = SpawnRecorder(fail=("_allreduce_rank",))
    monkeypatch.setattr(health.launch, "spawn_ranks", recorder)
    labels = health.health_labels(device="cpu")
    assert labels[PREFIX + "ok"] == "false"
    assert PREFIX + "allreduce-gbps" not in labels
    assert [c[:3] for c in recorder.calls] == [("_allreduce_rank", 2, "cpu")]


@pytest.mark.parametrize("fail", [(), ("_ici_axis_rank",)])
def test_ici_sweep_runs_one_spawn_per_grid_axis(cpu_jax, monkeypatch,
                                                capsys, fail):
    """Devices on a 2x2 grid: one ici-<axis>-gbps label per axis, each
    from its own spawn over all devices, the key set equal to tpufd's
    with its physical mesh substituted (test_ici_sweep_labels_cpu). A
    failing axis writes a stderr note and leaves ok=true."""
    import jax
    from jax.sharding import Mesh

    from tpufd import health as ref

    stub_core_probes(monkeypatch, ref)
    devices = jax.devices("cpu")[:4]
    monkeypatch.setattr(ref.jax, "devices", lambda *a: devices)
    monkeypatch.setattr(ref, "allreduce_gbps", lambda mesh, mib: 1.0)
    monkeypatch.setattr(ref, "ici_axis_gbps",
                        lambda mesh, axis, mib: 1.0)
    monkeypatch.setattr(ref, "physical_mesh", lambda d: Mesh(
        np.array(devices).reshape(2, 2), ("x", "y")))
    want = set(ref.health_labels())
    stub_core_probes(monkeypatch, health)
    monkeypatch.setattr(health, "_visible_devices", lambda device: GRID_2X2)
    recorder = SpawnRecorder(fail=fail)
    monkeypatch.setattr(health.launch, "spawn_ranks", recorder)
    labels = health.health_labels(device="cpu")
    assert labels[PREFIX + "ok"] == "true"
    assert [c[:3] for c in recorder.calls] == [
        ("_allreduce_rank", 4, "cpu"), ("_ici_axis_rank", 4, "cpu"),
        ("_ici_axis_rank", 4, "cpu")]
    assert [c[3][2:] for c in recorder.calls[1:]] == [("x", 4), ("y", 4)]
    if fail:
        assert set(labels) == want - {PREFIX + "ici-x-gbps",
                                      PREFIX + "ici-y-gbps"}
        err = capsys.readouterr().err
        assert "ici sweep axis x skipped" in err
        assert "ici sweep axis y skipped" in err
    else:
        assert set(labels) == want


def test_perfmodel_measures_ici_over_the_usable_cards(monkeypatch):
    """Several usable cards: ici-gbps is the all-reduce over them, one
    rank per usable card; its failure leaves ici-gbps None with the
    reference's note."""
    from tpufd_torch import perfmodel

    stub_core_probes(monkeypatch, health)
    cards = [types.SimpleNamespace(type="cpu", index=i) for i in range(3)]
    monkeypatch.setattr(perfmodel, "measurement_devices",
                        lambda devices, excluded: [cards[0], cards[2]])
    recorder = SpawnRecorder(value=7.5)
    monkeypatch.setattr(launch, "spawn_ranks", recorder)
    out = perfmodel.measure(device="cpu")
    assert out == {"matmul-tflops": 42.0, "hbm-gbps": 42.0,
                   "ici-gbps": 7.5}
    name, world, device_type, args, kwargs = recorder.calls[0]
    assert (name, world, args, kwargs["cards"]) == (
        "_allreduce_rank", 2, ("cpu", 8), [0, 2])


def test_perfmodel_ici_failure_is_a_note(monkeypatch, capsys):
    from tpufd_torch import perfmodel

    stub_core_probes(monkeypatch, health)
    monkeypatch.setattr(perfmodel, "measurement_devices",
                        lambda devices, excluded: [devices[0]] * 2)
    monkeypatch.setattr(launch, "spawn_ranks",
                        SpawnRecorder(fail=("_allreduce_rank",)))
    assert perfmodel.measure(device="cpu")["ici-gbps"] is None
    assert "ici probe skipped: rank 1 of 2 failed" in capsys.readouterr().err


# ---- the launcher -----------------------------------------------------------

def test_a_failing_rank_is_re_raised_with_its_traceback():
    """Rank 1 raises while rank 0 waits in a collective: the parent
    raises at once with rank 1's traceback, and no rank outlives it."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError) as failure:
        launch.spawn_ranks(fail_on_rank_1, 2, "cpu", timeout=SPAWN_TIMEOUT)
    assert time.monotonic() - t0 < 60
    text = str(failure.value)
    assert text.startswith("rank 1 of 2 failed:")
    assert "ValueError: rank 1 is broken" in text
    assert "fail_on_rank_1" in text
    assert multiprocessing.active_children() == []


def test_a_rank_dead_without_a_result_is_an_error():
    with pytest.raises(RuntimeError,
                       match=r"rank \d of 2 exited with code 3 without a "
                             r"result"):
        launch.spawn_ranks(spawn_then_die, 2, "cpu", timeout=SPAWN_TIMEOUT)
    assert multiprocessing.active_children() == []


def test_ranks_past_the_timeout_are_killed():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match=r"did not finish within 5 s"):
        launch.spawn_ranks(time.sleep, 2, "cpu", args=(300,), timeout=5)
    assert time.monotonic() - t0 < 60
    assert multiprocessing.active_children() == []


def test_cuda_ranks_never_fall_back_to_the_host():
    """Asked for the card on a host without one, a rank fails; it does
    not carry on with gloo."""
    with pytest.raises(RuntimeError, match="rank 0 of 1 failed"):
        launch.spawn_ranks(operator.add, 1, "cuda", args=(1, 2),
                           timeout=SPAWN_TIMEOUT)


@pytest.mark.parametrize("call, error", [
    (lambda: launch.spawn_ranks(operator.add, 0, "cpu"), "world size"),
    (lambda: launch.spawn_ranks(operator.add, 2, "cuda", cards=[0]),
     "2 ranks need 2 cards"),
])
def test_spawn_rejects_bad_arguments_before_starting(call, error):
    with pytest.raises(ValueError, match=error):
        call()
    assert multiprocessing.active_children() == []


def test_cpu_ranks_see_no_card(four_ranks):
    """Rank 0's value came back, and its environment hid every card."""
    assert four_ranks["visible_cards"] == ""


def test_an_unpicklable_function_starts_no_rank():
    with pytest.raises((AttributeError, TypeError, pickle.PicklingError)):
        launch.spawn_ranks(lambda: 1, 2, "cpu", timeout=SPAWN_TIMEOUT)
    assert multiprocessing.active_children() == []
