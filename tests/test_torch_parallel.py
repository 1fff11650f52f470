"""The port's ``parallel`` package against the JAX package's.

Every case of ``tests/test_sharding.py`` on the port's single-process mesh
of 8 ``"cpu"`` entries (the counterpart of the JAX tests' virtual 8-device
CPU mesh), each held to the same instance in the JAX package: the same
safe sets and refinement levels, and ``c_max`` equal in float64. The
sharded sweeps equal the port's sweeps without a mesh bit for bit over 1
to 8 entries and over 2 and 3 gloo ranks in child processes
(``_torch_parallel_worker.py``): fused, sorted and adaptive, streamed (a
tie at ``v_bad`` across the ranks), extended and hybrid. The dryrun module
reaches its ``OK`` line, and its training step equals the JAX script's on
the JAX network's weights within ``dryrun.TRAIN_RTOL``.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

import safe_learning_tpu as sl
import safe_learning_tpu_torch as st
from safe_learning_tpu.parallel import make_mesh as jax_make_mesh
from safe_learning_tpu.parallel import (
    sharded_safe_set_update as jax_sharded_update)
from safe_learning_tpu_torch import convert
from safe_learning_tpu_torch.lyapunov import _sharded_fused_update
from safe_learning_tpu_torch.parallel import (Mesh, grid_sharding,
                                              make_mesh, replicated_sharding,
                                              shard_points,
                                              sharded_safe_set_update)
from safe_learning_tpu_torch.parallel import distributed, dryrun
from safe_learning_tpu_torch.parallel.mesh import split_rows

import _torch_parallel_worker as cases
from _torch_parity import port_gp, to_numpy, working_dtype

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
#: Seconds a child rank may take, start-up included.
RANK_TIMEOUT_S = 240


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(devices=["cpu"] * 8)


def _jax_linear():
    grid = sl.GridWorld([[-1, 1], [-1, 1]], [32, 32])
    policy = sl.LambdaFunction(lambda x: 0.0 * x[:, :1])
    dyn = sl.LinearSystem([np.array([[0.8, 0.1], [0.0, 0.7]]),
                           np.zeros((2, 1))])
    return sl.Lyapunov(grid, sl.QuadraticFunction(np.eye(2)), dyn, 0.8, 1.0,
                       1e-4, policy, initial_set=[grid.nindex // 2 + 16])


def _jax_adaptive():
    grid = sl.GridWorld([[-1, 1], [-1, 1]], [33, 33])
    policy = sl.LambdaFunction(lambda x: 0.0 * x[:, :1])
    dyn = sl.LinearSystem([np.array([[0.92, 0.0], [0.0, 0.9]]),
                           np.zeros((2, 1))])
    lv = sl.LambdaFunction(lambda x: 2.0 * jnp.abs(x))
    return sl.Lyapunov(grid, sl.QuadraticFunction(np.eye(2)), dyn, 0.95, lv,
                       4e-3, policy, initial_set=[grid.nindex // 2],
                       adaptive=True)


def test_mesh_creation(mesh):
    assert mesh.devices.size == 8
    assert mesh.axis_names == ("grid",)
    assert mesh.shape == {"grid": 8}
    assert not mesh.is_multiprocess
    assert make_mesh(4, devices=["cpu"] * 8).size == 4
    two_d = make_mesh(devices=["cpu"] * 8, axis_names=("data", "model"),
                      shape=(4, 2))
    assert two_d.shape == {"data": 4, "model": 2}
    # The rows split over the data axis; the model axis holds copies.
    assert grid_sharding(two_d, 2).ranges(8) == [
        (0, 2), (0, 2), (2, 4), (2, 4), (4, 6), (4, 6), (6, 8), (6, 8)]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()


@pytest.mark.parametrize("cards", [1, 2])
def test_default_mesh_on_the_models_device(cards, monkeypatch):
    """``make_mesh()`` takes every visible card, and refuses, as a sweep
    would, a default that holds another card than ``config.device``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(st.config, "device", torch.device("cuda:0"))
    if cards == 1:
        assert list(make_mesh().devices.flat) == [torch.device("cuda:0")]
    else:
        with pytest.raises(ValueError, match="config.device"):
            make_mesh()
    assert make_mesh(devices=["cuda:0"] * 2).size == 2


def test_shard_points(mesh):
    pts = np.arange(64, dtype=np.float64).reshape(32, 2)
    sharded = shard_points(pts, mesh)
    assert sharded.sharding == grid_sharding(mesh, 2)
    assert [s.shape for s in sharded.shards] == [(4, 2)] * 8
    assert_allclose(sharded.numpy(), pts)
    # The JAX package places the same rows on its devices.
    jax_sharded = sl.parallel.shard_points(pts, jax_make_mesh(8))
    for shard, (lo, hi) in zip(jax_sharded.addressable_shards,
                               sharded.ranges):
        assert shard.index[0] == slice(lo, hi)


def test_sharded_decrease_check(mesh):
    """The decrease verdicts and the values over the mesh, each shard on
    its entry, equal the whole grid's; a replicated sharding gives every
    entry every row."""
    from safe_learning_tpu_torch.lyapunov import (_negative_batch,
                                                  _values_batch)

    with working_dtype("float64"):
        lyap = cases.linear_instance()
        negative, values = distributed.sharded_decrease_check(lyap, mesh)
        points = lyap._device_points()
        want = _negative_batch(
            lyap.policy, lyap.dynamics, lyap.lyapunov_function,
            lyap._lipschitz_lyapunov, lyap._lipschitz_dynamics, lyap.tau,
            points)[0]
        assert len(negative.local()) == 8
        assert_array_equal(distributed.fetch_global(negative),
                           to_numpy(want))
        assert_array_equal(distributed.fetch_global(values), to_numpy(
            _values_batch(lyap.lyapunov_function, points)))
        assert replicated_sharding(mesh).ranges(5) == [(0, 5)] * 8


def test_sharded_update_matches_single_device(mesh):
    """The sharded fused sweep equals the sweep without a mesh and the
    JAX package's sharded sweep."""
    with working_dtype("float64"):
        single = cases.linear_instance()
        single.update_safe_set(batch_size=111)
        sharded = cases.linear_instance()
        safe, c_max = sharded_safe_set_update(sharded, mesh)
        assert_array_equal(safe, single.safe_set)
        assert c_max == single.c_max
        assert single.safe_set.sum() > 1
        jlyap = _jax_linear()
        jsafe, jc_max = jax_sharded_update(jlyap, jax_make_mesh(8))
        assert_array_equal(safe, jsafe)
        assert_allclose(c_max, jc_max, rtol=1e-15)


def test_fused_path_matches_batched():
    with working_dtype("float64"):
        lyap_a = cases.linear_instance()
        lyap_a.update_safe_set()
        lyap_b = cases.linear_instance()
        lyap_b.update_safe_set(batch_size=97)
        assert_array_equal(lyap_a.safe_set, lyap_b.safe_set)
        assert lyap_a.c_max == lyap_b.c_max


def test_sharded_gp_predict(mesh):
    """GP posterior predict over sharded query points, against the whole
    batch's and the JAX package's, at the JAX test's 1e-10 (on the CPU
    the plain version's products and column sums round in an order that
    follows the batch's width)."""
    with working_dtype("float64"):
        rng = np.random.default_rng(0)
        x = rng.uniform(-1, 1, size=(16, 2))
        y = np.sin(x[:, :1])
        jgp = sl.GaussianProcess(sl.RBF(1.0, 0.5, input_dim=2), x, y, 1e-3)
        gp = port_gp(jgp)
        q = rng.uniform(-1, 1, size=(64, 2))
        mean_ref, var_ref = map(to_numpy, gp.predict(torch.as_tensor(q)))
        parts = [gp.predict(s) for s in shard_points(q, mesh).shards]
        assert_allclose(np.concatenate([to_numpy(m) for m, _ in parts]),
                        mean_ref, atol=1e-10)
        assert_allclose(np.concatenate([to_numpy(v) for _, v in parts]),
                        var_ref, atol=1e-10)
        jmean, jvar = map(np.asarray, jgp.predict(q))
        assert_allclose(mean_ref, jmean, atol=1e-10)
        assert_allclose(var_ref, jvar, atol=1e-10)


def test_sharded_sweep_keeps_data_distributed(mesh):
    """The per-point outputs stay on their shards, one per entry; only the
    scalars are combined."""
    with working_dtype("float64"):
        lyap = cases.linear_instance()
        grid = lyap.discretization
        points = distributed.global_grid_points(grid, mesh)
        exempt = distributed.put_global(np.asarray(lyap.initial_safe_set),
                                        grid_sharding(mesh, 1))
        assert len(points.local()) == 8
        safe, c_max, values, any_safe = _sharded_fused_update(
            lyap.policy, lyap.dynamics, lyap.lyapunov_function,
            lyap._lipschitz_lyapunov, lyap._lipschitz_dynamics, lyap.tau,
            points, exempt)
        for arr in (safe, values):
            assert len(arr.shards) == 8
            assert [s.shape[0] for s in arr.shards] == [128] * 8
            assert not arr.sharding.is_fully_replicated
            assert all(s.device == d for s, d in zip(arr.shards,
                                                     mesh.devices.flat))
        assert isinstance(c_max, float) and any_safe
        single = cases.linear_instance()
        single.update_safe_set()
        assert_array_equal(safe.numpy() | np.asarray(lyap.initial_safe_set),
                           single.safe_set)
        assert c_max == single.c_max


def test_sharded_adaptive_update_matches_single_device(mesh):
    """The adaptive sweep (coarse batch and refinement chunks split over
    the mesh) equals the sweep without a mesh and the JAX package's."""
    with working_dtype("float64"):
        single = cases.adaptive_instance()
        single.update_safe_set(max_refinement=4)
        plain = cases.adaptive_instance()
        plain.adaptive = False
        plain.update_safe_set()
        assert single.safe_set.sum() > plain.safe_set.sum()
        sharded = cases.adaptive_instance()
        safe, c_max = sharded_safe_set_update(sharded, mesh,
                                              max_refinement=4)
        assert_array_equal(safe, single.safe_set)
        assert_array_equal(sharded._refinement, single._refinement)
        assert c_max == single.c_max
        jlyap = _jax_adaptive()
        jsafe, jc_max = jax_sharded_update(jlyap, jax_make_mesh(8),
                                           max_refinement=4)
        assert_array_equal(safe, jsafe)
        assert_array_equal(sharded._refinement, jlyap._refinement)
        assert c_max == jc_max


@pytest.mark.parametrize("entries", [8, 6])
def test_sharded_adaptive_batched_non_divisible(entries):
    """Batches and meshes that do not divide the grid (1089 states,
    batch 100; 8 and 6 entries) still shard: the batch rounds up to a
    multiple of lcm(256, mesh size)."""
    with working_dtype("float64"):
        mesh = make_mesh(devices=["cpu"] * entries)
        single = cases.adaptive_instance()
        single.update_safe_set(max_refinement=4, batch_size=100)
        sharded = cases.adaptive_instance()
        safe, c_max = sharded_safe_set_update(sharded, mesh,
                                              max_refinement=4,
                                              batch_size=100)
        assert_array_equal(safe, single.safe_set)
        assert_array_equal(sharded._refinement, single._refinement)
        assert c_max == single.c_max
        assert single.last_sweep_counts["coarse_batches"] == 11
        assert sharded.last_sweep_counts["coarse_batches"] == (
            5 if entries == 8 else 2)
        jlyap = _jax_adaptive()
        jsafe, jc_max = jax_sharded_update(jlyap, jax_make_mesh(entries),
                                           max_refinement=4, batch_size=100)
        assert_array_equal(safe, jsafe)
        assert c_max == jc_max


def test_sharded_adaptive_non_power_of_two_mesh():
    """A 6-entry mesh (not a divisor of 256)."""
    with working_dtype("float64"):
        mesh6 = make_mesh(devices=["cpu"] * 6)
        single = cases.adaptive_instance()
        single.update_safe_set(max_refinement=4, batch_size=100)
        sharded = cases.adaptive_instance()
        safe, c_max = sharded_safe_set_update(sharded, mesh6,
                                              max_refinement=4,
                                              batch_size=100)
        assert_array_equal(safe, single.safe_set)
        assert c_max == single.c_max


@pytest.mark.parametrize("entries", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_mesh_sizes_bit_equal(entries, dtype):
    """Over 1 to 8 entries each sweep equals the sweep without a mesh bit
    for bit: fused (with per-point margins), sorted and adaptive, streamed
    with its tie at ``v_bad``, extended and hybrid."""
    with working_dtype(dtype):
        mesh = make_mesh(devices=["cpu"] * entries)
        for name, case in cases.CASES.items():
            assert case(mesh) == case(None), name


def test_tie_instance():
    """The streamed case's tie: ``v_bad = 1/64`` first at flat index 161,
    and the three states holding that value below it certified, in both
    dtypes."""
    for dtype in ("float32", "float64"):
        with working_dtype(dtype):
            assert cases.case_streamed(None)["bad"] == [1 / 64, 161]
            lyap = cases.tie_instance()
            old = st.config.fused_sweep_limit
            st.config.fused_sweep_limit = 8
            try:
                lyap.update_safe_set(batch_size=8)
            finally:
                st.config.fused_sweep_limit = old
            assert lyap.safe_set[[127, 143, 145]].all()
            assert not lyap.safe_set[161]
            assert lyap.c_max == 1 / 64


def test_mesh_refused_off_the_models_device():
    with working_dtype("float64"):
        lyap = cases.linear_instance()
        lyap.mesh = Mesh(np.array(["meta"] * 2, dtype=object))
        with pytest.raises(ValueError, match="config.device"):
            lyap.update_safe_set()
        with pytest.raises(TypeError, match="parallel.Mesh"):
            lyap.mesh = ["cpu"]


def _run_ranks(world, extra=()):
    address = "localhost:{}".format(distributed.free_port())
    script = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "_torch_parallel_worker.py")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    runs, _ = distributed.run_ranks(
        [[sys.executable, script, "--address", address, "--world",
          str(world), "--rank", str(r)] + list(extra)
         for r in range(world)],
        RANK_TIMEOUT_S, env=env)
    for code, _, err in runs:
        assert code == 0, err[-3000:]
    return [json.loads(out.strip().splitlines()[-1]) for _, out, _ in runs]


@pytest.mark.parametrize("world", [2, 3, 4])
def test_gloo_ranks_bit_equal(world, tmp_path):
    """Each case over 2, 3 and 4 gloo ranks equals the sweep without a
    mesh, on every rank; the coordinator's data reaches every rank. The
    dryrun's training step over the ranks' ``(data, model)`` layout (the
    model axis alone at 2, the data axis alone at 3, both at 4) is within
    ``TRAIN_RTOL`` of the port's single-process step and of the JAX
    script's."""
    jnet, weights = _jax_network()
    net_file = tmp_path / "net.json"
    net_file.write_text(json.dumps(weights))
    results = _run_ranks(world, ["--net", str(net_file)])
    with working_dtype("float64"):
        ref = {name: json.loads(json.dumps(case(None)))
               for name, case in cases.CASES.items()}
        points = cases.digest(
            cases.linear_instance().discretization.all_points)
    with working_dtype("float32"):
        train_refs = [_port_step(weights), _jax_train_step(jnet)]
    layouts = {2: [[0, 1], [None, 2]], 3: [[None, 3], [0, 1]],
               4: [[None, 2], [None, 2]]}[world]
    rows = []
    for rank, res in enumerate(results):
        for name in cases.CASES:
            assert res[name] == ref[name], (world, rank, name)
        assert res["broadcast"] == [cases.digest(
            np.random.default_rng(5).normal(size=(3, 3))), 7]
        assert res["points"] == points
        rows += res["local_rows"]
        train = res["train"]
        for (idx, size), want in zip(train["layout"], layouts):
            assert size == want[1] and (want[0] is None or idx == want[0])
        for want in train_refs:
            assert dryrun.step_departure(train, want) <= dryrun.TRAIN_RTOL
    # Each rank made only its own rows of the grid.
    assert rows == [list(r) for r in split_rows(1024, world)]


def test_dryrun_module():
    """``python -m safe_learning_tpu_torch.parallel.dryrun --nprocs 2`` on
    the CPU reaches its OK line."""
    out = subprocess.run(
        [sys.executable, "-m", "safe_learning_tpu_torch.parallel.dryrun",
         "--nprocs", "2", "--device", "cpu", "--timeout",
         str(RANK_TIMEOUT_S)],
        capture_output=True, text=True, cwd=ROOT, timeout=RANK_TIMEOUT_S + 60,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "multiprocess dryrun OK: 2 ranks" in out.stdout


def _jax_train_step(jnet, gamma=0.98, lr=1e-3):
    """Phase 5 of ``scripts/multiprocess_dryrun.py:226-271`` on the JAX
    package, single-process, as ``dryrun.step_departure`` reads a step:
    the loss and the step's ``-lr * gradient`` of the network parameters
    (flattened in ``parameters_dict``'s sorted order) and of the
    table."""
    grid = sl.GridWorld([[-0.5, 0.5], [-1.0, 1.0]], [8, 16])
    pend = sl.InvertedPendulum(mass=0.25, length=0.5, friction=0.1,
                               dt=0.01)
    a, b = pend.linearize()
    from safe_learning_tpu.utils import dlqr

    kmat, _ = dlqr(a, b, np.eye(2), np.eye(1))
    policy = sl.LinearSystem(-kmat)
    rng = np.random.default_rng(0)
    x_train = np.column_stack([
        rng.uniform(-0.5, 0.5, 16), rng.uniform(-1.0, 1.0, 16),
        rng.uniform(-0.8, 0.8, 16)])
    y_train = np.asarray(pend(jnp.asarray(x_train[:, :2]),
                              jnp.asarray(x_train[:, 2:])))
    gp_dyn = sl.GaussianProcess(
        sl.RBF(0.01, [0.3, 0.3, 0.5], input_dim=3), x_train, y_train,
        noise_variance=1e-6, mean_function=sl.LinearSystem([a, b]))
    value_fn = sl.Triangulation(grid, np.zeros(grid.nindex), project=True)
    states = jnp.asarray(grid.all_points[:16])

    def loss_fn(net_params, table):
        net = jnet.with_parameters(net_params)
        vf = value_fn.replace(parameters=table)
        actions = policy(states)
        mean, err = gp_dyn(states, actions)
        decrease = (net(mean).reshape(-1) - net(states).reshape(-1)
                    + jnp.sum(err, axis=1))
        lyap_loss = jnp.mean(jax.nn.relu(decrease + 1e-3))
        xu = jnp.concatenate([states, actions], axis=1)
        r = (-(xu[:, :1] ** 2 + 0.1 * xu[:, 2:] ** 2)).reshape(-1)
        target = r + gamma * vf(mean).reshape(-1)
        bellman = jnp.mean((vf(states).reshape(-1)
                            - jax.lax.stop_gradient(target)) ** 2)
        return lyap_loss + bellman

    loss, (g_net, g_table) = jax.jit(jax.value_and_grad(
        loss_fn, argnums=(0, 1)))(jnet.parameters_dict, value_fn.parameters)
    net = np.concatenate([-lr * np.asarray(g).reshape(-1)
                          for name in sorted(g_net) for g in g_net[name]
                          if g is not None])
    return {"loss": float(loss), "net": net,
            "table": -lr * np.asarray(g_table)}


def _jax_network():
    """The JAX script's network (``PRNGKey(0)``) and its weights as the
    port's ``convert.lyapunov_network`` takes them."""
    jnet = sl.LyapunovNetwork(2, [4, 4], ["tanh", "tanh"],
                              key=jax.random.PRNGKey(0))
    return jnet, dict(
        eps=float(jnet.eps),
        posdef_weights=[np.asarray(w).tolist() for w in jnet.posdef_weights],
        extra_weights=[None if w is None else np.asarray(w).tolist()
                       for w in jnet.extra_weights])


def _port_step(weights, **layout):
    """The port's training step on the given network weights, in the
    form of :func:`_jax_train_step`."""
    net = convert.lyapunov_network(2, [4, 4], ["tanh", "tanh"], **{
        k: ([None if w is None else np.asarray(w) for w in v]
            if k != "eps" else v) for k, v in weights.items()})
    loss, net_update, table_update = dryrun.train_step(
        dryrun.training_instance(net), **layout)
    return {"loss": loss, "net": to_numpy(net_update),
            "table": to_numpy(table_update).reshape(-1)}


def test_training_step_against_jax():
    """The port's training step, fed the JAX network's weights, against
    the JAX script's single-process step in float32: the loss and both
    updates within ``TRAIN_RTOL`` of their own scale (the dryrun holds its
    ranks' steps to the port's single-process step)."""
    with working_dtype("float32"):
        jnet, weights = _jax_network()
        want = _jax_train_step(jnet)
        got = _port_step(weights)
        assert np.abs(want["table"]).max() > 0
        assert np.abs(want["net"]).max() > 0
        assert dryrun.step_departure(got, want) <= dryrun.TRAIN_RTOL
