"""The port's checkpoints against the JAX package's, both ways.

A checkpoint written by the JAX package (``safe_learning_tpu/
checkpoints.py``) restores in the port, and one written by the port
restores in the JAX package: ``lyapunov_state`` with a GP, a GP state with
a composite kernel, a stacked-GP state, ``policy_iteration_state`` and a
``LyapunovNetwork``'s ``parameters_dict``. The two files of one state have
the same keys, dtypes and shapes, and each restored leaf equals the
written one bit for bit (float64). Restored GPs predict as the saved
ones to 1e-10.
"""

import jax
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

import safe_learning_tpu as sl
import safe_learning_tpu_torch as st
from safe_learning_tpu import checkpoints as jck
from safe_learning_tpu_torch import checkpoints as pck

from _torch_parity import (port_gp, port_kernel, port_stacked_gp, to_numpy,
                           working_dtype)

PREDICT_ATOL = 1e-10


@pytest.fixture(autouse=True)
def float64():
    with working_dtype("float64"):
        yield


def data(seed, n=20):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, size=(n, 2))
    return x, np.column_stack([0.5 * x[:, 0] + 0.3 * x[:, 1],
                               np.sin(2 * x[:, 0])])


def lyapunov_pair(seed=0):
    """``tests/test_checkpoints.py``'s instance in both packages: an RBF
    GP, a projected ``Triangulation`` candidate, an initial set."""
    x, y = data(seed)
    jgp = sl.GaussianProcess(sl.RBF(1.0, [0.7, 0.7], input_dim=2), x,
                             y[:, :1], 1e-4)
    pairs = []
    for pkg, gp in ((sl, jgp), (st, port_gp(jgp))):
        grid = pkg.GridWorld([[-1, 1]], 11)
        v = pkg.Triangulation(grid, np.linspace(-1, 1, 11) ** 2,
                              project=True)
        if pkg is sl:
            policy = sl.LambdaFunction(lambda s: -0.2 * s)
        else:
            policy = st.LambdaFunction(lambda s: -0.2 * s)
        lyap = pkg.Lyapunov(grid, v, gp, 1.0, 1.0, 1e-3, policy,
                            initial_set=[4, 5, 6])
        lyap.update_safe_set()
        pairs.append(lyap)
    return pairs


def files_agree(jax_path, port_path):
    """The two files hold the same keys, dtypes and shapes."""
    with np.load(jax_path) as a, np.load(port_path) as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            assert a[key].dtype == b[key].dtype, key
            assert a[key].shape == b[key].shape, key


def leaves_equal(path, entries):
    """Every leaf of ``entries`` (a flattened state) equals the file's
    array under its key, bit for bit."""
    with np.load(path) as saved:
        assert sorted(saved.files) == sorted(entries)
        for key, value in entries.items():
            assert_array_equal(np.asarray(value), saved[key], err_msg=key)
            assert np.asarray(value).dtype == saved[key].dtype, key


def test_lyapunov_state_both_ways(tmp_path):
    jlyap, plyap = lyapunov_pair()
    jpath = jck.save_checkpoint(str(tmp_path / "jax"),
                                jck.lyapunov_state(jlyap))
    ppath = pck.save_checkpoint(str(tmp_path / "port"),
                                pck.lyapunov_state(plyap))
    files_agree(jpath, ppath)

    # JAX -> port, onto a port instance with other data and state.
    _, other = lyapunov_pair(seed=1)
    other.safe_set[:] = False
    other.c_max = 0.0
    restored = pck.restore_lyapunov_state(
        other, pck.restore_checkpoint(jpath, pck.lyapunov_state(other)))
    leaves_equal(jpath, pck._flatten_with_paths(pck.lyapunov_state(
        restored)))
    q = np.array([[0.2, -0.1], [-0.6, 0.4]])
    for got, want in zip(restored.dynamics(q), jlyap.dynamics(q)):
        assert_allclose(to_numpy(got), np.asarray(want), rtol=0,
                        atol=PREDICT_ATOL)

    # port -> JAX.
    jother, _ = lyapunov_pair(seed=1)
    jstate = jck.restore_checkpoint(ppath, jck.lyapunov_state(jother))
    jrestored = jck.restore_lyapunov_state(jother, jstate)
    leaves_equal(ppath, jck._flatten_with_paths(jck.lyapunov_state(
        jrestored))[0])
    for got, want in zip(jrestored.dynamics(q), plyap.dynamics(q)):
        assert_allclose(np.asarray(got), to_numpy(want), rtol=0,
                        atol=PREDICT_ATOL)


def composite_kernel(pkg):
    """``Matern32 x Linear`` over (x, u), the 1-D example's kernel."""
    return (pkg.Matern32(lengthscales=[0.8, 1.3], input_dim=2)
            * pkg.LinearKernel(variances=[0.2, 1.0], input_dim=2))


def test_composite_gp_state_both_ways(tmp_path):
    x, y = data(2)
    jgp = sl.GaussianProcess(composite_kernel(sl), x, y[:, :1], 1e-3,
                             beta=3.0, scale=2.0,
                             mean_function=sl.LinearSystem([[1.0, 0.1]]))
    pgp = port_gp(jgp)
    jpath = jck.save_checkpoint(str(tmp_path / "jax"), jck._gp_state(jgp))
    ppath = pck.save_checkpoint(str(tmp_path / "port"), pck._gp_state(pgp))
    files_agree(jpath, ppath)

    # Onto GPs with other hyperparameters and no data.
    fresh = st.GaussianProcess(
        st.Matern32(lengthscales=[1.0, 1.0], input_dim=2)
        * st.LinearKernel(variances=[1.0, 1.0], input_dim=2),
        np.empty((0, 2)), np.empty((0, 1)), 0.1, capacity=32,
        mean_function=st.LinearSystem([[1.0, 0.1]]))
    restored = pck._restore_gp(fresh, pck.restore_checkpoint(
        jpath, pck._gp_state(fresh)))
    leaves_equal(jpath, pck._flatten_with_paths(pck._gp_state(restored)))
    assert restored.beta == 3.0 and restored.scale == 2.0
    q = np.array([[0.3, -0.2], [-0.7, 0.5]])
    for got, want in zip(restored(q), jgp(q)):
        assert_allclose(to_numpy(got), np.asarray(want), rtol=0,
                        atol=PREDICT_ATOL)

    jfresh = sl.GaussianProcess(
        sl.Matern32(lengthscales=[1.0, 1.0], input_dim=2)
        * sl.LinearKernel(variances=[1.0, 1.0], input_dim=2),
        np.empty((0, 2)), np.empty((0, 1)), 0.1, capacity=32,
        mean_function=sl.LinearSystem([[1.0, 0.1]]))
    jrestored = jck._restore_gp(jfresh, jck.restore_checkpoint(
        ppath, jck._gp_state(jfresh)))
    leaves_equal(ppath, jck._flatten_with_paths(jck._gp_state(
        jrestored))[0])


def stacked_kernels(pkg):
    return [pkg.RBF(1.0, [0.5, 0.9], input_dim=2),
            pkg.LinearKernel(variances=[0.2, 1.0], input_dim=2)
            + pkg.ActiveDims(pkg.Matern32(lengthscales=1.0, input_dim=1),
                             dims=[0])]


def test_stacked_gp_state_both_ways(tmp_path):
    x, y = data(3)
    jgp = sl.StackedGaussianProcess(stacked_kernels(sl), x, y,
                                    noise_variances=[1e-4, 1e-3],
                                    betas=[2.0, 2.5])
    pgp = port_stacked_gp(jgp)
    jpath = jck.save_checkpoint(str(tmp_path / "jax"),
                                jck._stacked_gp_state(jgp))
    ppath = pck.save_checkpoint(str(tmp_path / "port"),
                                pck._stacked_gp_state(pgp))
    files_agree(jpath, ppath)

    fresh = port_stacked_gp(sl.StackedGaussianProcess(
        stacked_kernels(sl), x[:3], y[:3], noise_variances=0.1))
    restored = pck._restore_stacked_gp(fresh, pck.restore_checkpoint(
        jpath, pck._stacked_gp_state(fresh)))
    leaves_equal(jpath, pck._flatten_with_paths(
        pck._stacked_gp_state(restored)))
    q = np.array([[0.3, -0.2], [-0.7, 0.5]])
    for got, want in zip(restored(q), jgp(q)):
        assert_allclose(to_numpy(got), np.asarray(want), rtol=0,
                        atol=PREDICT_ATOL)

    jfresh = sl.StackedGaussianProcess(stacked_kernels(sl), x[:3], y[:3],
                                       noise_variances=0.1)
    jrestored = jck._restore_stacked_gp(jfresh, jck.restore_checkpoint(
        ppath, jck._stacked_gp_state(jfresh)))
    leaves_equal(ppath, jck._flatten_with_paths(
        jck._stacked_gp_state(jrestored))[0])


def policy_iteration(pkg, gp, seed):
    grid = pkg.GridWorld([[-1, 1]], 11)
    rng = np.random.default_rng(seed)
    vf = pkg.Triangulation(grid, rng.normal(size=11), project=True)
    policy = pkg.Saturation(pkg.Triangulation(grid, rng.normal(size=11),
                                              project=True), -1.0, 1.0)
    return pkg.PolicyIteration(policy, gp, pkg.QuadraticFunction(np.eye(2)),
                               vf)


def test_policy_iteration_state_both_ways(tmp_path):
    x, y = data(4)
    jgp = sl.GaussianProcess(composite_kernel(sl), x, y[:, :1], 1e-3,
                             mean_function=sl.LinearSystem([[1.0, 0.1]]))
    jrl = policy_iteration(sl, jgp, 0)
    prl = policy_iteration(st, port_gp(jgp), 0)
    jpath = jck.save_checkpoint(str(tmp_path / "jax"),
                                jck.policy_iteration_state(jrl))
    ppath = pck.save_checkpoint(str(tmp_path / "port"),
                                pck.policy_iteration_state(prl))
    files_agree(jpath, ppath)

    other = policy_iteration(st, port_gp(sl.GaussianProcess(
        composite_kernel(sl), x[:4], y[:4, :1], 1e-2,
        mean_function=sl.LinearSystem([[1.0, 0.1]]))), 1)
    restored = pck.restore_policy_iteration_state(other, pck.restore_checkpoint(
        jpath, pck.policy_iteration_state(other)))
    leaves_equal(jpath, pck._flatten_with_paths(
        pck.policy_iteration_state(restored)))
    states = np.linspace(-1, 1, 7)[:, None]
    assert_allclose(to_numpy(restored.policy(states)),
                    np.asarray(jrl.policy(states)), rtol=0, atol=1e-15)

    jother = policy_iteration(sl, sl.GaussianProcess(
        composite_kernel(sl), x[:4], y[:4, :1], 1e-2,
        mean_function=sl.LinearSystem([[1.0, 0.1]])), 1)
    jrestored = jck.restore_policy_iteration_state(
        jother, jck.restore_checkpoint(ppath,
                                       jck.policy_iteration_state(jother)))
    leaves_equal(ppath, jck._flatten_with_paths(
        jck.policy_iteration_state(jrestored))[0])


def test_lyapunov_network_parameters_both_ways(tmp_path):
    """The checkpoint ``examples/lyapunov_function_learning.py:204-207``
    writes: a ``LyapunovNetwork``'s parameters, with ``None`` entries
    where a layer does not grow."""
    jnet = sl.LyapunovNetwork(2, [4, 4, 6], ["tanh", "tanh", "tanh"],
                              eps=1e-8, key=jax.random.PRNGKey(0))
    pnet = st.LyapunovNetwork(2, [4, 4, 6], ["tanh", "tanh", "tanh"],
                              eps=1e-8,
                              generator=torch.Generator().manual_seed(0))
    jpath = jck.save_checkpoint(str(tmp_path / "jax"), jnet.parameters_dict)
    ppath = pck.save_checkpoint(str(tmp_path / "port"),
                                pnet.parameters_dict)
    files_agree(jpath, ppath)

    restored = pnet.with_parameters(pck.restore_checkpoint(
        jpath, pnet.parameters_dict))
    leaves_equal(jpath, pck._flatten_with_paths(restored.parameters_dict))
    points = np.random.default_rng(5).uniform(-1, 1, (9, 2))
    assert_allclose(to_numpy(restored(points)), np.asarray(jnet(points)),
                    rtol=1e-13)

    jrestored = jnet.with_parameters(jck.restore_checkpoint(
        ppath, jnet.parameters_dict))
    leaves_equal(ppath, jck._flatten_with_paths(
        jrestored.parameters_dict)[0])
    assert_allclose(np.asarray(jrestored(points)), to_numpy(pnet(points)),
                    rtol=1e-13)


def test_orbax_raises_naming_the_item(tmp_path):
    with pytest.raises(NotImplementedError, match="item 20"):
        pck.save_checkpoint(str(tmp_path / "ckpt"), {"a": np.ones(2)},
                            use_orbax=True)
    (tmp_path / "orbax_dir").mkdir()
    with pytest.raises(NotImplementedError, match="item 20"):
        pck.restore_checkpoint(str(tmp_path / "orbax_dir"),
                               {"a": np.ones(2)})


def test_pytree_round_trip_keeps_types(tmp_path):
    """``tests/test_checkpoints.py:31-36`` in the port: tensors come back
    as tensors of the target's dtype, arrays as arrays, ``None`` stays."""
    state = {"a": np.arange(5.0), "b": {"c": torch.ones((2, 2))},
             "n": None, "t": (torch.zeros(3, dtype=torch.float32), 2.5)}
    path = pck.save_checkpoint(str(tmp_path / "ckpt"), state)
    with np.load(path) as saved:
        assert sorted(saved.files) == ["['a']", "['b']/['c']",
                                       "['t']/[0]", "['t']/[1]"]
    restored = pck.restore_checkpoint(path, state)
    assert_array_equal(restored["a"], state["a"])
    assert torch.equal(restored["b"]["c"], state["b"]["c"])
    assert restored["n"] is None and isinstance(restored["t"], tuple)
    assert restored["t"][0].dtype == torch.float32
    assert float(restored["t"][1]) == 2.5
