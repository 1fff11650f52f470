"""The port's neural networks against the JAX package's.

Each JAX network is carried across with ``convert`` (its parameters as
numpy arrays) and both are evaluated on the same numpy inputs. Tolerance:
float64 to 1e-10 relative unless a case says otherwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import safe_learning_tpu as sl
import safe_learning_tpu_torch as st
from safe_learning_tpu_torch import convert

from _torch_parity import to_numpy, working_dtype

RTOL = 1e-10

NETWORKS = [
    ([2, 32, 32, 1], ["relu", "relu", "tanh"], 1.0),
    ([3, 8, 2], ["tanh", None], 2.5),
    ([2, 6, 5, 3], ["softplus", "swish", "sigmoid"], 0.7),
]


def port_network(net):
    """The port's copy of a JAX ``NeuralNetwork``."""
    return convert.neural_network(
        net.layers, net.nonlinearities, net.output_scale,
        [np.asarray(w) for w in net.weights],
        [None if b is None else np.asarray(b) for b in net.biases],
        use_bias=net.use_bias)


def jax_network(layers, nonlinearities, scale, seed):
    """A JAX network with nonzero hidden biases (so that they matter)."""
    net = sl.NeuralNetwork(layers, nonlinearities, output_scale=scale,
                           key=jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    biases = tuple(None if b is None else jnp.asarray(
        rng.normal(scale=0.3, size=b.shape)) for b in net.biases)
    return net.with_parameters({"biases": biases})


@pytest.mark.parametrize("spec", NETWORKS)
def test_forward_and_lipschitz_match_jax(spec):
    layers, nonlin, scale = spec
    rng = np.random.default_rng(1)
    x = rng.normal(size=(64, layers[0])) * 3.0
    with working_dtype("float64"):
        jnet = jax_network(layers, nonlin, scale, seed=len(layers))
        net = port_network(jnet)
        assert_allclose(to_numpy(net(x)), np.asarray(jnet(x)), rtol=RTOL,
                        atol=1e-14)
        assert_allclose(float(net.lipschitz()), float(jnet.lipschitz()),
                        rtol=RTOL)
    assert net.biases[-1] is None and jnet.biases[-1] is None
    assert (net.input_dim, net.output_dim) == (layers[0], layers[-1])


@pytest.mark.parametrize("spec", NETWORKS[:2])
def test_lipschitz_gradient_matches_jax(spec):
    """The stop-gradient SVD trick: autograd of ``lipschitz()`` with
    respect to every weight against ``jax.grad``."""
    layers, nonlin, scale = spec
    with working_dtype("float64"):
        jnet = jax_network(layers, nonlin, scale, seed=3)
        net = port_network(jnet)
        jgrads = jax.grad(lambda w: jnet.with_parameters(
            {"weights": w}).lipschitz())(jnet.weights)
        weights = tuple(w.clone().requires_grad_(True) for w in net.weights)
        net.with_parameters({"weights": weights}).lipschitz().backward()
    for w, jg in zip(weights, jgrads):
        assert_allclose(w.grad.numpy(), np.asarray(jg), rtol=RTOL,
                        atol=1e-13)


def test_output_gradient_wrt_weights_matches_jax():
    """Autograd of a loss through the forward pass against ``jax.grad``,
    for weights and biases (the output layer's ``None`` stays out)."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(20, 2))
    with working_dtype("float64"):
        jnet = jax_network([2, 16, 16, 1], ["relu", "relu", "tanh"], 1.0, 4)
        net = port_network(jnet)
        jg = jax.grad(lambda p: jnp.sum(jnp.sin(jnet.with_parameters(p)(
            x)))) (jnet.parameters_dict)
        params = {k: tuple(None if t is None else t.clone().requires_grad_(
            True) for t in v) for k, v in net.parameters_dict.items()}
        torch.sin(net.with_parameters(params)(x)).sum().backward()
    for name in ("weights", "biases"):
        for got, want in zip(params[name], jg[name]):
            if got is None:
                assert want is None
                continue
            assert_allclose(got.grad.numpy(), np.asarray(want), rtol=RTOL,
                            atol=1e-13)


def test_float32_forward_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(50, 2)).astype(np.float32)
    with working_dtype("float32"):
        jnet = jax_network([2, 32, 32, 1], ["relu", "relu", "tanh"], 1.0, 6)
        net = port_network(jnet)
        assert net.weights[0].dtype == torch.float32
        assert_allclose(to_numpy(net(x)), np.asarray(jnet(x)), rtol=1e-5,
                        atol=1e-6)


def test_xavier_initialisation():
    """Explicit generators give reproducible weights within the Xavier
    bound ``sqrt(6 / (fan_in + fan_out))``; biases start at zero and the
    output layer has none."""
    with working_dtype("float64"):
        nets = [st.NeuralNetwork([2, 32, 32, 1], ["relu", "relu", "tanh"],
                                 generator=torch.Generator().manual_seed(7))
                for _ in range(2)]
        other = st.NeuralNetwork([2, 32, 32, 1], ["relu", "relu", "tanh"],
                                 generator=torch.Generator().manual_seed(8))
    for w0, w1, w2 in zip(nets[0].weights, nets[1].weights, other.weights):
        bound = np.sqrt(6.0 / sum(w0.shape))
        assert torch.equal(w0, w1) and not torch.equal(w0, w2)
        assert float(w0.abs().max()) <= bound
        assert float(w0.abs().max()) > 0.5 * bound
    assert [b is None for b in nets[0].biases] == [False, False, True]
    assert not nets[0].biases[0].any()
    with pytest.raises(ValueError, match="one nonlinearity"):
        st.NeuralNetwork([2, 4, 1], ["relu"])
    with pytest.raises(ValueError, match="unknown activation"):
        st.NeuralNetwork([2, 4, 1], ["relu", "cube"])(np.zeros((1, 2)))


@pytest.mark.parametrize("layer_dims", [[4, 4, 4], [4, 8, 8]])
def test_lyapunov_network_matches_jax(layer_dims):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(40, 2))
    with working_dtype("float64"):
        jnet = sl.LyapunovNetwork(2, layer_dims, ["tanh"] * len(layer_dims),
                                  key=jax.random.PRNGKey(1))
        net = convert.lyapunov_network(
            2, layer_dims, ["tanh"] * len(layer_dims), jnet.eps,
            [np.asarray(w) for w in jnet.posdef_weights],
            [None if w is None else np.asarray(w)
             for w in jnet.extra_weights])
        assert_allclose(to_numpy(net(x)), np.asarray(jnet(x)), rtol=RTOL)
        assert_allclose(to_numpy(net.gradient(x)),
                        np.asarray(jnet.gradient(x)), rtol=RTOL, atol=1e-14)
        assert float(net(np.zeros((1, 2)))[0, 0]) < 1e-10
    with pytest.raises(ValueError):
        st.LyapunovNetwork(3, [2, 4], ["tanh", "tanh"])
    with pytest.raises(ValueError):
        st.LyapunovNetwork(2, [4, 2], ["tanh", "tanh"])


def test_rbf_network_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.uniform(-1.2, 1.2, size=(30, 2))
    with working_dtype("float64"):
        jnet = sl.RBFNetwork([[-1, 1], [-1, 1]], [5, 4],
                             key=jax.random.PRNGKey(2))
        net = convert.rbf_network([[-1, 1], [-1, 1]], [5, 4], jnet.variance,
                                  np.asarray(jnet.weights))
        assert net.variance == jnet.variance
        assert_allclose(to_numpy(net(x)), np.asarray(jnet(x)), rtol=RTOL,
                        atol=1e-13)
        doubled = net.with_parameters({"weights": 2.0 * net.weights})
        assert_allclose(to_numpy(doubled(x)), 2.0 * to_numpy(net(x)),
                        rtol=1e-14)


def test_lift64_keeps_the_missing_output_bias():
    """``oracle.lift64`` widens a float32 network exactly and keeps the
    output layer's ``None`` bias."""
    with working_dtype("float32"):
        net = st.NeuralNetwork([2, 8, 1], ["tanh", "tanh"],
                               generator=torch.Generator().manual_seed(0))
        x = np.random.default_rng(0).normal(size=(10, 2)).astype(np.float32)
        lifted = st.oracle.lift64(net)
    assert lifted.biases[1] is None
    for w, w64 in zip(net.weights, lifted.weights):
        assert w64.dtype == torch.float64
        assert torch.equal(w64, w.double())
    with working_dtype("float64"):
        assert_allclose(to_numpy(lifted(x)), to_numpy(net(x)), rtol=1e-5)
