"""The rest of the port's ``utils.py`` against the JAX package's: the
parameter grids, ``ellipse_bounds``, ``unique_rows``,
``get_parameter_change``, ``find_nearest``, the class and confusion
weights, the weight and gradient clipping on parameter trees,
``constrained_batch_sampler`` (its draws come from a ``torch.Generator``,
so its mask is held against the JAX rule on the same batch) and the
monomial features and their derivatives. Host helpers must be equal;
tensor results within 1e-12 in float64.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

import safe_learning_tpu as sl
import safe_learning_tpu_torch as st

from _torch_parity import to_numpy, working_dtype


@pytest.mark.parametrize("name,args", [
    ("combinations", ([np.arange(3), np.linspace(0, 1, 4)],)),
    ("linearly_spaced_combinations", ([(0, 1), (-1, 2)], [2, 3])),
    ("linearly_spaced_combinations", ([(0, 1)], 5)),
    ("ellipse_bounds", (np.array([[2.0, 0.4], [0.4, 1.0]]), 0.7, 11)),
    ("unique_rows", (np.array([[1, 2], [3, 4], [1, 2], [0, 9]]),)),
    ("find_nearest", (np.array([0.0, 1.0, 2.0, 5.0]), 3.4)),
    ("find_nearest", (np.array([4.0, 0.0, 2.0]), 9.0, False)),
    ("balanced_class_weights", (np.array([1, 1, 1, 0, 0]),)),
    ("balanced_class_weights", (np.array([1, 0, 0, 0]), False)),
    ("balanced_confusion_weights", (np.array([1, 1, 0, 0, 1]),
                                    np.array([1, 0, 1, 0, 1]))),
])
def test_host_helpers_match_jax(name, args):
    got = getattr(st.utils, name)(*args)
    want = getattr(sl.utils, name)(*args)
    if not isinstance(want, tuple):
        got, want = (got,), (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("ord_", ["inf", "-inf", 1, 2])
def test_get_parameter_change_matches_jax(ord_):
    rng = np.random.default_rng(0)
    old = {"weights": (rng.normal(size=(2, 3)), rng.normal(size=(3, 1))),
           "biases": (rng.normal(size=3), None)}
    new = {"biases": (rng.normal(size=3), None),
           "weights": (rng.normal(size=(2, 3)), rng.normal(size=(3, 1)))}
    port = {k: tuple(None if v is None else torch.as_tensor(v) for v in t)
            for k, t in new.items()}
    assert_allclose(st.utils.get_parameter_change(old, port, ord_),
                    sl.utils.get_parameter_change(old, new, ord_),
                    rtol=1e-14)


def test_weight_constraint_and_gradient_clipping_match_jax():
    params = {"w": np.array([-2.0, 0.5, 3.0]), "b": (np.array([[4.0]]),
                                                      None)}
    lower = {"w": -1.5, "b": (0.0, None)}
    upper = {"w": 0.0, "b": (2.0, None)}
    with working_dtype("float64"):
        port = {"w": torch.as_tensor(params["w"]),
                "b": (torch.as_tensor(params["b"][0]), None)}
        jparams = {"w": jnp.asarray(params["w"]),
                   "b": (jnp.asarray(params["b"][0]), None)}
        for got, want in (
                (st.utils.add_weight_constraint(port, -1.0, 1.0),
                 sl.utils.add_weight_constraint(jparams, -1.0, 1.0)),
                (st.utils.add_weight_constraint(port, lower, upper),
                 sl.utils.add_weight_constraint(jparams, lower, upper)),
                (st.utils.gradient_clipping(port, -0.5, 0.5),
                 sl.utils.gradient_clipping(jparams, -0.5, 0.5))):
            assert got["b"][1] is None
            assert_array_equal(to_numpy(got["w"]), np.asarray(want["w"]))
            assert_array_equal(to_numpy(got["b"][0]),
                               np.asarray(want["b"][0]))


@pytest.mark.parametrize("action_limit", [None, 1.0])
def test_constrained_batch_sampler_follows_the_jax_rule(action_limit):
    with working_dtype("float64"):
        dynamics = st.LinearSystem([[2.0, 0.0]])
        policy = st.LinearSystem([[-3.0]])
        generator = torch.Generator().manual_seed(0)
        batch, mask = st.utils.constrained_batch_sampler(
            generator, dynamics, policy, 1, 256, action_limit=action_limit)
        raw = 2.0 * torch.rand((256, 1), generator=torch.Generator()
                               .manual_seed(0), dtype=torch.float64) - 1.0
        jdyn = sl.LinearSystem([[2.0, 0.0]])
        jpol = sl.LinearSystem([[-3.0]])
        x = jnp.asarray(raw.numpy())
        u = jpol(x)
        nxt = np.asarray(jdyn(x, u))
        want = np.all((nxt >= -1.0) & (nxt <= 1.0), axis=1)
        if action_limit is not None:
            want &= np.all(np.abs(np.asarray(u)) <= action_limit, axis=1)
    mask = to_numpy(mask)
    assert_array_equal(mask, want)
    assert_array_equal(to_numpy(batch), raw.numpy() * want[:, None])
    assert batch.shape == (256, 1) and 0 < mask.sum() < 256


@pytest.mark.parametrize("deg", [1, 2, 3])
def test_monomials_and_derivatives_match_jax(deg):
    x = np.random.default_rng(1).normal(size=(7, 2))
    with working_dtype("float64"):
        assert_allclose(to_numpy(st.utils.monomials(x, deg)),
                        np.asarray(sl.utils.monomials(x, deg)), rtol=1e-12)
        got = to_numpy(st.utils.derivative_monomials(x, deg))
        want = np.asarray(sl.utils.derivative_monomials(x, deg))
    assert got.shape == want.shape == (7, 2 + sum(range(3, deg + 2)), 2)
    assert_allclose(got, want, rtol=1e-12, atol=1e-14)
