"""The port's safe exploration against the JAX package's.

The 1-D instance of ``tests/test_explore.py`` (GP dynamics learned from
60 samples of ``f(x, u) = 0.6 x + 0.4 u``, ``v = x^2``) is built in both
packages from the same numpy data. For the same ``default_rng`` seed both
must choose the same state-action pair, in perturbation and in action
mode, and, when nothing is safe, the same backup-policy pair with the
same ``RuntimeWarning``. Tolerance: float64, the pair exactly and its
bound to 1e-10 relative.
"""

import types

import numpy as np
import pytest
from numpy.testing import assert_allclose, assert_array_equal

import safe_learning_tpu as sl
import safe_learning_tpu_torch as st
from safe_learning_tpu_torch import explore

from _torch_parity import port_gp, to_numpy, working_dtype

RTOL = 1e-10


def lyapunov_pair(dtype="float64"):
    """The instance in both packages after one verification."""
    with working_dtype(dtype):
        rng = np.random.default_rng(0)
        x = rng.uniform(-1, 1, size=(60, 2))
        y = 0.6 * x[:, :1] + 0.4 * x[:, 1:]
        jgp = sl.GaussianProcess(sl.RBF(1.0, [0.7, 0.7], input_dim=2), x, y,
                                 1e-4, beta=2.0)
        jlyap = sl.Lyapunov(
            sl.GridWorld([[-1, 1]], 11),
            sl.LambdaFunction(lambda s: (s ** 2).sum(axis=1, keepdims=True)),
            jgp, 1.0, 1.0, 1e-3, sl.LambdaFunction(lambda s: -0.2 * s),
            initial_set=[4, 5, 6])
        lyap = st.Lyapunov(
            st.GridWorld([[-1, 1]], 11),
            st.LambdaFunction(lambda s: (s ** 2).sum(dim=1, keepdim=True)),
            port_gp(jgp), 1.0, 1.0, 1e-3,
            st.LambdaFunction(lambda s: -0.2 * s), initial_set=[4, 5, 6])
        jlyap.update_safe_set()
        lyap.update_safe_set()
    assert_array_equal(lyap.safe_set, jlyap.safe_set)
    assert lyap.safe_set.sum() > 3
    return lyap, jlyap


def both_samples(lyap, jlyap, seed, **kwargs):
    """``get_safe_sample`` in both packages from ``default_rng(seed)``;
    returns ``((xu, bound), (jxu, jbound))``."""
    with working_dtype("float64"):
        got = st.get_safe_sample(lyap, rng=np.random.default_rng(seed),
                                 **kwargs)
        want = sl.get_safe_sample(jlyap, rng=np.random.default_rng(seed),
                                  **kwargs)
    return got, want


def test_perturb_actions_matches_jax():
    rng = np.random.default_rng(1)
    states = rng.normal(size=(7, 2))
    actions = rng.normal(size=(7, 1))
    perturbations = np.array([[-0.3], [0.0], [0.3]])
    for limits in (None, np.array([[-0.5, 0.5]])):
        assert_array_equal(
            st.perturb_actions(states, actions, perturbations, limits),
            sl.perturb_actions(states, actions, perturbations, limits))
    sa = st.perturb_actions(np.zeros((1, 1)), np.array([[0.9]]),
                            np.array([[0.0], [0.2], [0.4]]),
                            limits=np.array([[-1.0, 1.0]]))
    assert_allclose(sa[:, 1], [0.9, 1.0])


@pytest.mark.parametrize("num_samples", [None, 4])
@pytest.mark.parametrize("mode", ["perturbations", "actions", "positive"])
def test_same_pair_as_jax(mode, num_samples):
    lyap, jlyap = lyapunov_pair()
    if mode == "actions":
        kwargs = dict(actions=np.array([[-0.1], [0.0], [0.1]]))
    else:
        kwargs = dict(perturbations=np.linspace(-0.2, 0.2, 5)[:, None],
                      limits=np.array([[-0.15, 0.15]]),
                      positive=mode == "positive")
    (xu, bound), (jxu, jbound) = both_samples(
        lyap, jlyap, 3, num_samples=num_samples, **kwargs)
    assert xu.shape == (1, 2) and xu.dtype == np.float64
    assert_array_equal(xu, jxu)
    assert_allclose(bound, jbound, rtol=RTOL)
    # The chosen pair maps into the level set with its error bound.
    with working_dtype("float64"):
        mean, std = lyap.dynamics(xu)
    assert float(mean[0, 0] ** 2 + std[0, 0]) < lyap.c_max


def test_backup_policy_fallback_matches_jax():
    lyap, jlyap = lyapunov_pair()
    lyap.c_max = jlyap.c_max = -np.inf
    perturbations = np.linspace(-0.2, 0.2, 5)[:, None]
    with pytest.warns(RuntimeWarning, match="backup policy"):
        (xu, bound), (jxu, jbound) = both_samples(
            lyap, jlyap, 1, perturbations=perturbations)
    assert_array_equal(xu, jxu)
    assert_allclose(bound, jbound, rtol=RTOL)
    # The backup pair is the policy's own action at a sampled state.
    assert_allclose(xu[0, 1], -0.2 * xu[0, 0], rtol=1e-12)


def test_empty_safe_set_and_unported_options_raise():
    lyap, _ = lyapunov_pair()
    with pytest.raises(NotImplementedError, match="item 18"):
        st.get_safe_sample(lyap, np.zeros((1, 1)), extended=True)
    with pytest.raises(ValueError, match="perturbations or actions"):
        st.get_safe_sample(lyap)
    lyap.safe_set[:] = False
    lyap.initial_safe_set = None
    with pytest.raises(RuntimeError, match="safe set is empty"):
        st.get_safe_sample(lyap, np.zeros((1, 1)),
                           rng=np.random.default_rng(0))


@pytest.mark.parametrize("mutation", ["in_place", "item", "assignment"])
def test_safe_set_mutation_invalidates_the_device_cache(mutation):
    """After the safe set shrinks to the initial set, by ``&=``, by item
    assignment or by a new mask, the chosen pair's mean next state lies
    in the shrunk set, and the JAX package chooses the same pair."""
    lyap, jlyap = lyapunov_pair()
    pert = np.zeros((1, 1))
    with working_dtype("float64"):
        st.get_safe_sample(lyap, pert, rng=np.random.default_rng(0))
    cached = lyap._safe_set_dev_cache[1]
    keep = np.zeros(len(lyap.safe_set), dtype=bool)
    keep[[4, 5, 6]] = True
    for target in (lyap, jlyap):
        if mutation == "in_place":
            target.safe_set &= keep
        elif mutation == "item":
            target.safe_set[~keep] = False
        else:
            target.safe_set = keep.copy()
    (xu, _), (jxu, _) = both_samples(lyap, jlyap, 0, perturbations=pert)
    assert lyap._safe_set_dev_cache[1] is not cached
    assert_array_equal(to_numpy(explore._device_safe_set(lyap)), keep)
    assert_array_equal(xu, jxu)
    with working_dtype("float64"):
        mean, _ = lyap.dynamics(xu)
        idx = int(lyap.discretization.state_to_index(mean)[0])
    assert lyap.safe_set[idx]


MARGIN_CASES = [
    dict(),
    dict(certificate_margin=1e-3),
    dict(certificate_margin=np.array([1e-4, 5e-3, 2e-3])),
    dict(certificate_margin=2e-3, exploration_margin=1e-4),
    dict(certificate_margin=2e-3, _certificate_margin_unit=1e-12),
    dict(certificate_margin=2e-3, exploration_margin=1e-4,
         _exploration_margin_unit=1e-12),
    dict(certificate_margin=2e-3, _certificate_margin_unit=1e-7),
]


@pytest.mark.parametrize("fields", MARGIN_CASES)
def test_margins_match_jax(fields):
    """``_margin_of`` and ``_fallback_margin`` on duck-typed objects: the
    same margin as the JAX package, or the same refusal of a margin
    derived at a finer unit roundoff than float32's."""
    from safe_learning_tpu import explore as jax_explore

    obj = types.SimpleNamespace(**fields)
    with working_dtype("float32"):
        for name in ("_margin_of", "_fallback_margin"):
            try:
                want = getattr(jax_explore, name)(obj)
            except RuntimeError:
                with pytest.raises(RuntimeError, match="unit roundoff"):
                    getattr(explore, name)(obj)
                continue
            assert getattr(explore, name)(obj) == pytest.approx(want,
                                                                 rel=0)


def test_float32_same_pair_as_jax():
    """In float32 the two packages still choose the same pair here: the
    candidates' scores differ by rounding only."""
    lyap, jlyap = lyapunov_pair("float32")
    pert = np.linspace(-0.2, 0.2, 5)[:, None]
    with working_dtype("float32"):
        xu, _ = st.get_safe_sample(lyap, pert, rng=np.random.default_rng(2))
        jxu, _ = sl.get_safe_sample(jlyap, pert,
                                    rng=np.random.default_rng(2))
    assert xu.dtype == np.float32
    assert_array_equal(xu, np.asarray(jxu))
