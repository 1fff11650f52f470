"""The port's ``Triangulation`` and ``PiecewiseConstant`` against the JAX
package's.

Both packages build the interpolant from the same numpy vertex values
and evaluate it on the same points, among them grid vertices, points on
cell diagonals (equal fractional coordinates, where the Kuhn tie rule
decides the simplex), on cell faces and edges, and outside the domain.
The port gathers along the vertex chain; it is held against every gather
regime of the JAX package, forced through its ``config.block_gather_limit``:
the full corner table, the partially folded one and the chain. Tolerance: float64 to 1e-10 relative (absolute 1e-12 near
zero), and the simplex indices exactly. The pinned reference values are
those of ``tests/test_simplex.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

import safe_learning_tpu as sl
import safe_learning_tpu_torch as st
from safe_learning_tpu.config import config as jax_config
from safe_learning_tpu_torch import convert

from _torch_parity import to_numpy, working_dtype

RTOL, ATOL = 1e-10, 1e-12

SHAPES = {1: [6], 2: [5, 4], 3: [4, 3, 5]}

#: (ndim, regime): the JAX package's gather regimes in each dimension. A
#: partial fold exists where 2^(d-k) row gathers beat d + 1 chain gathers.
REGIMES = [(1, "table"), (1, "chain"), (2, "table"), (2, "partial"),
           (2, "chain"), (3, "table"), (3, "partial"), (3, "chain")]


def regime_limit(grid, regime, outputs):
    """The JAX ``block_gather_limit`` that selects a regime on ``grid``."""
    if regime == "table":
        return 1 << 30
    if regime == "chain":
        return 0
    d = grid.ndim
    k = d - 1
    shape = tuple(grid.shape)
    rows = int(np.prod(shape[:d - k])) * int(np.prod(
        [n - 1 for n in shape[d - k:]]))
    return rows * 2 ** k * outputs


@pytest.fixture
def limit():
    """Set the JAX package's ``block_gather_limit``; restore it after."""
    old = jax_config.block_gather_limit

    def set_limit(value):
        jax_config.block_gather_limit = value

    yield set_limit
    jax_config.block_gather_limit = old


def query_points(grid, rng, n=120):
    """Random points inside and outside the domain, grid vertices, points
    on cell diagonals, faces and edges."""
    lim = np.asarray(grid.limits, dtype=float)
    span = lim[:, 1] - lim[:, 0]
    d = grid.ndim
    pts = [rng.uniform(lim[:, 0] - 0.2 * span, lim[:, 1] + 0.2 * span,
                       size=(n, d)),
           np.asarray(grid.all_points)[rng.integers(0, grid.nindex, 12)]]
    # Equal fractional coordinates in every dimension: cell diagonals.
    unit = np.asarray(grid.unit_maxes, dtype=float)
    cells = rng.integers(0, np.asarray(grid.num_points) - 1, size=(12, d))
    frac = rng.uniform(0, 1, size=(12, 1))
    pts.append(lim[:, 0] + (cells + frac) * unit)
    # One coordinate on a grid line (a face), two on grid lines (an
    # edge, in 3-D), the rest random.
    for snapped in (1, min(2, d)):
        base = rng.uniform(lim[:, 0], lim[:, 1], size=(12, d))
        idx = rng.integers(0, np.asarray(grid.num_points), size=(12, d))
        base[:, :snapped] = (lim[:, 0] + idx * unit)[:, :snapped]
        pts.append(base)
    return np.vstack(pts)


def tri_pair(d, outputs, project, seed):
    rng = np.random.default_rng(seed)
    limits = [[-1.0, 1.0], [0.0, 2.0], [-2.0, -0.5]][:d]
    jgrid = sl.GridWorld(limits, SHAPES[d])
    values = rng.normal(size=(jgrid.nindex, outputs))
    jtri = sl.Triangulation(jgrid, values, project=project)
    tri = convert.triangulation(st.GridWorld(limits, SHAPES[d]), values,
                                project=project)
    return jtri, tri, query_points(jgrid, rng), values


@pytest.mark.parametrize("project", [False, True])
@pytest.mark.parametrize("d,regime", REGIMES)
def test_evaluate_matches_jax(limit, d, regime, project):
    """Values and the gradient with respect to the vertex values (autograd
    against ``jax.grad``), against one of the JAX package's gather
    regimes."""
    with working_dtype("float64"):
        jtri, tri, pts, values = tri_pair(d, 2, project, seed=d)
        limit(regime_limit(jtri.discretization, regime, 2))
        expect_fold = {"table": d, "partial": d - 1, "chain": None}[regime]
        assert jtri._block_fold() == expect_fold
        assert_allclose(to_numpy(tri(pts)), np.asarray(jtri(pts)),
                        rtol=RTOL, atol=ATOL)
        jgrad = jax.grad(lambda p: jnp.sum(jnp.sin(jtri.replace(
            parameters=p)(pts))))(jtri.parameters)
        params = tri.parameters.clone().requires_grad_(True)
        torch.sin(tri.with_parameters({"parameters": params})(pts)).sum() \
            .backward()
    assert_allclose(params.grad.numpy(), np.asarray(jgrad), rtol=RTOL,
                    atol=ATOL)


@pytest.mark.parametrize("project", [False, True])
@pytest.mark.parametrize("d", [1, 2, 3])
def test_geometry_matches_jax(d, project):
    """Interpolation weights and vertices, the spatial gradient, the
    simplex indices and their vertex lists, and the two sparse parameter
    derivatives."""
    with working_dtype("float64"):
        jtri, tri, pts, values = tri_pair(d, 1, project, seed=10 + d)
        jv, jw = map(np.asarray, jtri.interpolation_weights(pts))
        v, w = map(to_numpy, tri.interpolation_weights(pts))
        assert_array_equal(v, jv)
        assert_allclose(w, jw, rtol=RTOL, atol=ATOL)
        assert_allclose(to_numpy(tri.gradient(pts)),
                        np.asarray(jtri.gradient(pts)), rtol=RTOL, atol=ATOL)
        ids = to_numpy(tri.find_simplex(pts))
        assert_array_equal(ids, np.asarray(jtri.find_simplex(pts)))
        assert_array_equal(to_numpy(tri.simplices(ids)),
                           np.asarray(jtri.simplices(ids)))
        assert_array_equal(to_numpy(tri.simplices(ids)), v)
        for name in ("parameter_derivative",
                     "gradient_parameter_derivative"):
            got = getattr(tri, name)(pts).toarray()
            want = getattr(jtri, name)(pts).toarray()
            assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        assert tri.nsimplex == jtri.nsimplex


def test_multi_output_gradient_shape():
    with working_dtype("float64"):
        jtri, tri, pts, _ = tri_pair(2, 3, False, seed=7)
        grad = to_numpy(tri.gradient(pts))
        assert grad.shape == (len(pts), 3, 2)
        assert_allclose(grad, np.asarray(jtri.gradient(pts)), rtol=RTOL,
                        atol=ATOL)


def test_reference_pinned_1d():
    """The pinned 1-D case of ``tests/test_simplex.py``: values
    [0, 0.5, 0] on a 3-point grid over [0, 1]."""
    with working_dtype("float64"):
        fun = st.Triangulation(st.GridWorld([[0, 1]], 3), [0.0, 0.5, 0.0])
        pts = np.array([[0.0, 0.2, 0.5, 0.6, 0.9, 1.0]]).T
        assert_array_equal(to_numpy(fun.find_simplex(pts)),
                           [0, 0, 1, 1, 1, 1])
        true_values = np.array([0, 0.2, 0.5, 0.4, 0.1, 0])[:, None]
        assert_allclose(to_numpy(fun(pts)), true_values, atol=1e-12)
        b = fun.parameter_derivative(pts).toarray()
        assert_allclose(b @ [0.0, 0.5, 0.0], true_values.ravel(),
                        atol=1e-12)
        true_gradient = np.array([1, 1, -1, -1, -1, -1])[:, None]
        assert_allclose(to_numpy(fun.gradient(pts)).reshape(-1, 1),
                        true_gradient, atol=1e-12)
        gb = fun.gradient_parameter_derivative(pts).toarray()
        assert_allclose((gb @ [0.0, 0.5, 0.0]).reshape(-1, 1),
                        true_gradient, atol=1e-12)


def test_reference_pinned_3d_and_2d_hand_computed():
    """The pinned 3-D cube and the hand-computed 2-D Kuhn cases of
    ``tests/test_simplex.py``."""
    with working_dtype("float64"):
        grid = st.GridWorld([[0, 1]] * 3, 2)
        assert st.Triangulation(grid).nsimplex == 6
        values = np.sum(grid.all_points, axis=1) / 3
        fun = st.Triangulation(grid, values)
        test_points = np.vstack([grid.all_points,
                                 [[0, 0, 0.5], [0.5, 0, 0], [0, 0.5, 0],
                                  [0.5, 0.5, 0.5]]])
        true_values = np.hstack([values, [1 / 6, 1 / 6, 1 / 6, 1 / 2]])
        assert_allclose(to_numpy(fun(test_points)).ravel(), true_values,
                        atol=1e-10)

        square = st.Triangulation(st.GridWorld([[0, 1], [0, 1]], 2),
                                  np.array([0.0, 10.0, 1.0, 11.0]))
        out = to_numpy(square(np.array([[0.75, 0.25], [0.25, 0.75],
                                        [0.5, 0.5]]))).ravel()
        assert_allclose(out, [0.25 * 0.0 + 0.5 * 1.0 + 0.25 * 11.0,
                              0.25 * 0.0 + 0.5 * 10.0 + 0.25 * 11.0,
                              0.5 * 11.0])


def test_piecewise_constant_matches_jax():
    rng = np.random.default_rng(8)
    with working_dtype("float64"):
        limits = [[0.0, 1.0], [-1.0, 1.0]]
        jgrid = sl.GridWorld(limits, [4, 5])
        values = rng.normal(size=(jgrid.nindex, 2))
        jfun = sl.PiecewiseConstant(jgrid, values)
        fun = convert.piecewise_constant(st.GridWorld(limits, [4, 5]),
                                         values)
        pts = query_points(jgrid, rng, n=50)
        assert_allclose(to_numpy(fun(pts)), np.asarray(jfun(pts)),
                        rtol=RTOL)
        assert_allclose(fun.parameter_derivative(pts).toarray(),
                        jfun.parameter_derivative(pts).toarray())
        assert not to_numpy(fun.gradient(pts)).any()
        pinned = st.PiecewiseConstant(st.GridWorld([[0.0, 1.0]], 3),
                                      np.array([1.0, 2.0, 3.0]))
        assert_allclose(to_numpy(pinned(np.array([[0.0], [0.2], [0.3],
                                                  [0.8], [1.0]]))),
                        [[1.0], [1.0], [2.0], [3.0], [3.0]])


def test_float32_matches_jax_and_lift64_keeps_the_grid():
    """In float32 the port agrees with the JAX package to float32
    rounding; ``oracle.lift64`` widens the vertex values exactly and keeps
    the ``GridWorld``."""
    with working_dtype("float32"):
        jtri, tri, pts, _ = tri_pair(2, 1, True, seed=9)
        pts = pts.astype(np.float32)
        assert_allclose(to_numpy(tri(pts)), np.asarray(jtri(pts)),
                        rtol=1e-5, atol=1e-5)
        lifted = st.oracle.lift64(tri)
    assert lifted.discretization is tri.discretization
    assert lifted.parameters.dtype == torch.float64
    assert torch.equal(lifted.parameters, tri.parameters.double())
    with pytest.raises(TypeError):
        st.Triangulation(np.zeros((3, 1)))
