"""The port's region tools against the JAX package's.

``smallest_boundary_value`` and ``get_lyapunov_region``
(``safe_learning_tpu/lyapunov.py:1366-1448``) on the instances of
``tests/test_lyapunov.py:175-215`` and on larger ones: equal results, the
port's C++ flood fill (``safe_learning_tpu_torch/native``) and its Python
path alike, and the ``use_native`` semantics.
"""

import numpy as np
import pytest
import torch
from numpy.testing import assert_array_equal

import safe_learning_tpu as sl
import safe_learning_tpu_torch as st
from safe_learning_tpu.lyapunov import get_lyapunov_region as jax_region
from safe_learning_tpu.lyapunov import smallest_boundary_value as jax_sbv
from safe_learning_tpu_torch import native
from safe_learning_tpu_torch.lyapunov import (get_lyapunov_region,
                                              smallest_boundary_value)

from _torch_parity import working_dtype


@pytest.fixture
def native_built():
    if native.load_flood_fill() is None:
        pytest.skip("no C++ compiler to build the native flood fill")


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_smallest_boundary_value_matches_jax(dtype):
    """Reference ``test_lyapunov.py:77-83``, and a quadratic on an
    uneven grid."""
    import jax.numpy as jnp

    with working_dtype(dtype):
        limits = [[-1.5, 1], [-1, 1.5]]
        jfun = sl.LambdaFunction(lambda x: 2 * jnp.abs(x).sum(axis=1))
        pfun = st.LambdaFunction(lambda x: 2 * torch.abs(x).sum(dim=1))
        value = smallest_boundary_value(pfun, st.GridWorld(limits, [3, 3]))
        assert value == jax_sbv(jfun, sl.GridWorld(limits, [3, 3])) == 2.5
        p = np.array([[1.0, 0.3], [0.3, 2.0]])
        limits = [[-1.0, 0.7], [-0.4, 1.3]]
        assert smallest_boundary_value(
            st.QuadraticFunction(p), st.GridWorld(limits, [41, 23])) == \
            jax_sbv(sl.QuadraticFunction(p), sl.GridWorld(limits, [41, 23]))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_region_of_a_quadratic_matches_jax(native_built, dtype):
    """``tests/test_lyapunov.py:186-193``: a centered blob that does not
    reach the boundary. On a grid of multiples of 1/4 every value is exact
    in both packages and dtypes, so their heaps see equal numbers."""
    with working_dtype(dtype):
        region = get_lyapunov_region(st.QuadraticFunction(np.eye(2)),
                                     st.GridWorld([[-1, 1], [-1, 1]], 9),
                                     (4, 4))
        want = jax_region(sl.QuadraticFunction(np.eye(2)),
                          sl.GridWorld([[-1, 1], [-1, 1]], 9), (4, 4))
    assert region[4, 4] and not region[0, :].any() and region.sum() > 1
    assert_array_equal(region, want)


def lookup(pkg, values):
    """``values`` (numpy, grid order) as ``pkg``'s function of the grid, as
    ``tests/test_lyapunov.py:209`` feeds the flood fill: both packages'
    heaps see the same numbers."""
    if pkg is sl:
        return sl.LambdaFunction(lambda x: values.reshape(-1, 1), 2, 1)
    return st.LambdaFunction(
        lambda x: torch.as_tensor(values, device=x.device).reshape(-1, 1),
        2, 1)


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("shape,init", [((41, 31), (20, 15)),
                                        ((120, 97), (60, 48))])
def test_region_with_a_bump_matches_jax(native_built, use_native, shape,
                                        init):
    """``v = x^T P x`` plus a Gaussian bump (``tests/test_lyapunov.py:
    204-208``): the monotone walk stops where the bump breaks
    monotonicity; both of the port's paths equal the JAX package's native
    result."""
    with working_dtype("float64"):
        limits = [[-1.0, 1.0], [-1.0, 1.0]]
        points = st.GridWorld(limits, shape).all_points
        p = np.array([[1.0, 0.3], [0.3, 2.0]])
        values = (np.einsum("ni,ij,nj->n", points, p, points)
                  + 0.4 * np.exp(-((points - 0.5) ** 2).sum(1) / 0.05))
        got = get_lyapunov_region(lookup(st, values),
                                  st.GridWorld(limits, shape), init,
                                  use_native=use_native)
        want = jax_region(lookup(sl, values), sl.GridWorld(limits, shape),
                          init)
    assert got.shape == shape and got.dtype == bool
    assert 1 < got.sum() < np.prod(shape)
    assert_array_equal(got, want)


def test_region_3d_native_equals_python(native_built):
    with working_dtype("float64"):
        grid = st.GridWorld([[-1.0, 1.0]] * 3, [13, 11, 9])
        v = st.QuadraticFunction(np.diag([1.0, 2.0, 0.5]))
        native_region = get_lyapunov_region(v, grid, (6, 5, 4),
                                            use_native=True)
        python_region = get_lyapunov_region(v, grid, (6, 5, 4),
                                            use_native=False)
    assert native_region.sum() > 1
    assert_array_equal(native_region, python_region)


def test_use_native_true_raises_when_the_library_cannot_build(monkeypatch):
    """``use_native=True`` raises, ``None`` falls back to Python."""
    monkeypatch.setattr(native, "load_flood_fill", lambda: None)
    grid = st.GridWorld([[-1, 1], [-1, 1]], 11)
    v = st.QuadraticFunction(np.eye(2))
    with pytest.raises(RuntimeError, match="native flood fill"):
        get_lyapunov_region(v, grid, (5, 5), use_native=True)
    assert_array_equal(get_lyapunov_region(v, grid, (5, 5)),
                       get_lyapunov_region(v, grid, (5, 5),
                                           use_native=False))


def test_native_library_builds_into_the_build_dir(native_built):
    from safe_learning_tpu_torch.ops.build import BUILD_DIR

    path = native._library_path()
    assert path.startswith(BUILD_DIR) and path.endswith(".so")
    assert native.load_flood_fill() is not None
