"""Function framework: composable function objects on torch tensors.

Counterpart of ``safe_learning_tpu/functions/base.py``. The JAX package
makes every function an immutable pytree; here a function is a plain
object holding tensors on ``config.device``, with no registry.

Calling conventions are the JAX package's:

- ``fun(x)`` or ``fun(states, actions)``: positional inputs are
  concatenated along axis 1;
- a :class:`DeterministicFunction` returns a tensor, an
  :class:`UncertainFunction` a ``(mean, error)`` tuple;
- the algebra ``f + g``, ``f * g``, ``-f``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import config

__all__ = [
    "Function", "DeterministicFunction", "UncertainFunction",
    "ConstantFunction", "AddedFunction", "MultipliedFunction",
    "MeanFunction", "Saturation", "FunctionStack", "LambdaFunction",
    "as_deterministic", "concatenate_inputs", "as_tensor",
]


def as_tensor(value, dtype=None):
    """Return ``value`` as a tensor.

    A tensor passes through unchanged (dtype conversion aside). Anything
    else becomes a tensor on ``config.device``; floating input takes the
    working dtype unless ``dtype`` says otherwise.
    """
    if isinstance(value, torch.Tensor):
        return value if dtype is None else value.to(dtype)
    arr = np.asarray(value)
    if not arr.flags.writeable:
        arr = arr.copy()
    if dtype is None and np.issubdtype(arr.dtype, np.floating):
        dtype = config.dtype
    return torch.as_tensor(arr, dtype=dtype, device=config.device)


def dot(a, b):
    """Matmul in the promoted dtype of both operands.

    The counterpart of ``mxu_dot``: float32 matmuls run in full float32,
    since importing ``config`` turns TF32 off.
    """
    dtype = torch.promote_types(a.dtype, b.dtype)
    return torch.matmul(a.to(dtype), b.to(dtype))


def concatenate_inputs(*args):
    """Concatenate positional inputs along axis 1."""
    tensors = [torch.atleast_2d(as_tensor(a)) for a in args]
    if len(tensors) == 1:
        return tensors[0]
    return torch.cat(tensors, dim=1)


class Function:
    """Base class for composable function objects."""

    input_dim = None
    output_dim = None

    def __call__(self, *points):
        """Evaluate at ``points`` (positional inputs are concatenated)."""
        return self.evaluate(concatenate_inputs(*points))

    def evaluate(self, points):
        """Evaluate the function at a 2D batch of points."""
        raise NotImplementedError("must be implemented by the child class")

    def __add__(self, other):
        """Pointwise sum."""
        return AddedFunction(self, other)

    def __radd__(self, other):
        """Right-hand pointwise sum."""
        return AddedFunction(other, self)

    def __mul__(self, other):
        """Pointwise product."""
        return MultipliedFunction(self, other)

    def __rmul__(self, other):
        """Right-hand pointwise product."""
        return MultipliedFunction(other, self)

    def __neg__(self):
        """Pointwise negation."""
        return MultipliedFunction(self, -1.0)

    def __sub__(self, other):
        """Pointwise difference."""
        return AddedFunction(self, MultipliedFunction(other, -1.0))

    def __rsub__(self, other):
        """Right-hand pointwise difference."""
        return AddedFunction(other, MultipliedFunction(self, -1.0))


class DeterministicFunction(Function):
    """A function returning point values."""


class UncertainFunction(Function):
    """A function returning ``(mean, error_bound)`` tuples."""

    def to_mean_function(self):
        """Return a deterministic function for the mean prediction."""
        return MeanFunction(self)


class MeanFunction(DeterministicFunction):
    """Deterministic wrapper returning only the mean of an uncertain fn."""

    def __init__(self, fun):
        self.fun = fun
        self.input_dim = fun.input_dim
        self.output_dim = fun.output_dim

    def evaluate(self, points):
        """Evaluate the function at ``points``."""
        return self.fun.evaluate(points)[0]


class ConstantFunction(DeterministicFunction):
    """A function with a constant value.

    A Python number stays a number (it broadcasts on every device and in
    every dtype); an array becomes a tensor on ``config.device``.
    """

    def __init__(self, constant):
        self.constant = (constant if isinstance(constant, (int, float))
                         else as_tensor(constant))

    def evaluate(self, points):
        """Evaluate the function at ``points``."""
        return self.constant


def _as_function(fun):
    if isinstance(fun, Function):
        return fun
    return ConstantFunction(fun)


class AddedFunction(Function):
    """Pointwise sum of two functions."""

    def __init__(self, fun1, fun2):
        self.fun1 = _as_function(fun1)
        self.fun2 = _as_function(fun2)

    def evaluate(self, points):
        """Evaluate the function at ``points``."""
        return self.fun1.evaluate(points) + self.fun2.evaluate(points)


class MultipliedFunction(Function):
    """Pointwise product of two functions."""

    def __init__(self, fun1, fun2):
        self.fun1 = _as_function(fun1)
        self.fun2 = _as_function(fun2)

    def evaluate(self, points):
        """Evaluate the function at ``points``."""
        return self.fun1.evaluate(points) * self.fun2.evaluate(points)


class Saturation(DeterministicFunction):
    """Clip a wrapped function's output to ``[lower, upper]``.

    Public attributes it does not have itself are read from the wrapped
    function, as in ``safe_learning_tpu/functions/base.py:397-403``.
    Bounds that are Python numbers stay numbers; otherwise both become
    tensors on ``config.device``.
    """

    def __init__(self, fun, lower, upper):
        self.fun = fun
        if all(isinstance(b, (int, float)) for b in (lower, upper)):
            self.lower, self.upper = float(lower), float(upper)
        else:
            self.lower, self.upper = as_tensor(lower), as_tensor(upper)
        self.input_dim = fun.input_dim
        self.output_dim = fun.output_dim

    def __getattr__(self, name):
        """Forward unknown public attributes to the wrapped function."""
        # Private names, and any name before ``fun`` is set (a copy being
        # rebuilt), are not forwarded.
        if name.startswith("_") or "fun" not in self.__dict__:
            raise AttributeError(name)
        return getattr(self.fun, name)

    def evaluate(self, points):
        """Evaluate the function at ``points``."""
        return torch.clamp(self.fun.evaluate(points), self.lower,
                           self.upper)


class FunctionStack(UncertainFunction):
    """Stack single-output uncertain functions into a multi-output model.

    One function per output dimension (for example one GP per state
    dimension), as ``safe_learning_tpu.FunctionStack``; the outputs'
    means and errors are concatenated along axis 1.
    """

    def __init__(self, functions):
        self.functions = tuple(functions)
        self.num_fun = len(self.functions)
        self.input_dim = self.functions[0].input_dim
        self.output_dim = sum(f.output_dim for f in self.functions)

    def evaluate(self, points):
        """Evaluate the function at ``points``."""
        means, errors = [], []
        for fun in self.functions:
            mean, error = fun.evaluate(points)
            means.append(mean)
            errors.append(error)
        return torch.cat(means, dim=1), torch.cat(errors, dim=1)

    def add_data_point(self, x, y):
        """Fan a measurement out to the members (not ported yet)."""
        raise NotImplementedError(
            "FunctionStack.add_data_point is ROADMAP queue 1 item 14 (GP "
            "online learning)")


class LambdaFunction(DeterministicFunction):
    """Wrap a plain callable on tensors as a DeterministicFunction."""

    def __init__(self, fun, input_dim=None, output_dim=None):
        self.fun = fun
        self.input_dim = input_dim
        self.output_dim = output_dim

    def evaluate(self, points):
        """Evaluate the function at ``points``."""
        return self.fun(points)


def as_deterministic(fun, input_dim=None, output_dim=None):
    """Coerce a callable into a DeterministicFunction."""
    if isinstance(fun, Function):
        return fun
    return LambdaFunction(fun, input_dim, output_dim)
