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

Parameters are updated functionally, as in the JAX package:
``fun.with_parameters(new)`` returns a new object, and
``fun.parameters_dict`` is the nested dictionary of a function's
trainable tensors (its own ``_param_fields`` and those of the functions
it holds).
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from ..config import config

__all__ = [
    "Function", "DeterministicFunction", "UncertainFunction",
    "ConstantFunction", "AddedFunction", "MultipliedFunction",
    "MeanFunction", "Saturation", "FunctionStack", "LambdaFunction",
    "GradientNorm", "as_deterministic", "concatenate_inputs", "as_tensor",
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
    #: Attributes holding trainable parameters: tensors, or tuples of
    #: tensors and ``None``.
    _param_fields = ()

    def __call__(self, *points):
        """Evaluate at ``points`` (positional inputs are concatenated)."""
        return self.evaluate(concatenate_inputs(*points))

    def evaluate(self, points):
        """Evaluate the function at a 2D batch of points."""
        raise NotImplementedError("must be implemented by the child class")

    # -- parameters (functional, ``safe_learning_tpu/functions/base.py:
    # 129-187``) -----------------------------------------------------------
    @property
    def parameters_dict(self):
        """Nested dictionary of this function's trainable parameters.

        Its own ``_param_fields``, then, under the attribute's name, the
        non-empty ``parameters_dict`` of every function it holds.
        """
        params = {name: getattr(self, name) for name in self._param_fields}
        for name, child in vars(self).items():
            if isinstance(child, Function):
                sub = child.parameters_dict
                if sub:
                    params[name] = sub
        return params

    def with_parameters(self, params):
        """Return a copy of this function with updated parameters.

        ``params`` has the layout of :attr:`parameters_dict`, or a subset
        of it. Unknown names raise ``ValueError``: attaching them would
        leave the real parameters unchanged while reporting success.
        """
        allowed = set(self._param_fields) | {
            name for name, value in vars(self).items()
            if isinstance(value, Function) or torch.is_tensor(value)}
        new = copy.copy(self)
        for name, value in params.items():
            if name not in allowed:
                raise ValueError(
                    "{} has no parameter field {!r} (expected a subset "
                    "of {})".format(type(self).__name__, name,
                                    sorted(allowed)))
            current = getattr(new, name)
            if isinstance(current, Function):
                value = current.with_parameters(value)
            setattr(new, name, value)
        return new

    def copy_parameters(self, other):
        """Return a copy of this function with ``other``'s parameters."""
        return self.with_parameters(other.parameters_dict)

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

    def gradient(self, points):
        """Spatial gradient by autodiff, shape ``(N, input_dim)``.

        The counterpart of ``jax.vmap(jax.grad(...))``
        (``safe_learning_tpu/functions/base.py:224-238``): the gradient of
        the summed output at each point. Functions with a closed form
        (``Triangulation``, ``QuadraticFunction``) override it.
        """
        points = torch.atleast_2d(as_tensor(points))

        def scalar(x):
            return self.evaluate(x[None, :]).sum()

        return torch.func.vmap(torch.func.grad(scalar))(points)


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

    def is_scalar(self):
        """Whether the constant holds one number."""
        if torch.is_tensor(self.constant):
            return self.constant.numel() == 1
        return np.size(self.constant) == 1


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

    def split_scalar_factor(self, error_prefix):
        """Split into ``(scalar_constant, inner_function)`` or raise.

        The derived margins (``errorbounds``) support a product only when
        exactly one factor is a scalar :class:`ConstantFunction`, such as
        ``-value_function`` (``safe_learning_tpu/functions/base.py:
        319-337``). Raises ``NotImplementedError``, its message starting
        with ``error_prefix``, otherwise.
        """
        f1, f2 = self.fun1, self.fun2
        if isinstance(f1, ConstantFunction) and f1.is_scalar():
            return f1, f2
        if isinstance(f2, ConstantFunction) and f2.is_scalar():
            return f2, f1
        raise NotImplementedError(
            error_prefix + " supports MultipliedFunction candidates "
            "only with one scalar-constant factor")


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
        """Fan a multi-output measurement out to the members.

        Column ``i`` of ``y`` goes to member ``i``; returns a new stack.
        """
        y = np.atleast_2d(y)
        new = copy.copy(self)
        new.functions = tuple(fun.add_data_point(x, y[:, i:i + 1])
                              for i, fun in enumerate(self.functions))
        return new


class GradientNorm(DeterministicFunction):
    """Per-state norm of another function's spatial gradient.

    A local Lipschitz constant for a Lyapunov candidate
    (``safe_learning_tpu/functions/base.py:341-379``). ``ord`` is ``inf``
    for the largest absolute partial derivative, 1 for their sum, or
    ``None`` for the elementwise ``|grad|`` (one column per dimension,
    reduced later by the threshold's L1 norm).
    """

    def __init__(self, fun, ord=None):
        if not hasattr(fun, "gradient"):
            raise TypeError("fun must define gradient(points)")
        if not (ord is None or ord == 1 or np.isposinf(ord)):
            raise ValueError("unsupported ord: {}".format(ord))
        self.fun = fun
        self.ord = ord
        self.input_dim = fun.input_dim
        self.output_dim = 1 if ord is not None else fun.input_dim

    def evaluate(self, points):
        """Evaluate the function at ``points``."""
        grad = self.fun.gradient(points).abs()
        grad = grad.reshape(grad.shape[0], -1)
        if self.ord is None:
            return grad
        if self.ord == 1:
            return grad.sum(dim=1, keepdim=True)
        return grad.amax(dim=1, keepdim=True)


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
