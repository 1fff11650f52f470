"""Function objects: the base algebra, linear maps and Gaussian processes."""

from .base import (AddedFunction, ConstantFunction, DeterministicFunction,
                   Function, FunctionStack, LambdaFunction, MeanFunction,
                   MultipliedFunction, Saturation, UncertainFunction,
                   as_deterministic, concatenate_inputs)
from .linear import LinearSystem, QuadraticFunction

__all__ = [
    "AddedFunction", "ConstantFunction", "DeterministicFunction",
    "Function", "FunctionStack", "LambdaFunction", "MeanFunction",
    "MultipliedFunction", "Saturation", "UncertainFunction",
    "as_deterministic", "concatenate_inputs",
    "LinearSystem", "QuadraticFunction",
]
