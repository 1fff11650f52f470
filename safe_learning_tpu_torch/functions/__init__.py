"""Function objects: the base algebra, linear maps, neural networks,
simplex interpolation and Gaussian processes."""

from .base import (AddedFunction, ConstantFunction, DeterministicFunction,
                   Function, FunctionStack, GradientNorm, LambdaFunction,
                   MeanFunction, MultipliedFunction, Saturation,
                   UncertainFunction, as_deterministic, concatenate_inputs)
from .linear import LinearSystem, QuadraticFunction
from .neural import LyapunovNetwork, NeuralNetwork, RBFNetwork
from .simplex import PiecewiseConstant, Triangulation

__all__ = [
    "AddedFunction", "ConstantFunction", "DeterministicFunction",
    "Function", "FunctionStack", "GradientNorm", "LambdaFunction",
    "MeanFunction", "MultipliedFunction", "Saturation", "UncertainFunction",
    "as_deterministic", "concatenate_inputs",
    "LinearSystem", "QuadraticFunction",
    "LyapunovNetwork", "NeuralNetwork", "RBFNetwork",
    "PiecewiseConstant", "Triangulation",
]
