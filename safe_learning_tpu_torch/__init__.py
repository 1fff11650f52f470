"""safe_learning_tpu_torch: the PyTorch/CUDA port of ``safe_learning_tpu``.

Lyapunov stability verification of GP-modelled dynamics on a state grid,
in PyTorch, with the JAX package's Pallas TPU kernels rewritten by hand as
CUDA kernels for Hopper (``csrc/``). The JAX package stays the reference:
module names mirror it, and the tests hold each ported module against it.

Ported so far: grids, the function algebra with ``Saturation`` and
``FunctionStack``, linear maps, Gaussian processes with stationary,
linear and composite kernels, ``StackedGaussianProcess``, the inverted
pendulum, the LQR solvers, the fused ``Lyapunov.update_safe_set`` sweep
and the float64 oracle. Set
``config.device`` to ``"cuda:0"`` to run on the GPU; nothing falls back
to the CPU when CUDA is missing.
"""

from .config import config
from .grids import DimensionError, GridWorld
from .functions import (AddedFunction, ConstantFunction,
                        DeterministicFunction, Function, FunctionStack,
                        LambdaFunction, LinearSystem, MeanFunction,
                        MultipliedFunction, QuadraticFunction, Saturation,
                        UncertainFunction, as_deterministic)
from .functions.gp import (ActiveDims, GaussianProcess, LinearKernel,
                           Matern12, Matern32, Matern52, RBF,
                           StackedGaussianProcess)
from .lyapunov import Lyapunov
from .dynamics import InvertedPendulum
from . import convert, oracle, utils

__version__ = "0.1.0"

__all__ = [
    "config", "GridWorld", "DimensionError", "AddedFunction",
    "ConstantFunction", "DeterministicFunction", "Function",
    "FunctionStack", "LambdaFunction", "LinearSystem", "MeanFunction",
    "MultipliedFunction", "QuadraticFunction", "Saturation",
    "UncertainFunction", "as_deterministic", "GaussianProcess",
    "StackedGaussianProcess", "ActiveDims", "LinearKernel", "Matern12",
    "Matern32", "Matern52", "RBF", "Lyapunov", "InvertedPendulum",
    "convert", "oracle", "utils",
]
