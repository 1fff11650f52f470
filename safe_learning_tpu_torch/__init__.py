"""safe_learning_tpu_torch: the PyTorch/CUDA port of ``safe_learning_tpu``.

Lyapunov stability verification of GP-modelled dynamics on a state grid,
in PyTorch, with the JAX package's Pallas TPU kernels rewritten by hand as
CUDA kernels for Hopper (``csrc/``). The JAX package stays the reference:
module names mirror it, and the tests hold each ported module against it.

Ported so far: grids, the function algebra with ``Saturation``,
``FunctionStack`` and ``GradientNorm``, linear maps, neural networks,
the ``Triangulation`` and ``PiecewiseConstant`` interpolants, Gaussian
processes with stationary, linear and composite kernels,
``StackedGaussianProcess``, online GP updates (``add_data_point`` and the
device append), the log marginal likelihood, hyperparameter fitting and
posterior sampling, the inverted pendulum, the cart-pole and the Van der
Pol oscillator, the fused, the streamed and the adaptive
``Lyapunov.update_safe_set`` sweeps, ``smallest_boundary_value`` and
``get_lyapunov_region`` (a C++ flood fill, ``native/``), checkpoints,
and the policy-facing Lyapunov pieces
(``safety_constraint``, ``v_decrease_bound``), safe exploration
(``get_safe_sample``, ``get_safe_sample_batch``), dynamic programming
(``PolicyIteration``: the exact PWL value solve, policy ascent with the
Lyapunov Lagrangian, ``policy_iteration`` and
``discrete_policy_optimization``), the closed-loop analysis tools
(``compute_roa``, ``reward_rollout``), all of ``utils``, the float64
oracle and the margin calibration, refined sweeps included, and the
derived margins of ``errorbounds`` (``analytic_certificate_margin``,
``analytic_exploration_margin``, with per-point and per-candidate forms),
their rounding unit re-derived for the H100's float32 path, the rigor
modes as float64 checks on the card (``ops.extended_verify``),
``plotting`` and ``profiling``, a module for every example script
(``examples``), and the grid-sharded sweeps over meshes and
``torch.distributed`` ranks (``parallel``). The port runs on ``cuda:0`` unless the caller sets ``config.device = "cpu"``;
nothing falls back to the CPU when CUDA is missing.
"""

from .config import config
from .grids import DimensionError, GridWorld
from .functions import (AddedFunction, ConstantFunction,
                        DeterministicFunction, Function, FunctionStack,
                        GradientNorm, LambdaFunction, LinearSystem,
                        LyapunovNetwork, MeanFunction, MultipliedFunction,
                        NeuralNetwork, PiecewiseConstant, QuadraticFunction,
                        RBFNetwork, Saturation, Triangulation,
                        UncertainFunction, as_deterministic)
from .functions.gp import (ActiveDims, GaussianProcess, GPRCached,
                           GPSampledFunction, LinearKernel, Matern12,
                           Matern32, Matern52, RBF, StackedGaussianProcess,
                           StackedSampledFunction, fit_gp_hyperparameters,
                           sample_gp_function)
from .lyapunov import (Lyapunov, get_lyapunov_region,
                       smallest_boundary_value)
from .dynamics import CartPole, InvertedPendulum, VanDerPol
from .explore import (get_safe_sample, get_safe_sample_batch,
                      perturb_actions)
from .rl import OptimizationError, PolicyIteration
from .analysis import (compute_closedloop_response, compute_roa, gridify,
                       reward_rollout)
from . import (analysis, checkpoints, convert, errorbounds, oracle, parallel,
               plotting, profiling, rl, utils)

__version__ = "0.1.0"

__all__ = [
    "config", "GridWorld", "DimensionError", "AddedFunction",
    "ConstantFunction", "DeterministicFunction", "Function",
    "FunctionStack", "GradientNorm", "LambdaFunction", "LinearSystem",
    "LyapunovNetwork", "MeanFunction", "MultipliedFunction",
    "NeuralNetwork", "PiecewiseConstant", "QuadraticFunction",
    "RBFNetwork", "Saturation", "Triangulation", "UncertainFunction",
    "as_deterministic", "GaussianProcess", "GPRCached",
    "StackedGaussianProcess", "GPSampledFunction", "StackedSampledFunction",
    "fit_gp_hyperparameters", "sample_gp_function",
    "ActiveDims", "LinearKernel", "Matern12", "Matern32", "Matern52", "RBF",
    "Lyapunov", "InvertedPendulum", "CartPole", "VanDerPol",
    "get_safe_sample",
    "get_safe_sample_batch", "perturb_actions",
    "PolicyIteration", "OptimizationError", "compute_roa", "reward_rollout",
    "compute_closedloop_response", "gridify", "analysis", "checkpoints",
    "convert", "errorbounds", "oracle", "parallel", "plotting",
    "profiling", "rl",
    "utils",
    "smallest_boundary_value", "get_lyapunov_region",
]
