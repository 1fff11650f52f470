"""Global configuration for the PyTorch/CUDA port.

Counterpart of ``safe_learning_tpu/config.py``. The working dtype is
float32 by default with a float64 switch, and the device is the GPU,
``cuda:0``, unless the caller sets ``config.device = "cpu"`` (as the CPU
tests do). Nothing is checked at import, and nothing in the package moves
work to the CPU because CUDA is missing: on a PyTorch built without CUDA
the first tensor made on the default device raises.

Importing this module turns TF32 off for matmuls and cuDNN and keeps the
float32 matmul precision at ``"highest"``. TF32 keeps about ten mantissa
bits, the Hopper counterpart of the single bf16 MXU pass that flipped
marginal decrease checks on the TPU (``safe_learning_tpu/ops/
gp_kernel.py:203-209``).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["Configuration", "config"]

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


class Configuration:
    """Global configuration singleton.

    Attributes
    ----------
    dtype : torch.dtype
        Working floating dtype: ``torch.float32`` (default) or
        ``torch.float64``.
    device : torch.device
        Device every model tensor and sweep lives on. Defaults to
        ``cuda:0``; set it to ``"cpu"`` to run the kernels' plain PyTorch
        versions on the CPU.
    gp_batch_size : int
        Grid points per batch when a sweep is streamed.
    fused_sweep_limit : int
        Largest grid verified as one fused pass; larger non-adaptive grids
        stream in batches of ``gp_batch_size`` states.
    certificate_margin, level_margin : float
        Default conservatism margins for the decrease and level
        comparisons (see ``safe_learning_tpu/config.py:65-79``).
    use_kernels : bool
        Route the GP predicts through the hand-written kernels
        (``ops/gp_kernel.py``). On a CPU tensor that route is each
        kernel's plain PyTorch version.
    kernel_max_capacity : int
        Largest GP data capacity routed through the kernels (a stack of S
        GPs when ``S * capacity**2 <= kernel_max_capacity**2``); larger
        GPs take the plain matmul chain.
    fp_error_factor : float
        The unit roundoff of the derived margins (``errorbounds``) is
        ``fp_error_factor * eps / 2`` of the working dtype: one unit must
        cover the worst single operation the rounding model charges once.
    """

    def __init__(self):
        self._dtype = torch.float32
        self._device = torch.device("cuda:0")
        self.gp_batch_size = 2 ** 16
        self.fused_sweep_limit = 2 ** 24
        self.certificate_margin = 0.0
        self.level_margin = 0.0
        self.use_kernels = True
        self.kernel_max_capacity = 2048
        # The rounding model of ``errorbounds`` charges one unit u per
        # operation, transcendentals included, so u must cover the worst
        # single operation on the port's float32 path on the H100:
        # - +, -, *, /, sqrt and FMA are IEEE round-to-nearest (nvcc's
        #   defaults -prec-div=true -prec-sqrt=true, no fast-math in
        #   ``ops/build.py`` nor in torch's CUDA kernels): 1 x eps/2;
        # - dot products (the kernels' tiled and 64-row-panel solves,
        #   cuBLAS with TF32 off) sum in their own order; gamma_n holds
        #   for any order, at the same unit;
        # - expf, sinf, cosf and tanhf (the kernels' covariances, torch's
        #   exp/sin/cos/tanh): at most 2 ulp by the CUDA Math API's
        #   table, 2 ulp <= 2 * 2^-23 |y| = 4 x eps/2;
        # - torch's CUDA sigmoid is 1 / (1 + exp(-x)): exp, an add and a
        #   divide, at most (1 + u) / ((1 - 4u)(1 - u)) - 1 = 6u + O(u^2)
        #   relative, the largest charge, hence 6 (the O(u^2) rest is
        #   absorbed by ``_finalize_margin``'s own-rounding factor).
        # ``chip_smoke.py``'s ``transcendental_ulps`` measures each
        # function's worst relative error on the card and fails if one
        # exceeds this factor.
        self.fp_error_factor = 6.0

    @property
    def dtype(self):
        """Working floating dtype."""
        return self._dtype

    @dtype.setter
    def dtype(self, value):
        """Set the working dtype (float32 or float64)."""
        if value not in (torch.float32, torch.float64):
            raise ValueError("dtype must be torch.float32 or torch.float64")
        self._dtype = value

    @property
    def np_dtype(self):
        """Numpy equivalent of the working dtype."""
        return np.dtype("float64" if self._dtype == torch.float64
                        else "float32")

    @property
    def device(self):
        """Device of model tensors and sweeps."""
        return self._device

    @device.setter
    def device(self, value):
        """Set the device (a ``torch.device`` or a string)."""
        self._device = torch.device(value)

    def __repr__(self):
        """Debug representation."""
        return "Configuration(dtype={}, device={}, gp_batch_size={})".format(
            self._dtype, self._device, self.gp_batch_size)


config = Configuration()
