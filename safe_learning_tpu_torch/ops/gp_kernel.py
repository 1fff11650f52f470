"""Fused GP posterior predict: a hand-written CUDA kernel and its plain twin.

Replaces the Pallas TPU kernel ``_gp_predict_kernel``
(``safe_learning_tpu/ops/gp_kernel.py:169-214``) behind
``fused_gp_predict`` (``:612-650``). The kernel is
``csrc/gp_predict.cu``; its header says what bounds it on the H100 and
what the design does about that. It is built with ``nvcc`` for
``sm_90a`` at first use (:mod:`.build`) and bound with ``ctypes``.

- :func:`gp_predict_plain` is the same math in plain PyTorch
  (per-dimension differences, as the Pallas body). The CPU tests use it,
  ``chip_smoke.py`` holds the kernel against it on the card, and the
  autograd rule differentiates it.
- :func:`gp_predict_cuda` launches the kernel and counts its launches in
  ``gp_predict_cuda.launches``.
- :func:`fused_gp_predict` dispatches on the device of its input: a CPU
  tensor goes to the plain version, a CUDA tensor to the kernel. Nothing
  falls back from the kernel to the plain version.

Layout: queries are ``(Q, d)`` row-major and outputs ``(Q, p)`` and
``(Q,)``; the JAX wrapper's transposes exist only for the TPU's lanes.
"""

from __future__ import annotations

import ctypes
import functools

import torch

__all__ = ["KINDS", "fused_gp_predict", "gp_predict_plain",
           "gp_predict_cuda", "kernel_library"]

#: Stationary families, in the order of the kernel's ``kind`` switch.
KINDS = ("rbf", "matern12", "matern32", "matern52")


def gp_predict_plain(points_scaled, x_scaled, chol_inv, alpha, mask,
                     kernel_variance_s2, kind="rbf"):
    """Plain PyTorch version of the fused predict (same contract).

    Parameters
    ----------
    points_scaled : (Q, d) queries divided by the lengthscales
    x_scaled : (cap, d) training inputs divided by the lengthscales
    chol_inv : (cap, cap) inverse Cholesky factor of the scaled kernel
    alpha : (cap, p) cached solve against the targets
    mask : (cap,) active-row mask
    kernel_variance_s2 : scalar, kernel variance times scale^2
    kind : str, stationary kernel family

    Returns
    -------
    mean_num : (Q, p), ``a^T alpha``; var_num : (Q,), ``sum(a^2)``, where
    ``a = chol_inv @ k``.
    """
    from ..functions.gp import STATIONARY_COVARIANCES

    r2 = None
    for i in range(points_scaled.shape[1]):
        diff = x_scaled[:, i][:, None] - points_scaled[:, i][None, :]
        r2 = diff * diff if r2 is None else r2 + diff * diff
    k = (STATIONARY_COVARIANCES[kind](r2) * kernel_variance_s2
         * mask[:, None])
    a = torch.matmul(chol_inv, k)
    return torch.matmul(a.T, alpha), (a * a).sum(dim=0)


@functools.lru_cache(maxsize=None)
def kernel_library():
    """Build (first call only) and bind ``csrc/gp_predict.cu``."""
    from .build import load_library

    lib = load_library("gp_predict", ["gp_predict.cu"])
    args = ([ctypes.c_void_p] * 6
            + [ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
               ctypes.c_int]
            + [ctypes.c_void_p] * 3)
    for fn in (lib.gp_predict_f32, lib.gp_predict_f64):
        fn.argtypes = args
        fn.restype = ctypes.c_int
    lib.gp_predict_error_string.argtypes = [ctypes.c_int]
    lib.gp_predict_error_string.restype = ctypes.c_char_p
    lib.gp_predict_limits.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
    lib.gp_predict_limits.restype = ctypes.c_int
    return lib


def _kernel_limits(lib):
    d_max, p_max = ctypes.c_int(), ctypes.c_int()
    lib.gp_predict_limits(ctypes.byref(d_max), ctypes.byref(p_max))
    return d_max.value, p_max.value


def gp_predict_cuda(points_scaled, x_scaled, chol_inv, alpha, mask,
                    kernel_variance_s2, kind="rbf"):
    """Launch the CUDA kernel (same contract as :func:`gp_predict_plain`).

    ``chol_inv`` must be lower-triangular, as the GP's host island makes
    it: the kernel skips the zero upper part. Every tensor must be a
    contiguous CUDA tensor of one float dtype on one device;
    ``kernel_variance_s2`` may also be a Python number. Launches on the
    current stream without synchronising.
    """
    dtype = points_scaled.dtype
    device = points_scaled.device
    if dtype not in (torch.float32, torch.float64):
        raise TypeError("gp_predict_cuda takes float32 or float64, not "
                        "{}".format(dtype))
    if kind not in KINDS:
        raise ValueError("unknown stationary kind {!r}".format(kind))
    if not torch.is_tensor(kernel_variance_s2):
        kernel_variance_s2 = torch.tensor(kernel_variance_s2, dtype=dtype,
                                          device=device)
    tensors = dict(points_scaled=points_scaled, x_scaled=x_scaled,
                   chol_inv=chol_inv, alpha=alpha, mask=mask,
                   kernel_variance_s2=kernel_variance_s2)
    for name, t in tensors.items():
        if t.device != device or t.dtype != dtype:
            raise ValueError("{} is {} on {}; expected {} on {}".format(
                name, t.dtype, t.device, dtype, device))
        if not t.is_contiguous():
            raise ValueError("{} must be contiguous".format(name))
    if device.type != "cuda":
        raise ValueError("gp_predict_cuda needs CUDA tensors, got "
                         "{}".format(device))
    n_q, d = points_scaled.shape
    cap = x_scaled.shape[0]
    p = alpha.shape[1]
    if (x_scaled.shape != (cap, d) or chol_inv.shape != (cap, cap)
            or alpha.shape != (cap, p) or mask.shape != (cap,)
            or kernel_variance_s2.numel() != 1):
        raise ValueError("inconsistent shapes: points {}, x {}, chol_inv "
                         "{}, alpha {}, mask {}".format(
                             tuple(points_scaled.shape),
                             tuple(x_scaled.shape), tuple(chol_inv.shape),
                             tuple(alpha.shape), tuple(mask.shape)))
    lib = kernel_library()
    d_max, p_max = _kernel_limits(lib)
    if d > d_max or p > p_max:
        raise ValueError("the kernel takes d <= {} and p <= {}; got d={}, "
                         "p={}".format(d_max, p_max, d, p))

    mean_num = torch.empty((n_q, p), dtype=dtype, device=device)
    var_num = torch.empty((n_q,), dtype=dtype, device=device)
    if n_q == 0:
        return mean_num, var_num
    fn = lib.gp_predict_f32 if dtype == torch.float32 else lib.gp_predict_f64
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(points_scaled.data_ptr(), x_scaled.data_ptr(),
                 chol_inv.data_ptr(), alpha.data_ptr(), mask.data_ptr(),
                 kernel_variance_s2.data_ptr(), n_q, d, cap, p,
                 KINDS.index(kind), mean_num.data_ptr(), var_num.data_ptr(),
                 stream)
    if err != 0:
        raise RuntimeError("gp_predict kernel launch failed: CUDA error "
                           "{} ({})".format(
                               err, lib.gp_predict_error_string(err)
                               .decode()))
    gp_predict_cuda.launches += 1
    return mean_num, var_num


#: Kernel launches since the last reset (``chip_smoke.py`` resets it).
gp_predict_cuda.launches = 0


class _FusedPredict(torch.autograd.Function):
    """Kernel forward; the backward differentiates the plain version.

    The counterpart of ``_fused_predict_core``'s ``custom_jvp``
    (``safe_learning_tpu/ops/gp_kernel.py:724-731``): gradients through
    the GP posterior are never silently detached.
    """

    @staticmethod
    def forward(ctx, points_scaled, x_scaled, chol_inv, alpha, mask,
                kernel_variance_s2, kind):
        ctx.kind = kind
        ctx.save_for_backward(points_scaled, x_scaled, chol_inv, alpha,
                              mask, kernel_variance_s2)
        return gp_predict_cuda(points_scaled, x_scaled, chol_inv, alpha,
                               mask, kernel_variance_s2, kind=kind)

    @staticmethod
    def backward(ctx, grad_mean, grad_var):
        saved = ctx.saved_tensors
        needs = ctx.needs_input_grad[:6]
        inputs = [t.detach().requires_grad_(n) for t, n in zip(saved,
                                                               needs)]
        with torch.enable_grad():
            mean_num, var_num = gp_predict_plain(*inputs, kind=ctx.kind)
            wrt = [t for t, n in zip(inputs, needs) if n]
            grads = iter(torch.autograd.grad(
                (mean_num, var_num), wrt, (grad_mean, grad_var),
                allow_unused=True))
        return tuple(next(grads) if n else None for n in needs) + (None,)


def fused_gp_predict(points_scaled, x_scaled, chol_inv, alpha, mask,
                     kernel_variance_s2, kind="rbf"):
    """Fused posterior mean/variance numerators over query points.

    Same contract as :func:`gp_predict_plain`. A CPU tensor goes to the
    plain version; a CUDA tensor goes to the CUDA kernel, or the call
    raises.
    """
    if points_scaled.device.type == "cpu":
        return gp_predict_plain(points_scaled, x_scaled, chol_inv, alpha,
                                mask, kernel_variance_s2, kind=kind)
    if not torch.is_tensor(kernel_variance_s2):
        kernel_variance_s2 = torch.tensor(kernel_variance_s2,
                                          dtype=points_scaled.dtype,
                                          device=points_scaled.device)
    return _FusedPredict.apply(points_scaled.contiguous(),
                               x_scaled.contiguous(), chol_inv.contiguous(),
                               alpha.contiguous(), mask.contiguous(),
                               kernel_variance_s2.contiguous(), kind)
