"""The H100's peaks and the operations of a GP predict: a frozen copy of
``chip_smoke.py``'s ``kernel_bound`` and ``stationary_ops``, so
that a change to the program's scripts cannot move a roofline share."""

from __future__ import annotations

#: NVIDIA H100 SXM data sheet, dense, at 700 W: FP32 on the CUDA cores,
#: FP64 on the CUDA cores and on the tensor cores (DMMA), HBM3.
FP32_FLOPS = 67e12
FP64_FLOPS = 34e12
FP64_TC_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12

#: Operations of one stationary covariance from r^2.
COV_OPS = {"rbf": 2, "matern12": 4, "matern32": 7, "matern52": 10}


def stationary_ops(kind, d):
    """Operations of ``k_j`` per row and query: ``d`` differences, ``d``
    squares and ``d - 1`` adds for ``r^2``, the covariance, the scale and
    the mask."""
    return 3 * d - 1 + COV_OPS[kind] + 2


def kernel_bound(n_q, d, count, p, n_out, k_ops, itemsize):
    """The least milliseconds of one predict at these inputs, and what
    bounds it (``"operations"`` or ``"bytes"``).

    Per query and output ``count^2`` operations for ``L^-1 K`` and ``(p +
    1)(2 count - 1)`` for the reductions, per query ``count * k_ops`` for
    k; 4-byte values at ``FP32_FLOPS``, 8-byte ones with the product at
    ``FP64_TC_FLOPS`` and the rest at ``FP64_FLOPS``. Bytes: the queries,
    the active rows of x, ``chol_inv``, alpha and the mask read once, the
    outputs written once.
    """
    product = n_q * n_out * count * count
    rest = n_q * (n_out * (p + 1) * max(2 * count - 1, 0) + count * k_ops)
    values = (n_q * d + count * d + n_out * count * (count + p) + count
              + n_q * n_out * (p + 1))
    if itemsize == 8:
        ops_ms = (product / FP64_TC_FLOPS + rest / FP64_FLOPS) * 1e3
    else:
        ops_ms = (product + rest) / FP32_FLOPS * 1e3
    bytes_ms = values * itemsize / HBM_BYTES_PER_S * 1e3
    if ops_ms >= bytes_ms:
        return ops_ms, "operations"
    return bytes_ms, "bytes"
