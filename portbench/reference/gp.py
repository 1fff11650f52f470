"""Plain GP regression: covariances, the float64 factorisation, the
posterior in blocks.

A ``Precision`` says how the per-query arithmetic runs: ``float64`` (the
reference) or ``tf32`` (the control: float32 values whose every matrix
product takes its operands rounded to TF32's 10-bit mantissa, as the
H100's tensor cores do, emulated so that it runs alike on the CPU). The
factorisation of the kernel matrix is always float64 on the host.
"""

from __future__ import annotations

import numpy as np
import torch


class Precision:
    """``name`` is ``"float64"`` or ``"tf32"``; ``device`` where the
    per-query work runs."""

    def __init__(self, name="float64", device="cpu"):
        if name not in ("float64", "tf32"):
            raise ValueError("precision must be float64 or tf32")
        self.name = name
        self.device = torch.device(device)
        self.dtype = torch.float64 if name == "float64" else torch.float32

    def tensor(self, value):
        """``value`` as a tensor of this precision on its device."""
        return torch.as_tensor(np.asarray(value), dtype=self.dtype,
                               device=self.device) \
            if not torch.is_tensor(value) else value.to(self.device,
                                                         self.dtype)

    def mm(self, a, b):
        """The matrix product ``a @ b`` at this precision."""
        if self.name == "tf32":
            return round_tf32(a) @ round_tf32(b)
        return a @ b


def round_tf32(x):
    """Float32 ``x`` rounded to the nearest TF32 value (10 mantissa bits,
    ties away from zero)."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


# ---------------------------------------------------------------------------
# Covariances. ``cross(x, z, prec)`` is K(x, z) (len(x), len(z)); ``diag``
# its diagonal at x. ``dims`` selects input columns.
# ---------------------------------------------------------------------------
class Linear:
    """``x diag(variances) z^T`` over ``dims``."""

    def __init__(self, variances, dims):
        self.variances = np.atleast_1d(np.asarray(variances, np.float64))
        self.dims = list(dims)

    def cross(self, x, z, prec):
        v = prec.tensor(self.variances)
        return prec.mm(x[:, self.dims] * v, z[:, self.dims].T)

    def diag(self, x, prec):
        v = prec.tensor(self.variances)
        return (x[:, self.dims] ** 2 * v).sum(dim=1)


class Stationary:
    """``variance * f(r^2)`` of the scaled distance over ``dims``:
    ``family`` ``rbf`` (``exp(-r^2 / 2)``) or ``matern32``
    (``(1 + sqrt(3) r) exp(-sqrt(3) r)``)."""

    def __init__(self, family, variance, lengthscales, dims):
        if family not in ("rbf", "matern32"):
            raise ValueError("unknown stationary family " + family)
        self.family = family
        self.variance = float(variance)
        self.lengthscales = np.broadcast_to(
            np.asarray(lengthscales, np.float64), (len(dims),)).copy()
        self.dims = list(dims)

    def cross(self, x, z, prec):
        ls = prec.tensor(self.lengthscales)
        xs, zs = x[:, self.dims] / ls, z[:, self.dims] / ls
        r2 = torch.zeros((len(x), len(z)), dtype=x.dtype, device=x.device)
        for j in range(len(self.dims)):
            r2 += (xs[:, j:j + 1] - zs[:, j][None, :]) ** 2
        if self.family == "rbf":
            return self.variance * torch.exp(-0.5 * r2)
        r = torch.sqrt(3.0 * r2)
        return self.variance * (1.0 + r) * torch.exp(-r)

    def diag(self, x, prec):
        return torch.full((len(x),), self.variance, dtype=x.dtype,
                          device=x.device)


class Sum:
    def __init__(self, *parts):
        self.parts = parts

    def cross(self, x, z, prec):
        return sum(p.cross(x, z, prec) for p in self.parts)

    def diag(self, x, prec):
        return sum(p.diag(x, prec) for p in self.parts)


class Product:
    def __init__(self, *parts):
        self.parts = parts

    def cross(self, x, z, prec):
        out = self.parts[0].cross(x, z, prec)
        for p in self.parts[1:]:
            out = out * p.cross(x, z, prec)
        return out

    def diag(self, x, prec):
        out = self.parts[0].diag(x, prec)
        for p in self.parts[1:]:
            out = out * p.diag(x, prec)
        return out


def factorize(kernel, x, noise):
    """``(chol_inv, jitter)`` of ``K(x, x) + noise I`` in float64 on the
    host. A matrix that is not positive definite is retried with a
    growing jitter (64 eps times its largest diagonal, then ten times
    more), the rule of the upstream GP."""
    prec = Precision("float64", "cpu")
    xt = torch.as_tensor(x, dtype=torch.float64)
    n = len(x)
    a = kernel.cross(xt, xt, prec) + float(noise) * torch.eye(
        n, dtype=torch.float64)
    scale = float(a.diagonal().max()) if n else 1.0
    jitter = 0.0
    for _ in range(16):
        chol, info = torch.linalg.cholesky_ex(
            a + jitter * torch.eye(n, dtype=torch.float64))
        if int(info) == 0:
            break
        jitter = max(64.0 * np.finfo(np.float64).eps * scale, 10 * jitter)
    else:
        raise np.linalg.LinAlgError("kernel matrix not positive definite")
    chol_inv = torch.linalg.solve_triangular(
        chol, torch.eye(n, dtype=torch.float64), upper=False)
    return chol_inv.numpy(), jitter


class GPGroup:
    """Outputs ``columns`` of a GP that share one covariance: ``kernel``,
    ``noise``, ``beta`` and the prior mean rows ``prior`` (``len(columns)
    x input_dim``, the mean is ``z @ prior.T``)."""

    def __init__(self, kernel, noise, beta, columns, prior):
        self.kernel = kernel
        self.noise = float(noise)
        self.beta = float(beta)
        self.columns = list(columns)
        self.prior = np.asarray(prior, np.float64).reshape(
            len(self.columns), -1)


class GP:
    """The exact posterior of ``groups`` on the data ``(x, y)``
    (float64 numpy, ``y`` with one column per output)."""

    def __init__(self, groups, x, y, prec):
        self.groups = groups
        self.prec = prec
        self.output_dim = sum(len(g.columns) for g in groups)
        x = np.asarray(x, np.float64)
        y = np.asarray(y, np.float64)
        self.n = len(x)
        self.x = prec.tensor(x)
        self.parts = []
        for g in groups:
            chol_inv, _ = factorize(g.kernel, x, g.noise)
            target = y[:, g.columns] - x @ g.prior.T
            alpha = chol_inv @ target
            self.parts.append((g, prec.tensor(chol_inv), prec.tensor(alpha),
                               prec.tensor(g.prior)))

    def block(self):
        """Queries a block holds, so that ``K(x, q)`` stays near 2^26
        values."""
        return max(1024, 2 ** 26 // max(self.n, 1))

    def evaluate(self, z):
        """``(mean, beta * std)`` at the queries ``z`` (a tensor of this
        precision), each ``(len(z), output_dim)``; variances clamped at
        1e-12 as the upstream GP does."""
        prec = self.prec
        mean = torch.empty((len(z), self.output_dim), dtype=prec.dtype,
                           device=prec.device)
        err = torch.empty_like(mean)
        for lo in range(0, len(z), self.block()):
            zb = z[lo:lo + self.block()]
            for g, chol_inv, alpha, prior in self.parts:
                k = g.kernel.cross(self.x, zb, prec)
                a = prec.mm(chol_inv, k)
                m = prec.mm(a.T, alpha) + prec.mm(zb, prior.T)
                var = torch.clamp(g.kernel.diag(zb, prec)
                                  - (a * a).sum(dim=0), min=1e-12)
                sd = g.beta * torch.sqrt(var)
                for j, c in enumerate(g.columns):
                    mean[lo:lo + len(zb), c] = m[:, j]
                    err[lo:lo + len(zb), c] = sd
        return mean, err
