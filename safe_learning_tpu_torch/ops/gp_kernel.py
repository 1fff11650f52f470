"""Fused GP posterior predicts: hand-written CUDA kernels and plain twins.

Replaces the three Pallas TPU kernels of ``safe_learning_tpu/ops/
gp_kernel.py``:

- ``_gp_predict_kernel`` (``:169-214``, entry ``fused_gp_predict``
  ``:612-650``), a stationary kernel on pre-scaled inputs:
  ``csrc/gp_predict.cu``;
- ``_gp_predict_kernel_general`` (``:271-295``, entry
  ``fused_gp_predict_general`` ``:503-526``), a composite kernel compiled
  to a covariance program, and ``_gp_predict_kernel_stacked``
  (``:347-383``, entry ``fused_gp_predict_stacked`` ``:386-417``), S
  single-output GPs over one training set: both are
  ``csrc/gp_predict_program.cuh``, instantiated for the program (or the S
  programs) by a source file this module renders.

Kernel 1's four variants (``csrc/gp_predict_variants.cu``, the port of
four Pallas design probes under ``benchmarks/``) are built and bound here
(:func:`variants_library`) and launched through kernel 1's checks
(:func:`launch_stationary`) by ``safe_learning_tpu_torch.benchmarks``; no
path of the package routes through them.

Every kernel is built with ``nvcc`` for ``sm_90a`` at first use
(:mod:`.build`) and bound with ``ctypes``; the headers of the CUDA
sources say what bounds each on the H100 and what the design does about
that. Kernels 2 and 3 take one of three bodies, chosen by the library
from the shape alone (:data:`PROGRAM_BODIES`; :func:`program_body` asks
which): tiled up to 128 rows, the panel body above, the streamed body
above :func:`program_panel_max`. For each entry point:

- a ``*_plain`` function is the same math in plain PyTorch (per-dimension
  differences, as the Pallas bodies). The CPU tests use it,
  ``chip_smoke.py`` holds the kernel against it on the card, and the
  autograd rule differentiates it;
- a ``*_cuda`` function launches the kernel and counts its launches in
  its ``launches`` attribute;
- a ``fused_*`` function dispatches on the device of its input: a CPU
  tensor goes to the plain version, a CUDA tensor to the kernel. Nothing
  falls back from the kernel to the plain version.

Each takes ``count``, the GP's number of active rows (``None``: the
capacity). The kernels' loops stop there, which skips only exact zeros
under the GP's precondition (``mask[count:] == 0`` and
``chol_inv[count:, :count] == 0``); the plain versions accept it and
compute at full capacity, as the Pallas kernels do.

Layout: queries are ``(Q, d)`` row-major and outputs ``(Q, p)``,
``(Q,)`` or ``(Q, S)``; the JAX wrappers' transposes exist only for the
TPU's lanes.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib

import torch

__all__ = ["KINDS", "fused_gp_predict", "gp_predict_plain",
           "gp_predict_cuda", "kernel_library", "compile_kernel_program",
           "program_params", "gp_predict_general_plain",
           "gp_predict_stacked_plain", "gp_predict_general_cuda",
           "gp_predict_stacked_cuda", "fused_gp_predict_general",
           "fused_gp_predict_stacked", "render_program_source",
           "program_library", "build_kernels", "variants_library",
           "launch_stationary", "PROGRAM_BODIES", "program_body",
           "program_panel_max", "gp_predict_stacked_streamed_cuda"]

#: Stationary families, in the order of the kernel's ``kind`` switch.
KINDS = ("rbf", "matern12", "matern32", "matern52")

#: Most outputs and most parameters a program library takes (the kernel
#: keeps the parameters in registers; ``csrc/gp_predict_program.cuh``).
PROGRAM_OUTPUTS_MAX = 8
PROGRAM_PARAMS_MAX = 64

#: The bodies of kernels 2 and 3, in the order of ``gp_program_body``'s
#: codes: up to 128 rows, up to the panel body's largest count
#: (:func:`program_panel_max`), and above it.
PROGRAM_BODIES = ("tiled", "panel", "streamed")


# ---------------------------------------------------------------------------
# Shared launch helpers
# ---------------------------------------------------------------------------
def _scalar_tensor(value, like):
    """``value`` as a tensor of ``like``'s dtype and device (a tensor
    passes through). Filled on the device: a copy from the host would make
    the host wait for the device at every launch."""
    if torch.is_tensor(value):
        return value
    return torch.full((), value, dtype=like.dtype, device=like.device)


def _check_tensors(tensors):
    """All tensors CUDA, contiguous, of one float dtype and one device.

    Returns ``(dtype, device)`` of the first.
    """
    first = next(iter(tensors.values()))
    dtype, device = first.dtype, first.device
    if dtype not in (torch.float32, torch.float64):
        raise TypeError("the CUDA kernels take float32 or float64, not "
                        "{}".format(dtype))
    for name, t in tensors.items():
        if t.device != device or t.dtype != dtype:
            raise ValueError("{} is {} on {}; expected {} on {}".format(
                name, t.dtype, t.device, dtype, device))
        if not t.is_contiguous():
            raise ValueError("{} must be contiguous".format(name))
    if device.type != "cuda":
        raise ValueError("the CUDA kernels need CUDA tensors, got "
                         "{}".format(device))
    return dtype, device


def _raise_on_error(err, lib, what):
    if err != 0:
        raise RuntimeError("{} kernel launch failed: CUDA error {} ({})"
                           .format(what, err,
                                   lib.error_string(err).decode()))


def _grads_through_plain(ctx, plain, grad_outputs, n_inputs, **static):
    """Backward of a kernel's autograd rule: differentiate its plain twin.

    The counterpart of the ``custom_jvp``s of ``safe_learning_tpu/ops/
    gp_kernel.py:493-500, 602-609, 724-731``: gradients through the GP
    posterior are never silently detached.
    """
    needs = ctx.needs_input_grad[:n_inputs]
    inputs = [t.detach().requires_grad_(n)
              for t, n in zip(ctx.saved_tensors, needs)]
    with torch.enable_grad():
        outputs = plain(*inputs, **static)
        wrt = [t for t, n in zip(inputs, needs) if n]
        grads = iter(torch.autograd.grad(outputs, wrt, grad_outputs,
                                         allow_unused=True))
    extra = len(ctx.needs_input_grad) - n_inputs
    return tuple(next(grads) if n else None for n in needs) + (None,) * extra


def _active_rows(count, cap):
    """The kernels' row count: ``count``, or ``cap`` for ``None``."""
    count = cap if count is None else int(count)
    if not 0 <= count <= cap:
        raise ValueError("count must lie in [0, {}], got {}".format(cap,
                                                                  count))
    return count


# ---------------------------------------------------------------------------
# Kernel 1: stationary families on pre-scaled inputs
# ---------------------------------------------------------------------------
def gp_predict_plain(points_scaled, x_scaled, chol_inv, alpha, mask,
                     kernel_variance_s2, kind="rbf", count=None):
    """Plain PyTorch version of the fused predict (same contract).

    ``count`` is accepted and ignored: this is the full-capacity math of
    the Pallas kernel, which equals the kernel's count-bounded loops under
    the precondition of :func:`gp_predict_cuda`.

    Parameters
    ----------
    points_scaled : (Q, d) queries divided by the lengthscales
    x_scaled : (cap, d) training inputs divided by the lengthscales
    chol_inv : (cap, cap) inverse Cholesky factor of the scaled kernel
    alpha : (cap, p) cached solve against the targets
    mask : (cap,) active-row mask
    kernel_variance_s2 : scalar, kernel variance times scale^2
    kind : str, stationary kernel family
    count : int or None, active rows (ignored here)

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


def _limits(lib, fn):
    """Bind ``fn(int *d_max, int *p_max)`` and keep its values as
    ``lib.limits``."""
    fn.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
    fn.restype = ctypes.c_int
    d_max, p_max = ctypes.c_int(), ctypes.c_int()
    fn(ctypes.byref(d_max), ctypes.byref(p_max))
    lib.limits = d_max.value, p_max.value


@functools.lru_cache(maxsize=None)
def kernel_library():
    """Build (first call only) and bind ``csrc/gp_predict.cu``."""
    from .build import load_libraries

    (lib,) = load_libraries([_STATIONARY_JOB])
    args = ([ctypes.c_void_p] * 6
            + [ctypes.c_int64] + [ctypes.c_int] * 5
            + [ctypes.c_void_p] * 3)
    for fn in (lib.gp_predict_f32, lib.gp_predict_f64):
        fn.argtypes = args
        fn.restype = ctypes.c_int
    lib.gp_predict_error_string.argtypes = [ctypes.c_int]
    lib.gp_predict_error_string.restype = ctypes.c_char_p
    lib.error_string = lib.gp_predict_error_string
    _limits(lib, lib.gp_predict_limits)
    return lib


@functools.lru_cache(maxsize=None)
def variants_library():
    """Build (first call only) and bind ``csrc/gp_predict_variants.cu``:
    ``gp_pipelined``, ``gp_interleaved`` (after the item size, ``halves``),
    ``gp_folded`` (no mask, no scale) and ``gp_expanded``."""
    from .build import load_libraries

    (lib,) = load_libraries([_VARIANTS_JOB])
    tail = [ctypes.c_int64] + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 3
    for fn, lead in ((lib.gp_pipelined, 6), (lib.gp_expanded, 6),
                     (lib.gp_folded, 4)):
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * lead + tail
        fn.restype = ctypes.c_int
    lib.gp_interleaved.argtypes = ([ctypes.c_int] * 2
                                   + [ctypes.c_void_p] * 6 + tail)
    lib.gp_interleaved.restype = ctypes.c_int
    lib.gp_variant_error_string.argtypes = [ctypes.c_int]
    lib.gp_variant_error_string.restype = ctypes.c_char_p
    lib.error_string = lib.gp_variant_error_string
    _limits(lib, lib.gp_variant_limits)
    return lib


def launch_stationary(entry, library, what, points_scaled, x_scaled,
                      chol_inv, alpha, mask, kernel_variance_s2, kind,
                      count):
    """Check the arguments of kernel 1 or one of its variants, build its
    library and launch it on the current stream without synchronising.

    ``library()`` returns the bound library; ``entry(lib, dtype)`` returns
    the C function and its leading integer arguments; ``what`` names it
    in errors. ``mask`` and ``kernel_variance_s2`` are ``None`` for a
    kernel that takes neither (the folded variant). Returns ``(mean_num,
    var_num, launched)``; ``launched`` is False when there were no
    queries.
    """
    if kind not in KINDS:
        raise ValueError("unknown stationary kind {!r}".format(kind))
    tensors = dict(points_scaled=points_scaled, x_scaled=x_scaled,
                   chol_inv=chol_inv, alpha=alpha)
    if mask is not None:
        kernel_variance_s2 = _scalar_tensor(kernel_variance_s2,
                                            points_scaled)
        tensors.update(mask=mask, kernel_variance_s2=kernel_variance_s2)
    dtype, device = _check_tensors(tensors)
    n_q, d = points_scaled.shape
    cap = x_scaled.shape[0]
    p = alpha.shape[1]
    if (x_scaled.shape != (cap, d) or chol_inv.shape != (cap, cap)
            or alpha.shape != (cap, p)
            or (mask is not None and (mask.shape != (cap,)
                                      or kernel_variance_s2.numel() != 1))):
        raise ValueError("inconsistent shapes: points {}, x {}, chol_inv "
                         "{}, alpha {}, mask {}".format(
                             tuple(points_scaled.shape),
                             tuple(x_scaled.shape), tuple(chol_inv.shape),
                             tuple(alpha.shape),
                             None if mask is None else tuple(mask.shape)))
    count = _active_rows(count, cap)
    lib = library()
    d_max, p_max = lib.limits
    if d > d_max or p > p_max:
        raise ValueError("the kernel takes d <= {} and p <= {}; got d={}, "
                         "p={}".format(d_max, p_max, d, p))

    mean_num = torch.empty((n_q, p), dtype=dtype, device=device)
    var_num = torch.empty((n_q,), dtype=dtype, device=device)
    if n_q == 0:
        return mean_num, var_num, False
    fn, lead = entry(lib, dtype)
    pointers = [t.data_ptr() for t in tensors.values()]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*lead, *pointers, n_q, d, cap, count, p, KINDS.index(kind),
                 mean_num.data_ptr(), var_num.data_ptr(), stream)
    _raise_on_error(err, lib, what)
    return mean_num, var_num, True


def _kernel1_entry(lib, dtype):
    return (lib.gp_predict_f32 if dtype == torch.float32
            else lib.gp_predict_f64), ()


def gp_predict_cuda(points_scaled, x_scaled, chol_inv, alpha, mask,
                    kernel_variance_s2, kind="rbf", count=None):
    """Launch the CUDA kernel (same contract as :func:`gp_predict_plain`).

    ``count`` (``None`` means the capacity) is the number of active rows;
    the kernel's loops stop there. Precondition, which the GP's host
    island (``_host_factorize``, ``_bordered_append``) guarantees:
    ``chol_inv`` is lower-triangular, ``mask[count:] == 0`` and
    ``chol_inv[count:, :count] == 0``, so every skipped term is an exact
    zero. Every tensor must be a contiguous CUDA tensor of one float dtype
    on one device; ``kernel_variance_s2`` may also be a Python number.
    Launches on the current stream without synchronising.
    """
    mean_num, var_num, launched = launch_stationary(
        _kernel1_entry, kernel_library, "gp_predict", points_scaled,
        x_scaled, chol_inv, alpha, mask, kernel_variance_s2, kind, count)
    gp_predict_cuda.launches += launched
    return mean_num, var_num


#: Kernel launches since the last reset (``chip_smoke.py`` resets it).
gp_predict_cuda.launches = 0


class _FusedPredict(torch.autograd.Function):
    """Kernel forward; the backward differentiates the plain version."""

    @staticmethod
    def forward(ctx, points_scaled, x_scaled, chol_inv, alpha, mask,
                kernel_variance_s2, kind, count):
        ctx.kind = kind
        ctx.save_for_backward(points_scaled, x_scaled, chol_inv, alpha,
                              mask, kernel_variance_s2)
        return gp_predict_cuda(points_scaled, x_scaled, chol_inv, alpha,
                               mask, kernel_variance_s2, kind=kind,
                               count=count)

    @staticmethod
    def backward(ctx, grad_mean, grad_var):
        return _grads_through_plain(ctx, gp_predict_plain,
                                    (grad_mean, grad_var), 6, kind=ctx.kind)


def fused_gp_predict(points_scaled, x_scaled, chol_inv, alpha, mask,
                     kernel_variance_s2, kind="rbf", count=None):
    """Fused posterior mean/variance numerators over query points.

    Same contract as :func:`gp_predict_plain`. A CPU tensor goes to the
    plain version; a CUDA tensor goes to the CUDA kernel, or the call
    raises.
    """
    if points_scaled.device.type == "cpu":
        return gp_predict_plain(points_scaled, x_scaled, chol_inv, alpha,
                                mask, kernel_variance_s2, kind=kind,
                                count=count)
    kernel_variance_s2 = _scalar_tensor(kernel_variance_s2, points_scaled)
    return _FusedPredict.apply(points_scaled.contiguous(),
                               x_scaled.contiguous(), chol_inv.contiguous(),
                               alpha.contiguous(), mask.contiguous(),
                               kernel_variance_s2.contiguous(), kind, count)


# ---------------------------------------------------------------------------
# Kernel-structure compiler: Kernel tree -> static program + flat params
# ---------------------------------------------------------------------------
def compile_kernel_program(kernel, input_dim=None, dims=None, params=None):
    """Compile a kernel tree into a static covariance program.

    The counterpart of ``safe_learning_tpu/ops/gp_kernel.py:41-137``, with
    the same programs and the same parameter order. Supports the
    stationary families with ARD lengthscales, ``LinearKernel``,
    ``ActiveDims`` and sums and products of those.

    ``input_dim`` is the dimension of the data the kernel is applied to. A
    scalar parameter broadcasts over every input dimension (as
    ``Kernel.__call__`` does); a vector parameter must span the input
    exactly, else the kernel does not compile. Without ``input_dim`` the
    parameter length is trusted.

    Returns ``(program, params_list)``: ``program`` is a hashable nested
    tuple and ``params_list`` the list of parameter tensors in the
    working dtype, lengthscales stored as reciprocals so that the kernels
    multiply instead of divide (:func:`program_params` flattens them).
    Returns ``None`` if the kernel holds an unsupported node.
    """
    from ..functions.gp import (_KIND_OF, ActiveDims, LinearKernel,
                                ProductKernel, SumKernel)

    if params is None:
        params = []

    def offset():
        return sum(int(p.numel()) for p in params)

    def span_for(n):
        """Input dims a leaf covers, or None when it does not compile."""
        if dims is not None:
            sel = tuple(dims)
        elif input_dim is not None:
            sel = tuple(range(int(input_dim)))
        else:
            sel = tuple(range(n))
        if n != len(sel) and n != 1:
            return None
        return sel

    if type(kernel) in _KIND_OF:
        ls = torch.atleast_1d(kernel.lengthscales)
        sel = span_for(int(ls.shape[0]))
        if sel is None:
            return None
        if ls.shape[0] == 1 and len(sel) > 1:
            ls = ls.expand(len(sel))
        ls_off = offset()
        params.append(1.0 / ls)
        var_off = offset()
        params.append(kernel.variance.reshape(1))
        return (("stationary", _KIND_OF[type(kernel)], sel, ls_off,
                 var_off), params)
    if isinstance(kernel, LinearKernel):
        v = torch.atleast_1d(kernel.variances)
        sel = span_for(int(v.shape[0]))
        if sel is None:
            return None
        if v.shape[0] == 1 and len(sel) > 1:
            v = v.expand(len(sel))
        v_off = offset()
        params.append(v)
        return (("linear", sel, v_off), params)
    if isinstance(kernel, ActiveDims):
        if dims is None:
            sel = tuple(kernel.dims)
        else:
            sel = tuple(dims[i] for i in kernel.dims)
        return compile_kernel_program(kernel.kernel, dims=sel,
                                      params=params)
    if isinstance(kernel, (SumKernel, ProductKernel)):
        left = compile_kernel_program(kernel.k1, input_dim=input_dim,
                                      dims=dims, params=params)
        if left is None:
            return None
        prog1, params = left
        right = compile_kernel_program(kernel.k2, input_dim=input_dim,
                                       dims=dims, params=params)
        if right is None:
            return None
        prog2, params = right
        op = "sum" if isinstance(kernel, SumKernel) else "product"
        return ((op, prog1, prog2), params)
    return None


def program_params(param_list, like):
    """Flat parameter vector of a compiled program in ``like``'s dtype
    and on its device."""
    return torch.cat([p.reshape(-1) for p in param_list]).to(
        dtype=like.dtype, device=like.device)


def _eval_program(program, params, x, q, cache=None):
    """Evaluate a compiled covariance program, as the Pallas kernels do.

    ``x`` is ``(d, cap)``, ``q`` is ``(d, Q)`` and ``params`` the flat
    parameter vector; returns the ``(cap, Q)`` covariance. ``cache`` holds
    the per-dimension difference and product tiles, which do not depend
    on the hyperparameters, so a program (or a stack of programs) that
    touches a dimension twice builds each tile once
    (``safe_learning_tpu/ops/gp_kernel.py:217-268``).
    """
    from ..functions.gp import STATIONARY_COVARIANCES

    if cache is None:
        cache = {}

    def tile(op, dim):
        key = (op, dim)
        if key not in cache:
            xd, qd = x[dim, :][:, None], q[dim, :][None, :]
            cache[key] = xd - qd if op == "diff" else xd * qd
        return cache[key]

    op = program[0]
    if op == "stationary":
        _, fam, sel, ls_off, var_off = program
        r2 = None
        for j, dim in enumerate(sel):
            diff = tile("diff", dim) * params[ls_off + j]
            r2 = diff * diff if r2 is None else r2 + diff * diff
        return params[var_off] * STATIONARY_COVARIANCES[fam](r2)
    if op == "linear":
        _, sel, v_off = program
        k = None
        for j, dim in enumerate(sel):
            term = params[v_off + j] * tile("prod", dim)
            k = term if k is None else k + term
        return k
    if op == "sum":
        return (_eval_program(program[1], params, x, q, cache)
                + _eval_program(program[2], params, x, q, cache))
    if op == "product":
        return (_eval_program(program[1], params, x, q, cache)
                * _eval_program(program[2], params, x, q, cache))
    raise ValueError(program)


def _program_extent(program):
    """``(number of parameters, smallest input dimension)`` a program
    reads: one past its largest parameter offset and input column."""
    op = program[0]
    if op == "stationary":
        _, _, sel, ls_off, var_off = program
        return max(ls_off + len(sel), var_off + 1), max(sel) + 1
    if op == "linear":
        _, sel, v_off = program
        return v_off + len(sel), max(sel) + 1
    left, right = _program_extent(program[1]), _program_extent(program[2])
    return max(left[0], right[0]), max(left[1], right[1])


# ---------------------------------------------------------------------------
# Kernels 2 and 3: plain twins
# ---------------------------------------------------------------------------
def gp_predict_general_plain(points, x, params, chol_inv, alpha, mask, s2,
                             program, count=None):
    """Plain PyTorch twin of the general fused predict.

    The counterpart of ``_general_xla_equiv``
    (``safe_learning_tpu/ops/gp_kernel.py:321-329``). ``count`` is
    accepted and ignored: this is the full-capacity math.

    Parameters
    ----------
    points : (Q, d) raw query points
    x : (cap, d) raw training inputs
    params : (P,) flat kernel parameters (:func:`program_params`)
    chol_inv : (cap, cap) inverse Cholesky factor of the scaled kernel
    alpha : (cap, p) cached solve against the targets
    mask : (cap,) active-row mask
    s2 : scalar, the conditioning scale squared
    program : nested tuple from :func:`compile_kernel_program`

    Returns
    -------
    mean_num : (Q, p); var_num : (Q,)
    """
    k = _eval_program(program, params, x.T, points.T)
    k = k * s2 * mask[:, None]
    a = torch.matmul(chol_inv, k)
    return torch.matmul(a.T, alpha), (a * a).sum(dim=0)


def gp_predict_stacked_plain(points, x, params, chol_inv, alpha_t, mask, s2,
                             programs, count=None):
    """Plain PyTorch twin of the stacked fused predict.

    The counterpart of ``_stacked_xla_equiv``
    (``safe_learning_tpu/ops/gp_kernel.py:332-344``): S single-output GPs
    over one training set, the difference and product tiles shared across
    outputs. ``count`` is accepted and ignored: this is the full-capacity
    math.

    Parameters
    ----------
    points : (Q, d) raw query points
    x : (cap, d) raw shared training inputs
    params : (P,) flat kernel parameters of all outputs (one offset space)
    chol_inv : (S, cap, cap) per-output inverse Cholesky factors
    alpha_t : (S, cap) per-output cached solves
    mask : (cap,) active-row mask
    s2 : scalar, the shared conditioning scale squared
    programs : tuple of S compiled covariance programs

    Returns
    -------
    mean_num : (Q, S); var_num : (Q, S)
    """
    cache = {}
    means, pvars = [], []
    for s, program in enumerate(programs):
        k = _eval_program(program, params, x.T, points.T, cache)
        k = k * s2 * mask[:, None]
        a = torch.matmul(chol_inv[s], k)
        means.append(torch.matmul(alpha_t[s], a))
        pvars.append((a * a).sum(dim=0))
    return torch.stack(means, dim=1), torch.stack(pvars, dim=1)


# ---------------------------------------------------------------------------
# Kernels 2 and 3: the program library
# ---------------------------------------------------------------------------
_COVARIANCE_FN = {"rbf": "cov_rbf", "matern12": "cov_matern12",
                  "matern32": "cov_matern32", "matern52": "cov_matern52"}


class _ProgramEmitter:
    """Straight-line CUDA statements for one program's ``k_j``.

    The order of operations is :func:`_eval_program`'s, so the kernel and
    its twin round the same expressions. Each input column is read once
    and its difference and product formed once (the tile cache of the
    twin).
    """

    def __init__(self):
        self.lines = []
        self.count = 0
        self.names = {}

    def _value(self, key, expr):
        if key not in self.names:
            self.names[key] = self.temp(expr, name="{}{}".format(*key))
        return self.names[key]

    def temp(self, expr, name=None):
        if name is None:
            name = "t{}".format(self.count)
            self.count += 1
        self.lines.append("const T {} = {};".format(name, expr))
        return name

    def column(self, op, dim):
        xd = self._value(("x", dim), "xj[{}]".format(dim))
        if op == "d":
            return self._value(("d", dim), "{} - q[{}]".format(xd, dim))
        return self._value(("m", dim), "{} * q[{}]".format(xd, dim))

    def emit(self, program):
        op = program[0]
        if op == "stationary":
            _, fam, sel, ls_off, var_off = program
            r2 = None
            for j, dim in enumerate(sel):
                s = self.temp("{} * pr[{}]".format(self.column("d", dim),
                                                   ls_off + j))
                r2 = (self.temp("{0} * {0}".format(s)) if r2 is None
                      else self.temp("{1} + {0} * {0}".format(s, r2)))
            return self.temp("pr[{}] * {}<T>({})".format(
                var_off, _COVARIANCE_FN[fam], r2))
        if op == "linear":
            _, sel, v_off = program
            k = None
            for j, dim in enumerate(sel):
                term = "pr[{}] * {}".format(v_off + j, self.column("m", dim))
                k = self.temp(term if k is None
                              else "{} + {}".format(k, term))
            return k
        if op in ("sum", "product"):
            left = self.emit(program[1])
            right = self.emit(program[2])
            return self.temp("{} {} {}".format(
                left, "+" if op == "sum" else "*", right))
        raise ValueError(program)


def render_program_source(programs):
    """CUDA C++ source of the library for a tuple of covariance programs.

    One program is the general kernel (kernel 2); S programs over one
    parameter space are the stacked kernel (kernel 3). The source defines
    ``CovarianceProgram::k<T, OUT>``, the covariance of output ``OUT``
    between one training row and one query, as straight-line code that
    reads the parameters from the runtime array ``pr``: a new
    hyperparameter value never needs a new build. The template
    ``csrc/gp_predict_program.cuh`` holds the rest of the kernel.
    """
    programs = tuple(programs)
    if not 1 <= len(programs) <= PROGRAM_OUTPUTS_MAX:
        raise ValueError("the program kernel takes 1 to {} outputs, got {}"
                         .format(PROGRAM_OUTPUTS_MAX, len(programs)))
    extents = [_program_extent(p) for p in programs]
    n_params = max(e[0] for e in extents)
    min_d = max(e[1] for e in extents)
    if n_params > PROGRAM_PARAMS_MAX:
        raise ValueError("the program kernel takes at most {} parameters, "
                         "got {}".format(PROGRAM_PARAMS_MAX, n_params))
    lines = ["// Generated by safe_learning_tpu_torch.ops.gp_kernel."
             "render_program_source from the covariance programs:"]
    lines += ["//   output {}: {!r}".format(s, p)
              for s, p in enumerate(programs)]
    # The struct has internal linkage, so every template instantiated with
    # it does too: each library keeps its own launch caches, where the
    # same mangled name in every library would make them one process-wide
    # (GNU unique) object.
    lines += ['#include "gp_predict_program.cuh"', "",
              "namespace {", "",
              "struct CovarianceProgram {",
              "  static constexpr int NUM_OUT = {};".format(len(programs)),
              "  static constexpr int NUM_PARAMS = {};".format(n_params),
              "  static constexpr int MIN_D = {};".format(min_d), "",
              "  template <typename T, int OUT>",
              "  static __device__ __forceinline__ T k(",
              "      const T* xj, const T (&q)[gp_common::D_MAX],",
              "      const T (&pr)[NUM_PARAMS]) {",
              "    using namespace gp_common;"]
    for s, program in enumerate(programs):
        emitter = _ProgramEmitter()
        result = emitter.emit(program)
        if len(programs) == 1:
            head = None
        elif s == 0:
            head = "    if constexpr (OUT == 0) {"
        elif s < len(programs) - 1:
            head = "    }} else if constexpr (OUT == {}) {{".format(s)
        else:
            head = "    } else {"
        if head:
            lines.append(head)
        indent = "      " if head else "    "
        lines += [indent + line for line in emitter.lines]
        lines.append(indent + "return {};".format(result))
    if len(programs) > 1:
        lines.append("    }")
    lines += ["  }", "};", "", "}  // namespace", "",
              "GP_PROGRAM_EXPORTS(CovarianceProgram)", ""]
    return "\n".join(lines)


_STATIONARY_JOB = ("gp_predict", ["gp_predict.cu", "gp_predict_stationary.cuh",
                                   "gp_predict_common.cuh"], None)

#: The four variants of kernel 1 (``csrc/gp_predict_variants.cu``), which
#: the port's benchmark modules time beside it; no path routes through
#: them.
_VARIANTS_JOB = ("gp_predict_variants",
                 ["gp_predict_variants.cu", "gp_predict_stationary.cuh",
                  "gp_predict_common.cuh"], None)


def _program_job(programs):
    """``(name, headers, text)`` of a program library's build."""
    text = render_program_source(programs)
    name = "gp_program-" + hashlib.sha256(text.encode()).hexdigest()[:8]
    return name, ["gp_predict_common.cuh", "gp_predict_program.cuh"], text


def build_kernels(program_tuples=()):
    """Build the stationary kernel, its variants and the library of each
    program tuple at once (one ``nvcc`` each, all started together).

    Later calls of :func:`kernel_library`, :func:`variants_library` and
    :func:`program_library` load what this built. Returns the build names,
    in order.
    """
    from .build import load_libraries

    jobs = [_STATIONARY_JOB, _VARIANTS_JOB] + [_program_job(tuple(p))
                                               for p in program_tuples]
    load_libraries(jobs)
    return [job[0] for job in jobs]


@functools.lru_cache(maxsize=None)
def program_library(programs):
    """Build (first call only) and bind the library of a program tuple."""
    from .build import load_libraries

    (lib,) = load_libraries([_program_job(programs)])
    args = ([ctypes.c_void_p] * 7
            + [ctypes.c_int64] + [ctypes.c_int] * 4
            + [ctypes.c_void_p] * 3)
    for fn in (lib.gp_program_f32, lib.gp_program_f64,
               lib.gp_program_streamed_f32, lib.gp_program_streamed_f64):
        fn.argtypes = args
        fn.restype = ctypes.c_int
    lib.gp_program_error_string.argtypes = [ctypes.c_int]
    lib.gp_program_error_string.restype = ctypes.c_char_p
    lib.error_string = lib.gp_program_error_string
    lib.gp_program_limits.argtypes = [ctypes.POINTER(ctypes.c_int)] * 5
    lib.gp_program_limits.restype = ctypes.c_int
    lib.gp_program_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.gp_program_smem_bytes.restype = ctypes.c_longlong
    lib.gp_program_body.argtypes = [ctypes.c_int] * 4
    lib.gp_program_body.restype = ctypes.c_int
    lib.gp_program_panel_max.argtypes = [ctypes.c_int]
    lib.gp_program_panel_max.restype = ctypes.c_int
    limits = [ctypes.c_int() for _ in range(5)]
    lib.gp_program_limits(*(ctypes.byref(v) for v in limits))
    lib.limits = dict(zip(("d_max", "p_max", "num_out", "num_params",
                           "min_d"), (v.value for v in limits)))
    return lib


def program_body(programs, count, dtype, p=1, d=3):
    """The body kernel 2 or 3 takes for a program tuple at ``count`` rows,
    ``p`` outputs a program and ``d`` input dimensions: ``"tiled"``,
    ``"panel"`` or ``"streamed"``. The library decides it from the shape
    alone; this asks it (introspection only; builds the library on first
    use)."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    lib = program_library(tuple(programs))
    return PROGRAM_BODIES[lib.gp_program_body(int(count), itemsize, p, d)]


def program_panel_max(programs, dtype):
    """The largest count the panel body of a program library takes."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    return program_library(tuple(programs)).gp_program_panel_max(itemsize)


def _launch_program(programs, points, x, params, chol_inv, alpha, mask, s2,
                    count, mean_num, var_num):
    """Validate and launch a program library; ``False`` when there was
    nothing to launch (no queries).

    ``chol_inv`` is ``(S, cap, cap)``, ``alpha`` is ``(S, cap, p)``;
    outputs are ``mean_num`` ``(Q, S*p)`` and ``var_num`` ``(Q*S,)`` in
    memory. ``count`` is the number of active rows (``None``: ``cap``).
    """
    return _launch_entry("gp_program", programs, points, x, params,
                         chol_inv, alpha, mask, s2, count, mean_num, var_num)


def _launch_entry(entry, programs, points, x, params, chol_inv, alpha, mask,
                  s2, count, mean_num, var_num):
    """:func:`_launch_program` through the library's ``entry`` (its
    ``_f32`` or ``_f64`` function)."""
    s2 = _scalar_tensor(s2, points)
    dtype, device = _check_tensors(dict(
        points=points, x=x, params=params, chol_inv=chol_inv, alpha=alpha,
        mask=mask, s2=s2))
    n_q, d = points.shape
    n_out, cap, p = alpha.shape
    if (x.shape != (cap, d) or chol_inv.shape != (n_out, cap, cap)
            or mask.shape != (cap,) or params.dim() != 1
            or s2.numel() != 1 or n_out != len(programs)):
        raise ValueError("inconsistent shapes: points {}, x {}, params {}, "
                         "chol_inv {}, alpha {}, mask {}, {} programs"
                         .format(tuple(points.shape), tuple(x.shape),
                                 tuple(params.shape), tuple(chol_inv.shape),
                                 tuple(alpha.shape), tuple(mask.shape),
                                 len(programs)))
    count = _active_rows(count, cap)
    lib = program_library(programs)
    lim = lib.limits
    if not lim["min_d"] <= d <= lim["d_max"] or p > lim["p_max"]:
        raise ValueError("this program kernel takes {} <= d <= {} and "
                         "p <= {}; got d={}, p={}".format(
                             lim["min_d"], lim["d_max"], lim["p_max"], d, p))
    if params.shape[0] != lim["num_params"]:
        raise ValueError("the programs read {} parameters, got {}".format(
            lim["num_params"], params.shape[0]))
    if n_q == 0:
        return False
    fn = getattr(lib, entry + ("_f32" if dtype == torch.float32 else "_f64"))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(points.data_ptr(), x.data_ptr(), params.data_ptr(),
                 chol_inv.data_ptr(), alpha.data_ptr(), mask.data_ptr(),
                 s2.data_ptr(), n_q, d, cap, count, p, mean_num.data_ptr(),
                 var_num.data_ptr(), stream)
    _raise_on_error(err, lib, entry)
    return True


def gp_predict_general_cuda(points, x, params, chol_inv, alpha, mask, s2,
                            program, count=None):
    """Launch the general (composite-kernel) CUDA kernel.

    Same contract as :func:`gp_predict_general_plain`. ``count`` (``None``
    means the capacity) is the number of active rows; the kernel's loops
    stop there. Precondition, which ``_host_factorize`` and
    ``_bordered_append`` guarantee: ``chol_inv`` is lower-triangular,
    ``mask[count:] == 0`` and ``chol_inv[count:, :count] == 0``. Every
    tensor must be a contiguous CUDA tensor of one float dtype on one
    device (``s2`` may be a Python number). Launches on the current
    stream without synchronising.
    """
    n_q, cap, p = points.shape[0], chol_inv.shape[0], alpha.shape[-1]
    mean_num = torch.empty((n_q, p), dtype=points.dtype,
                           device=points.device)
    var_num = torch.empty((n_q,), dtype=points.dtype, device=points.device)
    if _launch_program((program,), points, x, params,
                       chol_inv.reshape(1, cap, -1),
                       alpha.reshape(1, cap, -1), mask, s2, count, mean_num,
                       var_num):
        gp_predict_general_cuda.launches += 1
    return mean_num, var_num


gp_predict_general_cuda.launches = 0


def gp_predict_stacked_cuda(points, x, params, chol_inv, alpha_t, mask, s2,
                            programs, count=None):
    """Launch the stacked CUDA kernel (one launch for all S outputs).

    Same contract as :func:`gp_predict_stacked_plain`; ``count`` and the
    precondition of :func:`gp_predict_general_cuda` hold for every
    output's ``chol_inv[s]``.
    """
    n_q, n_out = points.shape[0], alpha_t.shape[0]
    mean_num = torch.empty((n_q, n_out), dtype=points.dtype,
                           device=points.device)
    var_num = torch.empty((n_q, n_out), dtype=points.dtype,
                          device=points.device)
    if _launch_program(tuple(programs), points, x, params, chol_inv,
                       alpha_t.reshape(n_out, -1, 1), mask, s2, count,
                       mean_num, var_num):
        gp_predict_stacked_cuda.launches += 1
    return mean_num, var_num


gp_predict_stacked_cuda.launches = 0


def gp_predict_stacked_streamed_cuda(points, x, params, chol_inv, alpha_t,
                                     mask, s2, programs, count=None):
    """Kernel 3 on its streamed body whatever the count.

    Same contract as :func:`gp_predict_stacked_cuda`. The streamed body is
    the one a launch takes above the panel body's largest count
    (:func:`program_panel_max`); this entry reaches it at any count so
    that ``chip_smoke.py`` and the CUDA tests can hold the panel body
    against it on the same inputs. No path of the package calls it.
    """
    n_q, n_out = points.shape[0], alpha_t.shape[0]
    mean_num = torch.empty((n_q, n_out), dtype=points.dtype,
                           device=points.device)
    var_num = torch.empty((n_q, n_out), dtype=points.dtype,
                          device=points.device)
    if _launch_entry("gp_program_streamed", tuple(programs), points, x,
                     params, chol_inv, alpha_t.reshape(n_out, -1, 1), mask,
                     s2, count, mean_num, var_num):
        gp_predict_stacked_streamed_cuda.launches += 1
    return mean_num, var_num


gp_predict_stacked_streamed_cuda.launches = 0


class _FusedGeneral(torch.autograd.Function):
    """General kernel forward; the backward differentiates the twin."""

    @staticmethod
    def forward(ctx, points, x, params, chol_inv, alpha, mask, s2,
                program, count):
        ctx.program = program
        ctx.save_for_backward(points, x, params, chol_inv, alpha, mask, s2)
        return gp_predict_general_cuda(points, x, params, chol_inv, alpha,
                                       mask, s2, program, count=count)

    @staticmethod
    def backward(ctx, grad_mean, grad_var):
        return _grads_through_plain(ctx, gp_predict_general_plain,
                                    (grad_mean, grad_var), 7,
                                    program=ctx.program)


class _FusedStacked(torch.autograd.Function):
    """Stacked kernel forward; the backward differentiates the twin."""

    @staticmethod
    def forward(ctx, points, x, params, chol_inv, alpha_t, mask, s2,
                programs, count):
        ctx.programs = programs
        ctx.save_for_backward(points, x, params, chol_inv, alpha_t, mask,
                              s2)
        return gp_predict_stacked_cuda(points, x, params, chol_inv, alpha_t,
                                       mask, s2, programs, count=count)

    @staticmethod
    def backward(ctx, grad_mean, grad_var):
        return _grads_through_plain(ctx, gp_predict_stacked_plain,
                                    (grad_mean, grad_var), 7,
                                    programs=ctx.programs)


def fused_gp_predict_general(points, x, params, chol_inv, alpha, mask, s2,
                             program, count=None):
    """Fused posterior numerators for a composite kernel.

    Same contract as :func:`gp_predict_general_plain`. A CPU tensor goes
    to the plain version; a CUDA tensor goes to the CUDA kernel, or the
    call raises.
    """
    if points.device.type == "cpu":
        return gp_predict_general_plain(points, x, params, chol_inv, alpha,
                                        mask, s2, program, count=count)
    s2 = _scalar_tensor(s2, points)
    return _FusedGeneral.apply(points.contiguous(), x.contiguous(),
                               params.contiguous(), chol_inv.contiguous(),
                               alpha.contiguous(), mask.contiguous(),
                               s2.contiguous(), program, count)


def fused_gp_predict_stacked(points, x, params, chol_inv, alpha_t, mask, s2,
                             programs, count=None):
    """Fused posterior numerators for a stack of GPs over shared inputs.

    Same contract as :func:`gp_predict_stacked_plain`. A CPU tensor goes
    to the plain version; a CUDA tensor goes to the CUDA kernel, or the
    call raises.
    """
    programs = tuple(programs)
    if points.device.type == "cpu":
        return gp_predict_stacked_plain(points, x, params, chol_inv,
                                        alpha_t, mask, s2, programs,
                                        count=count)
    s2 = _scalar_tensor(s2, points)
    return _FusedStacked.apply(points.contiguous(), x.contiguous(),
                               params.contiguous(), chol_inv.contiguous(),
                               alpha_t.contiguous(), mask.contiguous(),
                               s2.contiguous(), programs, count)
