"""Drive the PyTorch/CUDA port's main paths once on one GPU and check them.

Usage, from the repository root on a machine with an NVIDIA Hopper GPU
and the CUDA toolkit:

    python3 chip_smoke.py

Phases, in order; any failure raises and the exit code is not 0:

1. device: requires CUDA and compute capability 9.0, sets
   ``config.device = "cuda:0"`` and prints the card's name and power limit;
2. build: compiles the stationary kernel (``csrc/gp_predict.cu``) and one
   library per covariance program tuple (``csrc/gp_predict_program.cuh``)
   for ``sm_90a``, one ``nvcc`` each, all at once, and prints each build's
   time and the compiler's report;
3. kernel 1 against plain: the stationary GP-predict kernel against its
   plain PyTorch version on the card, for every stationary kind,
   capacities 8, 128 and 2048 with a partly filled mask, 1 and 2 outputs,
   scale 1 and 2.5, ragged query counts, float32 and float64, each within
   a computed rounding bound; one gradient through the autograd rule;
4. kernels 2 and 3 against plain: the general and stacked program kernels
   against their plain versions, for four programs (the flagship's
   composite kernel, an ARD RBF, a product of stationary kernels on
   different ``ActiveDims``, ``Matern12 + Matern52 + Linear``),
   capacities 8 to 2048, 1 and 2 outputs (general), 1 to 3 stacked
   outputs, scale 1 and 2.5, ragged query counts up to about 10^6,
   float32 and float64, each within a computed bound; one gradient each;
5. bench path: ``bench.py``'s instance (1000x1000 grid, RBF GP with 128
   points and a linear prior mean, quadratic Lyapunov candidate) built
   through the port's public API; ``Lyapunov.update_safe_set`` and
   ``oracle.calibrate_certificate_margin`` pass ``bench.py``'s two gates
   against its float64 numpy oracle, and kernel 1's launch counter shows
   the sweep went through it;
6. flagship paths: the NeurIPS-17 inverted-pendulum verification
   (``benchmarks/flagship_3m_sweep.py``'s instance, a 2001x1501 grid of
   3,003,501 points, two composite-kernel GPs on 32 measurements, LQR
   policy and quadratic candidate) in float32, once with a
   ``StackedGaussianProcess`` (kernel 3) and once with a ``FunctionStack``
   of two ``GaussianProcess``es (kernel 2). Each passes the two gates
   against the port's float64 oracle (``oracle.oracle_safe_set``), certifies
   more than the exempt initial set, and went through its kernel;
7. times: CUDA events, median of 10 runs after warm-up, for the bench and
   flagship sweeps (one sweep a run) and for each kernel against its
   plain version on its path's own inputs (10 calls back to back a run).

The second-to-last line is a JSON object describing each kernel; the last
line is ``{"ok": true, "device": {...}}``.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

import safe_learning_tpu_torch as st
from safe_learning_tpu_torch.functions.base import concatenate_inputs
from safe_learning_tpu_torch.lyapunov import _fused_update, _negative_batch
from safe_learning_tpu_torch.ops import gp_kernel
from safe_learning_tpu_torch.ops.build import build_reports

KERNEL_CLASSES = {"rbf": st.RBF, "matern12": st.Matern12,
                  "matern32": st.Matern32, "matern52": st.Matern52}

#: Each kernel: its wrapper (whose ``launches`` the paths read), its
#: source, and the Pallas body it replaces.
KERNELS = {
    "gp_predict": (gp_kernel.gp_predict_cuda,
                   "safe_learning_tpu_torch/csrc/gp_predict.cu",
                   "safe_learning_tpu/ops/gp_kernel.py:169"),
    "gp_predict_general": (gp_kernel.gp_predict_general_cuda,
                           "safe_learning_tpu_torch/csrc/"
                           "gp_predict_program.cuh",
                           "safe_learning_tpu/ops/gp_kernel.py:271"),
    "gp_predict_stacked": (gp_kernel.gp_predict_stacked_cuda,
                           "safe_learning_tpu_torch/csrc/"
                           "gp_predict_program.cuh",
                           "safe_learning_tpu/ops/gp_kernel.py:347"),
}

#: The flagship's grid: the reference's size
#: (``examples/inverted_pendulum.ipynb`` cell 4).
FLAGSHIP_POINTS = (2001, 1501)


def reset_launches():
    """Set every kernel's launch counter to 0."""
    for wrapper, _, _ in KERNELS.values():
        wrapper.launches = 0


def read_launches():
    """Every kernel's launch counter, by kernel name."""
    return {name: wrapper.launches
            for name, (wrapper, _, _) in KERNELS.items()}


def build_bench_instance(n_points=1000, n_train=128):
    """``bench.py``'s verification instance (``bench.py:38-79``) in the port.

    Same numpy seed and data; built in ``config.dtype`` on
    ``config.device``. Returns a dict of the pieces and the raw data the
    float64 numpy oracle needs.
    """
    grid = st.GridWorld([[-1.0, 1.0], [-1.0, 1.0]], n_points)
    a = np.array([[0.25, 0.05], [0.0, 0.3]])
    b = np.zeros((2, 1))
    policy = st.LinearSystem(np.zeros((1, 2)))
    v = st.QuadraticFunction(np.eye(2))
    # Local Lipschitz constant of v: |grad v| = 2|x|, L1-reduced in the
    # threshold.
    lv = st.LambdaFunction(lambda x: 2.0 * torch.abs(x))
    lf = float(np.linalg.norm(a, 2))
    mean_fn = st.LinearSystem([a, b])

    rng = np.random.default_rng(0)
    x_train = np.column_stack([
        rng.uniform(-0.4, 0.4, n_train), rng.uniform(-0.4, 0.4, n_train),
        np.zeros(n_train)])
    y_train = (x_train[:, :2] @ a.T
               + 0.02 * np.sin(3 * x_train[:, :2]))
    params = dict(variance=1.0, lengthscales=0.3, noise=1e-4, beta=2.0)
    gp = st.GaussianProcess(
        st.RBF(params["variance"], [params["lengthscales"]] * 3,
               input_dim=3),
        x_train, y_train, noise_variance=params["noise"],
        beta=params["beta"], mean_function=mean_fn)

    tau = float(np.min(grid.unit_maxes))
    v_grid = v(grid.all_points).reshape(-1).cpu().numpy()
    initial_set = np.where(v_grid <= 0.01)[0]
    return dict(grid=grid, policy=policy, v=v, lv=lv, lf=lf, gp=gp, tau=tau,
                initial_set=initial_set, a=a, x_train=x_train,
                y_train=y_train, params=params)


def flagship_kernel(variances):
    """The flagship's composite kernel for one state dimension,
    ``Linear + ActiveDims(Matern32) * ActiveDims(Linear)``
    (``examples/inverted_pendulum.py:37-43``)."""
    return (st.LinearKernel(variances, input_dim=3)
            + st.ActiveDims(st.Matern32(lengthscales=1.0, input_dim=1),
                            [0])
            * st.ActiveDims(st.LinearKernel(variances[1], input_dim=1),
                            [0]))


def build_flagship_instance(num_points=FLAGSHIP_POINTS, route="stacked",
                            tau=None):
    """The flagship verification instance in the port.

    Built as ``benchmarks/flagship_3m_sweep.py:14-41`` builds it: the true
    and the wrong inverted pendulum, per-dimension GPs with the wrong
    pendulum's linearization as prior mean and the composite kernels
    (noise 1e-6, beta 2), 32 measurements of the true pendulum drawn from
    ``default_rng(0)`` (capacity 32), the wrong model's LQR policy
    saturated to [-1, 1] and its Riccati matrix as the quadratic
    candidate, and the initial set at the 0.001 quantile of v.
    ``route="stacked"`` batches the GPs as a ``StackedGaussianProcess``;
    ``route="fan_out"`` keeps them as a ``FunctionStack`` of
    ``GaussianProcess``es (``examples/adaptive_safety_verification.py:
    53-57``). ``tau`` defaults to the grid's smallest cell edge. Returns
    ``(lyapunov, inst)`` with ``inst`` the pieces and their numpy data.
    """
    gravity, length = 9.81, 0.5
    x_max = np.deg2rad(30)
    u_max = gravity * 0.15 * length * np.sin(x_max)
    norms = ((x_max, np.sqrt(gravity / length)), (u_max,))
    true = st.InvertedPendulum(0.15, length, 0.1, 1 / 80,
                               normalization=norms)
    wrong = st.InvertedPendulum(0.1, length, 0.0, 1 / 80,
                                normalization=norms)
    a, b = wrong.linearize()
    a_true, b_true = true.linearize()
    variances = np.clip((np.hstack([a_true, b_true]) - np.hstack([a, b]))
                        ** 2, 1e-5, None)
    kernels = [flagship_kernel(variances[dim]) for dim in range(2)]
    means = [st.LinearSystem([a[[dim]], b[[dim]]]) for dim in range(2)]

    rng = np.random.default_rng(0)
    xu = np.column_stack([rng.uniform(-1, 1, (32, 2)) * 0.3,
                          rng.uniform(-0.5, 0.5, (32, 1))])
    meas = true(xu[:, :2], xu[:, 2:]).cpu().numpy()
    noise = 0.001 ** 2
    if route == "stacked":
        dynamics = st.StackedGaussianProcess(
            kernels, xu, meas, noise_variances=noise, betas=2.0,
            mean_functions=means, capacity=32)
    elif route == "fan_out":
        dynamics = st.FunctionStack([
            st.GaussianProcess(kernel, xu, meas[:, dim:dim + 1],
                               noise_variance=noise, beta=2.0,
                               mean_function=mean, capacity=32)
            for dim, (kernel, mean) in enumerate(zip(kernels, means))])
    else:
        raise ValueError("route must be 'stacked' or 'fan_out'")

    k, s = st.utils.dlqr(a, b, np.diag([1.0, 2.0]), 1.2 * np.eye(1))
    policy = st.Saturation(st.LinearSystem(-k), -1.0, 1.0)
    v = st.QuadraticFunction(s)
    grid = st.GridWorld([[-2.0, 2.0], [-1.5, 1.5]], num_points)
    lv = float(2 * np.linalg.norm(s, 2))
    lf = float(np.linalg.norm(a - b @ k, 2))
    tau = float(np.min(grid.unit_maxes)) if tau is None else float(tau)
    values = v(grid.all_points).reshape(-1).cpu().numpy()
    initial_set = np.where(values <= np.quantile(values, 0.001))[0]
    lyap = st.Lyapunov(grid, v, dynamics, lf, lv, tau, policy,
                       initial_set=initial_set)
    return lyap, dict(a=a, b=b, a_true=a_true, b_true=b_true, k=k, s=s,
                      variances=variances, xu=xu, meas=meas, noise=noise,
                      lv=lv, lf=lf, tau=tau, initial_set=initial_set,
                      norms=norms)


# ---------------------------------------------------------------------------
# Kernels 2 and 3: cases and their computed bounds
# ---------------------------------------------------------------------------
def case_programs():
    """The four covariance programs of the kernel-2/3 cases (3-D inputs).

    The flagship's composite kernel; an ARD RBF written as a program; a
    product of two stationary kernels on different ``ActiveDims``; and
    ``Matern12 + Matern52 + Linear``.
    """
    return {
        "flagship": flagship_kernel(np.array([0.3, 0.1, 0.5])),
        "ard_rbf": st.RBF(1.3, [0.7, 1.4, 0.9], input_dim=3),
        "product": (st.ActiveDims(st.Matern52(0.9, [0.6, 1.1], input_dim=2),
                                  [0, 1])
                    * st.ActiveDims(st.RBF(1.2, 0.8, input_dim=1), [2])),
        "sum3": (st.Matern12(0.5, [0.9, 0.7, 1.3], input_dim=3)
                 + st.Matern52(0.8, [1.2, 0.5, 0.8], input_dim=3)
                 + st.LinearKernel([0.2, 0.4, 0.1], input_dim=3)),
    }


#: Stacked cases: their outputs' programs (by ``case_programs`` name).
STACKED_SETS = {1: ("sum3",), 2: ("flagship", "flagship"),
                3: ("ard_rbf", "product", "sum3")}


def compiled(kernels, like):
    """``(programs, params)`` of kernels in one parameter space."""
    params, programs = [], []
    for kernel in kernels:
        program, params = gp_kernel.compile_kernel_program(
            kernel, input_dim=3, params=params)
        programs.append(program)
    return tuple(programs), gp_kernel.program_params(params, like)


def _eval_bounded(program, params, x, q, unit):
    """``(k, |k|-bound, error bound in units of u)`` of a program, f64.

    The forward-error bound of one implementation's rounding of the
    program, node by node: a stationary leaf's relative error is below
    ``12 + (n + 8)(2 + rho) / 2 + (n + 4) r^2 / 2`` units (differences,
    reciprocal scaling, sum of n squares, sqrt and exp, whose error grows
    with its argument: ``rho = sqrt(5 r^2)`` bounds the Matern argument,
    ``r^2 / 2`` the RBF one); a linear leaf's absolute error below
    ``(n + 1)`` units of its absolute sum; a sum or product adds one
    rounding of its result to its children's propagated errors.
    """
    op = program[0]
    if op == "stationary":
        _, fam, sel, ls_off, var_off = program
        r2 = 0.0
        for j, dim in enumerate(sel):
            diff = (x[dim][:, None] - q[dim][None, :]) * params[ls_off + j]
            r2 = r2 + diff * diff
        n = len(sel)
        k = params[var_off] * st.functions.gp.STATIONARY_COVARIANCES[fam](
            r2)
        rel = (12 + 0.5 * (n + 8) * (2 + torch.sqrt(5 * r2))
               + 0.5 * (n + 4) * r2)
        return k, k.abs(), rel * k.abs()
    if op == "linear":
        _, sel, v_off = program
        terms = [params[v_off + j] * (x[dim][:, None] * q[dim][None, :])
                 for j, dim in enumerate(sel)]
        k = sum(terms)
        kabs = sum(t.abs() for t in terms)
        return k, kabs, (len(sel) + 1) * kabs
    k1, a1, e1 = _eval_bounded(program[1], params, x, q, unit)
    k2, a2, e2 = _eval_bounded(program[2], params, x, q, unit)
    if op == "sum":
        return k1 + k2, a1 + a2, e1 + e2 + a1 + a2
    return k1 * k2, a1 * a2, e1 * a2 + e2 * a1 + a1 * a2 + unit * e1 * e2


def program_bounds(points, x, params, chol_inv, alpha, mask, s2, programs,
                   unit, chunk=2 ** 17):
    """Elementwise bounds on ``|kernel - plain|`` of a program predict.

    ``chol_inv`` is ``(S, cap, cap)`` and ``alpha`` ``(S, cap, p)``; returns
    ``(tol_mean (Q, S*p), tol_var (Q, S))``. The forward-error bounds of
    ``rounding_bounds``, each counted twice (kernel and plain version both
    round), with the program's own error for ``k`` (``_eval_bounded``):
    ``a = L^-1 k`` adds ``cap u |L^-1| |k|``, the mean and the variance
    ``cap u`` of their absolute sums. Computed in float64, in query chunks.
    """
    q64, x64, p64 = points.double(), x.double(), params.double()
    m64, s2 = mask.double(), float(s2)
    cap = x.shape[0]
    tol_mean, tol_var = [], []
    for start in range(0, q64.shape[0], chunk):
        q = q64[start:start + chunk].T
        means, pvars = [], []
        for s, program in enumerate(programs):
            k, kabs, err = _eval_bounded(program, p64, x64.T, q, unit)
            # Scaling by s2 and the mask rounds twice more.
            scale = s2 * m64[:, None]
            k, kabs, err = k * scale, kabs * scale, (err + 2 * kabs) * scale
            li = chol_inv[s].double()
            al = alpha[s].double().abs()
            w = li.abs() @ (err + cap * kabs)
            a = (li @ k).abs()
            means.append(2 * unit * (w.T @ al + cap * (a.T @ al)))
            pvars.append(2 * unit * (2 * (a * w).sum(0)
                                     + cap * (a * a).sum(0)))
        tol_mean.append(torch.cat(means, dim=1))
        tol_var.append(torch.stack(pvars, dim=1))
    return torch.cat(tol_mean), torch.cat(tol_var)


def compare_program(route, inputs, programs):
    """Kernel 2 (``route="general"``) or 3 (``"stacked"``) against its
    plain version on one input set; returns the errors and the worst
    error-to-bound ratio."""
    points, x, params, chol_inv, alpha, mask, s2 = inputs
    if route == "general":
        (program,) = programs
        mean_k, var_k = gp_kernel.gp_predict_general_cuda(*inputs, program)
        mean_p, var_p = gp_kernel.gp_predict_general_plain(*inputs, program)
        li, al = chol_inv[None], alpha[None]
    else:
        mean_k, var_k = gp_kernel.gp_predict_stacked_cuda(*inputs, programs)
        mean_p, var_p = gp_kernel.gp_predict_stacked_plain(*inputs,
                                                           programs)
        li, al = chol_inv, alpha[:, :, None]
    torch.cuda.synchronize()
    if not (torch.isfinite(mean_k).all() and torch.isfinite(var_k).all()):
        raise AssertionError("kernel output is not finite")
    unit = torch.finfo(points.dtype).eps / 2
    tol_mean, tol_var = program_bounds(points, x, params, li, al, mask, s2,
                                       programs, unit)
    err_mean = (mean_k.double() - mean_p.double()).abs()
    err_var = (var_k.double() - var_p.double()).abs().reshape(
        tol_var.shape)
    tiny = torch.finfo(torch.float64).tiny
    ratio = max(float((err_mean / tol_mean.clamp(min=tiny)).max()),
                float((err_var / tol_var.clamp(min=tiny)).max()))
    return float(err_mean.max()), float(err_var.max()), ratio


def program_case(route, names, cap, p, scale, dtype, seed):
    """Inputs of one kernel-2/3 case: a GP (general) or a stacked GP over
    ``cap - cap // 4`` random points and random queries."""
    rng = np.random.default_rng(seed)
    n = cap - cap // 4
    x = rng.uniform(-1.0, 1.0, (n, 3))
    width = p if route == "general" else len(names)
    y = np.column_stack([np.sin((j + 1) * x.sum(axis=1) + 0.3 * j)
                         for j in range(width)])
    old = st.config.dtype
    st.config.dtype = dtype
    try:
        kernels = [case_programs()[name] for name in names]
        if route == "general":
            gp = st.GaussianProcess(kernels[0], x, y, noise_variance=1e-3,
                                    capacity=cap, scale=scale)
            chol_inv, alpha = gp.chol_inv, gp.alpha
        else:
            gp = st.StackedGaussianProcess(kernels, x, y,
                                           noise_variances=1e-3,
                                           capacity=cap, scale=scale)
            chol_inv, alpha = gp.chol_inv, gp.alpha[:, :, 0].contiguous()
    finally:
        st.config.dtype = old
    programs, params = compiled(kernels, gp.X_buf)
    return (gp.X_buf, params, chol_inv, alpha, gp._mask(),
            scale ** 2), programs


def case_queries(n_q, like, seed):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.uniform(-1.2, 1.2, (n_q, 3)),
                           dtype=like.dtype, device=like.device)


def program_library_sets():
    """Every program tuple this script launches: the cases' and the
    flagship's (which has the structure of the ``flagship`` case)."""
    progs = case_programs()
    sets = [(name,) for name in progs] + list(STACKED_SETS.values())
    tuples = []
    for names in sets:
        programs, _ = compiled([progs[n] for n in names],
                               torch.zeros(1, dtype=torch.float64))
        if programs not in tuples:
            tuples.append(programs)
    return tuples


def cuda_ms(fn, reps=10, warmup=2, batch=1):
    """Median milliseconds of ``fn()`` over ``reps`` runs (CUDA events).

    Each run times ``batch`` calls back to back and divides by ``batch``.
    With ``batch=1`` a run includes the host's work before the first
    launch, as a caller of one sweep sees it; a kernel is timed with
    ``batch=10``, so the device stays busy and the time is the kernel's.
    """
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(batch):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / batch)
    return statistics.median(times)


def rounding_bounds(inputs, kind):
    """Elementwise bounds on ``|kernel - plain|`` for both outputs.

    Standard forward-error bounds for the two dot-product stages, each
    counted twice (kernel and plain version both round), in float64:
    ``k`` carries a relative error below ``(16 + 2 r^2) u`` (differences,
    sum of squares, exp; ``r^2`` because exp amplifies the error of its
    argument); ``a = L^-1 k`` adds ``cap u |L^-1| |k|``; the mean and the
    variance add ``cap u`` of their absolute sums.
    """
    q, x, li, alpha, mask, var_s2 = (t.double() for t in inputs)
    u = torch.finfo(inputs[0].dtype).eps / 2
    cap = x.shape[0]
    r2 = None
    for i in range(q.shape[1]):
        diff = x[:, i][:, None] - q[:, i][None, :]
        r2 = diff * diff if r2 is None else r2 + diff * diff
    k = st.functions.gp.STATIONARY_COVARIANCES[kind](r2) * var_s2 \
        * mask[:, None]
    w = li.abs() @ ((cap + 16 + 2 * r2) * k.abs())
    del r2
    a = (li @ k).abs()
    del k
    tol_mean = 2 * u * (w.T @ alpha.abs() + cap * (a.T @ alpha.abs()))
    tol_var = 2 * u * (2 * (a * w).sum(0) + cap * (a * a).sum(0))
    return tol_mean, tol_var


def compare(inputs, kind):
    """Kernel against plain on one input set; returns the errors."""
    mean_k, var_k = gp_kernel.gp_predict_cuda(*inputs, kind=kind)
    mean_p, var_p = gp_kernel.gp_predict_plain(*inputs, kind=kind)
    torch.cuda.synchronize()
    tol_mean, tol_var = rounding_bounds(inputs, kind)
    err_mean = (mean_k.double() - mean_p.double()).abs()
    err_var = (var_k.double() - var_p.double()).abs()
    # A zero bound (all k underflowed) admits only a zero error.
    tiny = torch.finfo(torch.float64).tiny
    ratio = max(float((err_mean / tol_mean.clamp(min=tiny)).max()),
                float((err_var / tol_var.clamp(min=tiny)).max()))
    if not (torch.isfinite(mean_k).all() and torch.isfinite(var_k).all()):
        raise AssertionError("kernel output is not finite")
    return float(err_mean.max()), float(err_var.max()), ratio


def case_inputs(gp, n_q, seed):
    """Random queries against ``gp``, as the kernel's arguments."""
    rng = np.random.default_rng(seed)
    q = torch.as_tensor(rng.uniform(-1.2, 1.2, (n_q, gp.input_dim)),
                        dtype=gp.X_buf.dtype, device=gp.X_buf.device)
    ls = gp.kernel.lengthscales
    return ((q / ls).contiguous(), (gp.X_buf / ls).contiguous(),
            gp.chol_inv, gp.alpha, gp._mask(),
            gp.kernel.variance * gp.scale ** 2)


def case_gp(kind, cap, p, scale, dtype, seed):
    """A GP at capacity ``cap`` with a quarter of the rows padding."""
    rng = np.random.default_rng(seed)
    n = cap - cap // 4
    x = rng.uniform(-1.0, 1.0, (n, 3))
    y = np.column_stack([np.sin((j + 1) * x.sum(axis=1) + 0.3 * j)
                         for j in range(p)])
    old = st.config.dtype
    st.config.dtype = dtype
    try:
        return st.GaussianProcess(
            KERNEL_CLASSES[kind](1.3, [0.7, 1.4, 0.9], input_dim=3), x, y,
            noise_variance=1e-3, beta=2.0, capacity=cap, scale=scale)
    finally:
        st.config.dtype = old


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs an NVIDIA GPU")
    cc = torch.cuda.get_device_capability(0)
    if cc != (9, 0):
        raise SystemExit("chip_smoke: needs compute capability (9, 0) "
                         "(Hopper), found {}".format(cc))
    st.config.device = "cuda:0"
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(card)
    print("torch {} cuda {} device {} cc {}".format(
        torch.__version__, torch.version.cuda,
        torch.cuda.get_device_name(0), cc))
    return card


def phase_build():
    """Build every kernel library at once: one ``nvcc`` per library."""
    tuples = program_library_sets()
    start = time.perf_counter()
    names = gp_kernel.build_kernels(tuples)
    wall = time.perf_counter() - start
    for name in names:
        seconds, report = build_reports[name]
        print("build {}: {:.3f} s of nvcc".format(name, seconds))
        # The compiler's register, spill and shared-memory lines.
        print("\n".join(line for line in report.splitlines()
                        if "Used" in line or "spill" in line
                        or "nvcc" in line))
    print("build: {} libraries in {:.3f} s wall".format(len(names), wall))
    for programs in tuples:
        print("program library: {!r}".format(programs))
    lib = gp_kernel.program_library(tuples[0])
    print("dynamic shared memory per block of 128 queries: " + ", ".join(
        "{} B at cap {} ({})".format(lib.gp_program_smem_bytes(cap, size),
                                     cap, name)
        for cap in (32, 128) for size, name in ((4, "f32"), (8, "f64"))))


def phase_program_cases():
    """Kernels 2 and 3 against their plain versions, each case within its
    computed bound (``program_bounds``)."""
    names = list(case_programs())
    worst, case = 0.0, 0
    for dtype in (torch.float32, torch.float64):
        for ni, name in enumerate(names):
            for ci, cap in enumerate((8, 32, 128, 2048)):
                p = 1 + (ni + ci) % 2
                scale = (1.0, 2.5)[(ni + ci + 1) % 2]
                case += 1
                inputs, programs = program_case("general", (name,), cap, p,
                                                scale, dtype, seed=case)
                n_q = 65537 if cap > 128 else (77, 1000003)[ci % 2]
                points = case_queries(n_q, inputs[0], case)
                em, ev, ratio = compare_program(
                    "general", (points,) + inputs, programs)
                print("general case {:2d} {} {:8s} cap={:4d} p={} scale={} "
                      "Q={:7d}: max|dmean|={:.3e} max|dvar|={:.3e} "
                      "err/bound={:.3f}".format(
                          case, str(dtype)[6:], name, cap, p, scale, n_q,
                          em, ev, ratio))
                if not ratio <= 1.0:
                    raise AssertionError("general kernel and plain disagree "
                                         "beyond the bound")
                worst = max(worst, ratio)
        for n_out, set_names in STACKED_SETS.items():
            # num_fun * cap^2 <= kernel_max_capacity^2, as the GP routes.
            for ci, cap in enumerate((8, 32, 128, 2048 if n_out == 1
                                      else 1024)):
                scale = (1.0, 2.5)[(n_out + ci) % 2]
                case += 1
                inputs, programs = program_case("stacked", set_names, cap, 1,
                                                scale, dtype, seed=case)
                n_q = 65537 if cap > 128 else (1000003, 77)[ci % 2]
                points = case_queries(n_q, inputs[0], case)
                em, ev, ratio = compare_program(
                    "stacked", (points,) + inputs, programs)
                print("stacked case {:2d} {} S={} cap={:4d} scale={} "
                      "Q={:7d}: max|dmean|={:.3e} max|dvar|={:.3e} "
                      "err/bound={:.3f}".format(
                          case, str(dtype)[6:], n_out, cap, scale, n_q, em,
                          ev, ratio))
                if not ratio <= 1.0:
                    raise AssertionError("stacked kernel and plain disagree "
                                         "beyond the bound")
                worst = max(worst, ratio)
    print("kernels 2 and 3 against plain: {} cases, worst err/bound {:.3f} "
          "(bound: program_bounds)".format(case, worst))

    # One gradient per kernel through its autograd rule.
    for route, set_names, p in (("general", ("flagship",), 2),
                                ("stacked", STACKED_SETS[3], 1)):
        inputs, programs = program_case(route, set_names, 32, p, 2.5,
                                        torch.float64, seed=99)
        fused = (gp_kernel.fused_gp_predict_general if route == "general"
                 else gp_kernel.fused_gp_predict_stacked)
        plain = (gp_kernel.gp_predict_general_plain if route == "general"
                 else gp_kernel.gp_predict_stacked_plain)
        program = programs[0] if route == "general" else programs
        grads = []
        for fn in (fused, plain):
            q = case_queries(77, inputs[0], 99).requires_grad_(True)
            mean_num, var_num = fn(q, *inputs, program)
            (mean_num.sum() + var_num.sum()).backward()
            grads.append(q.grad)
        gerr = float((grads[0] - grads[1]).abs().max())
        print("{} gradient wrt queries, autograd rule vs plain: max abs "
              "diff {:.3e} (tolerance 1e-12)".format(route, gerr))
        if not gerr <= 1e-12:
            raise AssertionError("gradient through the {} kernel differs"
                                 .format(route))


def phase_kernel_cases():
    worst = 0.0
    case = 0
    for dtype in (torch.float32, torch.float64):
        for ki, kind in enumerate(gp_kernel.KINDS):
            for ci, cap in enumerate((8, 128, 2048)):
                p = 1 + (ki + ci) % 2
                scale = (1.0, 2.5)[(ki + ci + 1) % 2]
                gp = case_gp(kind, cap, p, scale, dtype, seed=case)
                sizes = (77, 65537) if cap > 128 else (77, 1000003)
                for n_q in sizes:
                    case += 1
                    em, ev, ratio = compare(case_inputs(gp, n_q, case),
                                            kind)
                    print("case {:2d} {} {:8s} cap={:4d} p={} scale={} "
                          "Q={:7d}: max|dmean|={:.3e} max|dvar|={:.3e} "
                          "err/bound={:.3f}".format(
                              case, str(dtype)[6:], kind, cap, p, scale,
                              n_q, em, ev, ratio))
                    if not ratio <= 1.0:
                        raise AssertionError(
                            "kernel and plain disagree beyond the rounding "
                            "bound (err/bound {:.3f})".format(ratio))
                    worst = max(worst, ratio)
    print("kernel against plain: {} cases, worst err/bound {:.3f} "
          "(bound: rounding_bounds)".format(case, worst))

    # One gradient through the autograd rule against the plain version's.
    gp = case_gp("matern52", 128, 2, 2.5, torch.float64, seed=99)
    inputs = case_inputs(gp, 77, 99)
    grads = []
    for fn in (gp_kernel.fused_gp_predict, gp_kernel.gp_predict_plain):
        q = inputs[0].clone().requires_grad_(True)
        mean_num, var_num = fn(q, *inputs[1:], kind="matern52")
        (mean_num.sum() + var_num.sum()).backward()
        grads.append(q.grad)
    gerr = float((grads[0] - grads[1]).abs().max())
    print("gradient wrt queries, autograd rule vs plain: max abs diff "
          "{:.3e} (tolerance 1e-12)".format(gerr))
    if not gerr <= 1e-12:
        raise AssertionError("gradient through the kernel differs")


def phase_bench_path():
    """``bench.py``'s instance: kernel 1's path."""
    from bench import _oracle_c_max

    inst = build_bench_instance(1000)
    grid = inst["grid"]
    reset_launches()
    lyap = st.Lyapunov(grid, inst["v"], inst["gp"], inst["lf"], inst["lv"],
                       inst["tau"], inst["policy"],
                       initial_set=inst["initial_set"])
    lyap.update_safe_set()
    c_dev = lyap.c_max
    safe_frac = float(lyap.safe_set.mean())
    margin = st.oracle.calibrate_certificate_margin(lyap, num_samples=4096)
    lyap.update_safe_set()
    launches = read_launches()

    check_values(lyap)
    c_ref, frac_ref = _oracle_c_max(
        grid, inst["a"], inst["x_train"], inst["y_train"], inst["params"],
        inst["lf"], inst["tau"], inst["initial_set"])
    print("bench path: c_max={!r} (f64 oracle {!r}) safe_frac={!r} "
          "(oracle {!r})".format(c_dev, c_ref, safe_frac, frac_ref))
    if not 0.05 < safe_frac < 0.95:
        raise AssertionError("instance must discriminate (safe_frac={})"
                             .format(safe_frac))
    gate_1(c_dev, c_ref)
    print("conservative: margin={!r} level_margin={!r} c_max={!r} "
          "(<= oracle {!r}) safe_frac={!r}".format(
              margin, lyap.level_margin, lyap.c_max, c_ref,
              float(lyap.safe_set.mean())))
    gate_2(lyap.c_max, c_ref)
    print("kernel launches during the bench path: {}".format(launches))
    if launches["gp_predict"] < 1:
        raise AssertionError("the bench path never launched kernel 1")
    return inst, lyap, launches


def check_values(lyap):
    if lyap.values.device != torch.device("cuda:0"):
        raise AssertionError("values computed on {}".format(
            lyap.values.device))
    if lyap.values.shape != (lyap.discretization.nindex,) or not bool(
            torch.isfinite(lyap.values).all()):
        raise AssertionError("values are not finite of shape (nindex,)")


def gate_1(c_dev, c_ref):
    """``bench.py``'s first gate: the certified level matches the oracle's."""
    bound = 5e-4 * max(abs(c_ref), 1.0)
    if not abs(c_dev - c_ref) <= bound:
        raise AssertionError("certified level {} != f64 oracle {}".format(
            c_dev, c_ref))
    print("gate 1 passed: |c_max - oracle| = {!r} <= {!r}".format(
        abs(c_dev - c_ref), bound))


def gate_2(c_max, c_ref):
    """``bench.py``'s second gate: the margin-guarded level is at or below
    the oracle's (to its float32 rounding, ``bench.py:236``)."""
    if not c_max <= c_ref + 1e-7 * max(abs(c_ref), 1.0):
        raise AssertionError("margin-guarded level {} exceeds f64 oracle "
                             "{}".format(c_max, c_ref))
    print("gate 2 passed")


def phase_flagship_path(route):
    """The flagship verification at full width by one route: the stacked
    GP (kernel 3, one launch per sweep) or the fan-out of two GPs
    (kernel 2, one launch per member per sweep).

    Besides ``bench.py``'s two gates against the port's float64 oracle,
    the decrease verdict of every grid point on the card must agree with
    the oracle's wherever the oracle's margin lies outside the calibrated
    float32 band, and some points beyond the exempt initial set must pass.
    (The certified level set cannot grow past the initial set on this
    instance, in exact arithmetic too: near the origin the GP error term
    keeps the decrease bound above the threshold ``-L_v (1 + L_f) tau``.)
    """
    kernel = ("gp_predict_stacked" if route == "stacked"
              else "gp_predict_general")
    per_sweep = 1 if route == "stacked" else 2
    start = time.perf_counter()
    lyap, inst = build_flagship_instance(route=route)
    build_s = time.perf_counter() - start
    reset_launches()
    lyap.update_safe_set()
    first = read_launches()
    c_dev = lyap.c_max
    safe = np.array(lyap.safe_set)
    points = lyap._device_points()
    negative = _negative_batch(
        lyap.policy, lyap.dynamics, lyap.lyapunov_function,
        lyap._lipschitz_lyapunov, lyap._lipschitz_dynamics, lyap.tau,
        points)[0].cpu().numpy()
    margin = st.oracle.calibrate_certificate_margin(lyap, num_samples=4096)
    lyap.update_safe_set()
    launches = read_launches()

    check_values(lyap)
    start = time.perf_counter()
    oracle_safe, c_ref = st.oracle.oracle_safe_set(lyap)
    margins64 = st.oracle.oracle_margins(lyap,
                                         lyap.discretization.all_points)
    oracle_s = time.perf_counter() - start
    initial = np.zeros(len(safe), dtype=bool)
    initial[inst["initial_set"]] = True
    print("flagship {} path: {} points, tau {!r}, L_v {!r}, L_f {!r}, "
          "threshold {!r}, {} exempt initial points; built in {:.3f} s, "
          "f64 host oracle in {:.3f} s".format(
              route, lyap.discretization.nindex, inst["tau"], inst["lv"],
              inst["lf"], -inst["lv"] * (1 + inst["lf"]) * inst["tau"],
              int(initial.sum()), build_s, oracle_s))
    print("flagship {}: c_max={!r} (f64 oracle {!r}) safe_frac={!r} "
          "(oracle {!r}) safe points {} (oracle {})".format(
              route, c_dev, c_ref, float(safe.mean()),
              float(oracle_safe.mean()), int(safe.sum()),
              int(oracle_safe.sum())))
    gate_1(c_dev, c_ref)
    # Decrease verdicts: the card's against the oracle's at every point.
    band = np.abs(margins64) <= margin
    wrong = (negative != (margins64 < 0)) & ~band
    passing = int((negative & ~initial).sum())
    print("decrease check: {} points pass on the card, {} in the f64 "
          "oracle; {} disagree, all within the calibrated band |margin| <= "
          "{!r} ({} points in it); {} pass outside the initial set".format(
              int(negative.sum()), int((margins64 < 0).sum()),
              int((negative != (margins64 < 0)).sum()), margin,
              int(band.sum()), passing))
    if wrong.any():
        raise AssertionError("{} decrease verdicts differ from the f64 "
                             "oracle outside the calibrated band".format(
                                 int(wrong.sum())))
    if passing == 0:
        raise AssertionError("no point beyond the initial set passes the "
                             "decrease check")
    print("conservative: margin={!r} level_margin={!r} c_max={!r} "
          "(<= oracle {!r}) safe_frac={!r}".format(
              margin, lyap.level_margin, lyap.c_max, c_ref,
              float(lyap.safe_set.mean())))
    gate_2(lyap.c_max, c_ref)
    print("kernel launches during the flagship {} path: first sweep {}, "
          "whole path {}".format(route, first, launches))
    if first[kernel] < per_sweep:
        raise AssertionError("the flagship {} sweep launched {} {} times, "
                             "not {}".format(route, kernel, first[kernel],
                                             per_sweep))
    return lyap, launches


def sweep_fn(lyap):
    """One fused sweep of a Lyapunov instance, as ``update_safe_set`` runs
    it."""
    points = lyap._device_points()
    exempt = lyap._exempt_dev

    def sweep():
        return _fused_update(
            lyap.policy, lyap.dynamics, lyap.lyapunov_function,
            lyap._lipschitz_lyapunov, lyap._lipschitz_dynamics, lyap.tau,
            points, exempt, lyap.certificate_margin, lyap.level_margin)

    return sweep


def time_sweep(name, lyap, card):
    sweep = sweep_fn(lyap)
    safe_dev = sweep()[0]
    if safe_dev.device != torch.device("cuda:0"):
        raise AssertionError("safe mask computed on {}".format(
            safe_dev.device))
    sweep_ms = cuda_ms(sweep)
    n = lyap.discretization.nindex
    print("{} sweep: _fused_update at {} points: {!r} ms, {!r} grid-point "
          "checks/s [{}]".format(name, n, sweep_ms, n / (sweep_ms * 1e-3),
                                 card))


def time_against_plain(name, kernel, plain, card, shape):
    """Kernel against plain, in turns (plain, kernel, kernel, plain)."""
    plain_runs = [cuda_ms(plain, batch=10)]
    kernel_runs = [cuda_ms(kernel, batch=10), cuda_ms(kernel, batch=10)]
    plain_runs.append(cuda_ms(plain, batch=10))
    kernel_ms = statistics.mean(kernel_runs)
    plain_ms = statistics.mean(plain_runs)
    print("{} at {}: kernel {!r} ms (runs {!r}), plain {!r} ms (runs {!r}) "
          "[{}]".format(name, shape, kernel_ms, kernel_runs, plain_ms,
                        plain_runs, card))
    return kernel_ms, plain_ms


def phase_times(card, inst, lyap):
    """Kernel 1 and the bench sweep on the bench path's inputs."""
    time_sweep("bench", lyap, card)
    points = lyap._device_points()
    # The kernel's inputs exactly as the sweep makes them.
    gp = inst["gp"]
    ls = gp.kernel.lengthscales
    states = concatenate_inputs(points, lyap.policy(points))
    inputs = ((states / ls).contiguous(), (gp.X_buf / ls).contiguous(),
              gp.chol_inv, gp.alpha, gp._mask(),
              gp.kernel.variance * gp.scale ** 2)
    em, ev, ratio = compare(inputs, "rbf")
    print("bench-path inputs (Q={}, cap={}, p={}): max|dmean|={:.3e} "
          "max|dvar|={:.3e} err/bound={:.3f}".format(
              states.shape[0], gp.capacity, gp.output_dim, em, ev, ratio))
    if not ratio <= 1.0:
        raise AssertionError("kernel disagrees on the bench-path inputs")
    kernel_ms, plain_ms = time_against_plain(
        "gp predict",
        lambda: gp_kernel.gp_predict_cuda(*inputs, kind="rbf"),
        lambda: gp_kernel.gp_predict_plain(*inputs, kind="rbf"), card,
        "Q={}, cap {}".format(states.shape[0], gp.capacity))
    return max(em, ev), kernel_ms, plain_ms


def phase_flagship_times(card, route, lyap):
    """A flagship route's sweep, and its kernel against its plain version
    on the sweep's own inputs."""
    time_sweep("flagship " + route, lyap, card)
    points = lyap._device_points()
    states = concatenate_inputs(points, lyap.policy(points))
    if route == "stacked":
        gp = lyap.dynamics
        programs, params = gp._programs()
        inputs = (states, gp.X_buf, gp_kernel.program_params(params, states),
                  gp.chol_inv, gp.alpha[:, :, 0].contiguous(), gp._mask(),
                  gp.scale ** 2)
        cuda, plain = (gp_kernel.gp_predict_stacked_cuda,
                       gp_kernel.gp_predict_stacked_plain)
        arg = programs
    else:
        gp = lyap.dynamics.functions[0]
        program, params = gp_kernel.compile_kernel_program(
            gp.kernel, input_dim=gp.input_dim)
        programs = (program,)
        inputs = (states, gp.X_buf, gp_kernel.program_params(params, states),
                  gp.chol_inv, gp.alpha, gp._mask(), gp.scale ** 2)
        cuda, plain = (gp_kernel.gp_predict_general_cuda,
                       gp_kernel.gp_predict_general_plain)
        arg = program
    em, ev, ratio = compare_program("general" if route == "fan_out"
                                    else "stacked", inputs, programs)
    shape = "Q={}, cap {}, S={}".format(states.shape[0], gp.capacity,
                                        len(programs))
    print("flagship {} inputs ({}): max|dmean|={:.3e} max|dvar|={:.3e} "
          "err/bound={:.3f}".format(route, shape, em, ev, ratio))
    if not ratio <= 1.0:
        raise AssertionError("kernel disagrees on the flagship inputs")
    kernel_ms, plain_ms = time_against_plain(
        "gp predict {}".format("stacked" if route == "stacked"
                               else "general"),
        lambda: cuda(*inputs, arg), lambda: plain(*inputs, arg), card,
        shape)
    return max(em, ev), kernel_ms, plain_ms


def main():
    card = phase_device()
    phase_build()
    phase_kernel_cases()
    phase_program_cases()
    inst, bench_lyap, bench_launches = phase_bench_path()
    stacked_lyap, stacked_launches = phase_flagship_path("stacked")
    fan_lyap, fan_launches = phase_flagship_path("fan_out")
    results = {
        "gp_predict": (bench_launches["gp_predict"],)
        + phase_times(card, inst, bench_lyap),
        "gp_predict_stacked": (stacked_launches["gp_predict_stacked"],)
        + phase_flagship_times(card, "stacked", stacked_lyap),
        "gp_predict_general": (fan_launches["gp_predict_general"],)
        + phase_flagship_times(card, "fan_out", fan_lyap),
    }
    print(card)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": KERNELS[name][1],
         "replaces": KERNELS[name][2], "launches": launches,
         "max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms}
        for name, (launches, err, kernel_ms, plain_ms)
        in results.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
