"""Drive the PyTorch/CUDA port's main path once on one GPU and check it.

Usage, from the repository root on a machine with an NVIDIA Hopper GPU
and the CUDA toolkit:

    python3 chip_smoke.py

Phases, in order; any failure raises and the exit code is not 0:

1. device: requires CUDA and compute capability 9.0, sets
   ``config.device = "cuda:0"`` and prints the card's name and power limit;
2. build: compiles ``safe_learning_tpu_torch/csrc/gp_predict.cu`` for
   ``sm_90a`` and prints the build time and the compiler's report;
3. kernel against plain: the CUDA GP-predict kernel against its plain
   PyTorch version on the card, for every stationary kind, capacities 8,
   128 and 2048 with a partly filled mask, 1 and 2 outputs, scale 1 and
   2.5, ragged query counts, float32 and float64, each within a stated
   rounding bound; one gradient through the autograd rule;
4. main path: ``bench.py``'s instance (1000x1000 grid, RBF GP with 128
   points and a linear prior mean, quadratic Lyapunov candidate) built
   through the port's public API; ``Lyapunov.update_safe_set`` and
   ``oracle.calibrate_certificate_margin`` pass ``bench.py``'s two gates
   against its float64 numpy oracle, and the kernel's launch counter
   shows the sweep went through the kernel;
5. times: CUDA events, median of 10 runs after warm-up, for one fused
   sweep and for the kernel against the plain version at 10^6 queries.

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
from safe_learning_tpu_torch.lyapunov import _fused_update
from safe_learning_tpu_torch.ops import gp_kernel
from safe_learning_tpu_torch.ops.build import build_reports

KERNEL_SOURCE = "safe_learning_tpu_torch/csrc/gp_predict.cu"
TPU_KERNEL = "safe_learning_tpu/ops/gp_kernel.py:169"
KERNEL_CLASSES = {"rbf": st.RBF, "matern12": st.Matern12,
                  "matern32": st.Matern32, "matern52": st.Matern52}


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


def cuda_ms(fn, reps=10, warmup=2):
    """Median milliseconds of ``fn()`` over ``reps`` runs (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
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
    start = time.perf_counter()
    gp_kernel.kernel_library()
    seconds, report = build_reports["gp_predict"]
    print("build: {:.3f} s wall ({:.3f} s nvcc) from {}".format(
        time.perf_counter() - start, seconds, KERNEL_SOURCE))
    print(report.strip())


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


def phase_main_path():
    from bench import _oracle_c_max

    inst = build_bench_instance(1000)
    grid = inst["grid"]
    gp_kernel.gp_predict_cuda.launches = 0
    lyap = st.Lyapunov(grid, inst["v"], inst["gp"], inst["lf"], inst["lv"],
                       inst["tau"], inst["policy"],
                       initial_set=inst["initial_set"])
    lyap.update_safe_set()
    c_dev = lyap.c_max
    safe_frac = float(lyap.safe_set.mean())
    margin = st.oracle.calibrate_certificate_margin(lyap, num_samples=4096)
    lyap.update_safe_set()
    launches = gp_kernel.gp_predict_cuda.launches

    if lyap.values.device != torch.device("cuda:0"):
        raise AssertionError("values computed on {}".format(
            lyap.values.device))
    if lyap.values.shape != (grid.nindex,) or not bool(
            torch.isfinite(lyap.values).all()):
        raise AssertionError("values are not finite of shape (nindex,)")
    c_ref, frac_ref = _oracle_c_max(
        grid, inst["a"], inst["x_train"], inst["y_train"], inst["params"],
        inst["lf"], inst["tau"], inst["initial_set"])
    print("main path: c_max={!r} (f64 oracle {!r}) safe_frac={!r} "
          "(oracle {!r})".format(c_dev, c_ref, safe_frac, frac_ref))
    if not 0.05 < safe_frac < 0.95:
        raise AssertionError("instance must discriminate (safe_frac={})"
                             .format(safe_frac))
    if not abs(c_dev - c_ref) <= 5e-4 * max(abs(c_ref), 1.0):
        raise AssertionError("certified level {} != f64 oracle {}".format(
            c_dev, c_ref))
    print("gate 1 passed: |c_max - oracle| = {!r} <= {!r}".format(
        abs(c_dev - c_ref), 5e-4 * max(abs(c_ref), 1.0)))
    print("conservative: margin={!r} level_margin={!r} c_max={!r} "
          "(<= oracle {!r}) safe_frac={!r}".format(
              margin, lyap.level_margin, lyap.c_max, c_ref,
              float(lyap.safe_set.mean())))
    if not lyap.c_max <= c_ref + 1e-7 * max(abs(c_ref), 1.0):
        raise AssertionError("margin-guarded level {} exceeds f64 oracle "
                             "{}".format(lyap.c_max, c_ref))
    print("gate 2 passed")
    print("kernel launches during the main path: {}".format(launches))
    if launches < 1:
        raise AssertionError("the main path never launched the kernel")
    return inst, lyap, launches


def phase_times(card, inst, lyap):
    points = lyap._device_points()
    exempt = lyap._exempt_dev

    def sweep():
        return _fused_update(
            lyap.policy, lyap.dynamics, lyap.lyapunov_function,
            lyap._lipschitz_lyapunov, lyap._lipschitz_dynamics, lyap.tau,
            points, exempt, lyap.certificate_margin, lyap.level_margin)

    safe_dev = sweep()[0]
    if safe_dev.device != torch.device("cuda:0"):
        raise AssertionError("safe mask computed on {}".format(
            safe_dev.device))
    sweep_ms = cuda_ms(sweep)
    n = lyap.discretization.nindex
    print("sweep: _fused_update at {} points: {!r} ms, {!r} grid-point "
          "checks/s [{}]".format(n, sweep_ms, n / (sweep_ms * 1e-3), card))

    # The kernel's inputs exactly as the sweep makes them.
    gp = inst["gp"]
    ls = gp.kernel.lengthscales
    states = concatenate_inputs(points, lyap.policy(points))
    inputs = ((states / ls).contiguous(), (gp.X_buf / ls).contiguous(),
              gp.chol_inv, gp.alpha, gp._mask(),
              gp.kernel.variance * gp.scale ** 2)
    em, ev, ratio = compare(inputs, "rbf")
    print("main-path inputs (Q={}, cap={}, p={}): max|dmean|={:.3e} "
          "max|dvar|={:.3e} err/bound={:.3f}".format(
              states.shape[0], gp.capacity, gp.output_dim, em, ev, ratio))
    if not ratio <= 1.0:
        raise AssertionError("kernel disagrees on the main-path inputs")

    def kernel():
        return gp_kernel.gp_predict_cuda(*inputs, kind="rbf")

    def plain():
        return gp_kernel.gp_predict_plain(*inputs, kind="rbf")

    plain_runs = [cuda_ms(plain)]
    kernel_runs = [cuda_ms(kernel), cuda_ms(kernel)]
    plain_runs.append(cuda_ms(plain))
    kernel_ms = statistics.mean(kernel_runs)
    plain_ms = statistics.mean(plain_runs)
    print("gp predict at Q={}, cap {}: kernel {!r} ms (runs {!r}), plain "
          "{!r} ms (runs {!r}) [{}]".format(
              states.shape[0], gp.capacity, kernel_ms, kernel_runs,
              plain_ms, plain_runs, card))
    return max(em, ev), kernel_ms, plain_ms


def main():
    card = phase_device()
    phase_build()
    phase_kernel_cases()
    inst, lyap, launches = phase_main_path()
    err, kernel_ms, plain_ms = phase_times(card, inst, lyap)
    print(json.dumps({"kernels": [{
        "name": "gp_predict", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": TPU_KERNEL, "launches": launches, "max_abs_err": err,
        "ms": kernel_ms, "plain_ms": plain_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
