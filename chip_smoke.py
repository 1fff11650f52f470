"""Drive the PyTorch/CUDA port's main paths once on one GPU and check them.

Usage, from the repository root on a machine with an NVIDIA Hopper GPU
and the CUDA toolkit:

    python3 chip_smoke.py

Phases, in order; any failure raises and the exit code is not 0:

1. device: requires CUDA and compute capability 9.0, sets
   ``config.device = "cuda:0"`` and prints the card's name and power limit;
2. build: compiles the stationary kernel (``csrc/gp_predict.cu``), its
   four variants (``csrc/gp_predict_variants.cu``) and one library per
   covariance program tuple (``csrc/gp_predict_program.cuh``) for
   ``sm_90a``, one ``nvcc`` each, all at once, and prints each build's
   time and the compiler's report; ``sass_check`` reads ``cuobjdump
   --dump-sass`` of kernels 1-3's libraries and the variants': every
   float64 tiled and panel kernel of kernels 1-3 holds ``DMMA`` (the
   product on the FP64 tensor cores), no float32 kernel and no float64
   streamed kernel does, and none of them a TF32 tensor-core instruction;
   of the variants, kernels 6 and 7's float32 tiled kernels hold TF32
   ``HGMMA`` (three passes, off every path) and no other does;
3. kernel 1 against plain: the stationary GP-predict kernel against its
   plain PyTorch version on the card, for every stationary kind,
   capacities 8, 128 and 2048 with a partly filled mask, 1 and 2 outputs,
   scale 1 and 2.5, ragged query counts, float32 and float64, and at the
   cart-pole's d = 5, p = 4 and the d = 16, p = 8 edge (``WIDE_CASES``),
   each within a computed rounding bound; one gradient through the
   autograd rule;
4. kernels 2 and 3 against plain: the general and stacked program kernels
   against their plain versions, for four programs (the flagship's
   composite kernel, an ARD RBF, a product of stationary kernels on
   different ``ActiveDims``, ``Matern12 + Matern52 + Linear``),
   capacities 8 to 2048, 1 and 2 outputs (general), 1 to 3 stacked
   outputs, scale 1 and 2.5, ragged query counts up to about 10^6,
   float32 and float64, each within a computed bound; the panel body at
   capacities 256 and 512; one gradient each, and kernel 3's at the
   adaptive example's capacity and count 181;
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
   against the port's float64 oracle (``oracle.oracle_safe_set``; its
   margins computed once, for the first route, and held for the second:
   the same GPs on the same data), certifies more than the exempt initial
   set, and went through its kernel;
7. sweep times: CUDA events, median of 10 runs after warm-up, for the
   bench and flagship sweeps (one sweep a run);
8. safe learning: the inverted pendulum's loop of
   ``examples/inverted_pendulum.py`` at its ``--full`` width
   (``build_safe_learning_instance``: 2001x1501 grid, a ``[2, 32, 32, 1]``
   MLP policy at a seeded Xavier initialisation, the ``Triangulation``
   value function on a 55x55 grid with the local ``L_v`` of its
   ``GradientNorm``, a stacked GP at capacity 64 with no data): certify,
   ten rounds of ``get_safe_sample``, a measurement and ``add_data_point``,
   re-certify. Both sweeps pass the flagship's gate against the float64
   oracle (outside the calibrated band, only conservative disagreements
   explained by a simplex jump are accepted, each listed), each chosen
   pair re-scores safe in float64 and matches the pair kernel 3's plain
   twin chooses, the bordered appends match a fresh factorization, no
   library is built, and each sweep and step launched kernel 3 exactly
   once; then the loop's sweep and step times (``loop_step_times``);
9. training (``phase_training``, ``SafeTraining``): the example's policy
   iteration at its ``--full`` width, the same instance with the example's
   reward and ``gamma`` 0.98 in a ``PolicyIteration``: 3000 pretraining
   ascent steps on the GP's mean, two rounds of the exact value solve and
   200 steps of the ascent penalised by the Lyapunov Lagrangian, certify,
   then 5 iterations of 10 exploration steps, a round and a certify; the
   closed loop from ``(1, -0.5)``. Checks, each raising: (1) kernel 3
   carries every GP predict, launched exactly once per ascent step, value
   solve, sweep and exploration step (twice with the backup fallback), no
   other kernel and no library built; (2) at the first penalised step's
   minibatch (GP count 0) and at the last iteration's, the loss and the
   policy gradient through kernel 3's autograd rule against the plain
   route, with and without the penalty: float64 on the card to 1e-12 and
   1e-9 relative, float32 per sample within ``future_value_bounds``
   (samples that change simplex excluded and counted) and the gradient
   to 1e-4; (3) every value solve is a fixed point to 2 tol in float64 on
   the host, and a one-iteration solve raises ``OptimizationError``; (4)
   the trained policy holds no autograd state and a trained sweep's peak
   memory is within 10 % of phase 8's; (5) the last certify passes
   ``oracle_gate``; (6) the true pendulum under the trained policy ends
   below a state norm of 0.5 within 100 steps. Reported: the rewards of
   the old and new policy, the safe fraction and ``c_max`` after each
   certify, ``compute_roa`` of the trained closed loop; timed: each
   stage's wall time, each ascent's step time, each value solve, the
   trained sweep, the loop's steps, ``compute_roa``;
10. adaptive verification (``phase_adaptive``,
    ``build_adaptive_instance``): ``examples/adaptive_safety_verification.
    py --full``, a 501x501 grid, a stacked GP at capacity 181, sorted
    certifies with refinement up to 16, 12 updates of 15 measurements by
    ``get_safe_sample_batch`` (the device append between steps). Checks:
    kernel 3 once per sampler step, coarse pass and refinement chunk; no
    host wait inside the sampler's steps; each batch's pairs against the
    plain twin's; every device append's count precondition and its GP
    against the float64 refresh; the first certify, the last and each
    one above count 128 against the float64 oracle with the refined
    calibration as the band; the first
    certify by the fan-out route (kernel 2) equal; the example's
    assertion. Per update: safe fraction, ``c_max``, largest N(x),
    chunks, refined points, wall and CUDA-event times; above count 128
    (the panel body) each certify's kernel-3 launches replayed on the
    panel and on the streamed body; kernel 3's launches by part (sampler
    steps, coarse passes, refinement chunks) and how many ran above 128;
11. cart-pole verification (``phase_cartpole_verification``,
    ``build_cartpole_instance``): ``benchmarks/cartpole_51x4_sweep.py``'s
    instance, the reference's largest workload, a 51^4 = 6,765,201-state
    grid and a 128-point RBF GP over the 5 state-action inputs with 4
    outputs: one sweep launches kernel 1 once at d = 5, p = 4; the sweep
    passes ``oracle_gate``; the sweep's time and checks/s;
12. cart-pole RL (``phase_cartpole_rl``): ``examples/
    reinforcement_learning_cartpole.py --full`` through the port's script,
    its 400 joint actor-critic iterations cut to 100
    (``CARTPOLE_JOINT_ITERS``), each of 50 + 10 eager SGD steps, the
    closed loops, and both 2000-step ROAs over the 51^4 grid with no host
    wait in the rollouts; the example's assertions; the float32 LQR ROA
    against a float64 rollout of 65,536 sampled states; the fractions
    beside the JAX package's record, the training's and the rollouts'
    times, the peak memory;
13. 1-D ROA (``phase_one_d_roa``): ``examples/
    one_d_region_of_attraction_estimate.py --full`` through the port's
    script, its true system drawn from the JAX package's normals
    (``ONE_D_NORMALS``): kernel 2 once a GP predict (each sweep and
    ``evaluate``), the record's history (0.199 -> 1.000 within 3
    measurements, ``c_max`` 1.0000) against the same loop on the CPU, the
    last certify through ``oracle_gate``; then ``fit_gp_hyperparameters``
    on the card (Adam, L-BFGS-B) within 1e-3 of the float64 fit;
14. streamed exactness (``phase_streamed_exactness``): ``bench.py``'s
    instance at 1000x1000 with ``config.fused_sweep_limit`` lowered to
    2^16, so ``update_safe_set`` streams 16 batches of states made on the
    card: kernel 1 once a batch, the safe set and ``c_max`` equal to the
    JAX package's sorted-prefix rule (a host stable sort over the sweep's
    own values and verdicts), before and after the margins are
    calibrated; no host wait once a batch; the fused sweep
    of the same instance equal but for the states tied with ``v_bad``;
15. the 10^8 sweep (``phase_giant_sweep``):
    ``safe_learning_tpu_torch.benchmarks.giant_sweep_1e8.run``, the same
    instance at 10001x10001 = 100,020,001 points in batches of 2^21:
    kernel 1 within ``rounding_bounds`` at the first batch's inputs, then
    the margin, two equal sweeps each launching kernel 1 once a batch (48),
    0 of 400,000 sampled certified states failing the float64 oracle and
    ``c_max`` at or below its level; seconds, checks/s, CUDA-event ms,
    peak device memory;
16. the sharded sweeps (``phase_sharded``, ``parallel``): the port's
    dryrun module (``python -m safe_learning_tpu_torch.parallel.dryrun``)
    over 2 gloo ranks and over 1 NCCL rank on ``cuda:0``, each to its OK
    line (the five phases of ``scripts/multiprocess_dryrun.py``, 1-4 bit
    for bit the single-process run), every rank on the card with kernels
    1 and 3 launched; at the same time full width over 2 gloo ranks
    sharing the card (``sharded_worker``, this script with
    ``--sharded-worker``): the bench
    sweep, the 10^8 streamed sweep (24 batches a rank) and one adaptive
    certify at count 181 and refinement 16 (restored from a checkpoint of
    phase 10's state), each bit for bit the single-process result and
    each rank launching its kernel; the bench on one process's meshes of
    1, 2 and 4 entries of ``cuda:0``, equal, and ``benchmarks/
    mesh_scaling.py``; each rank's wall, CUDA-event ms, GP-kernel device
    ms under the profiler, launches and peak memory and the all-reduce
    latency;
17. region tools (``phase_region_tools``): ``get_lyapunov_region`` on the
    bench candidate at 1000x1000 by the native flood fill and by the
    Python heap, equal, and over float64 values, equal but within float32
    rounding of the stopping value; ``smallest_boundary_value`` against
    float64;
18. the 1-D example (``phase_one_d_example``): ``examples/one_d_example.py
    --full`` through the port's script: kernel 2 once a GP predict, each
    predict within ``program_bounds`` of kernel 2's plain version, the
    record (0.050 -> 1.000, ``c_max`` 1.0000), a last certify through
    ``oracle_gate``;
19. the examples (``phase_examples``): ``basic_dynamic_programming`` (its
    command line, with ``--plot`` into a temporary directory only where
    matplotlib is installed, and then the PNG must exist; the H100
    machine's installation has none, so there the plot is not drawn and
    the script prints so) and ``lyapunov_function_learning`` at ``--full``
    (the latter's checkpoint round trip bit for bit),
    ``reinforcement_learning_pendulum`` at its ``--full`` widths with the
    joint iterations cut (printed), each with its assertions;
20. derived margins (``phase_derived_margins``, ``errorbounds``): first
    ``transcendental_ulps``, the worst relative error of torch's float32
    exp, sin, cos, tanh and sigmoid on the card against float64, at most
    ``config.fp_error_factor`` units of 2^-24; then on the bench instance
    the per-point and the scalar derived margin (their wall times), the
    float32 margin through kernel 1 within the per-point bound of the
    float64 oracle's at all 10^6 states, the sweeps with either installed
    inside the oracle's set and at or below its level, the derived margin
    beside the measured one, and ``get_safe_sample`` on the per-candidate
    path, its candidates' float32 future values within their margins of
    float64 and the chosen row passing the exact level test; on the
    adaptive instance at count 181 (kernel 3's panel body)
    ``analytic_certificate_margin(refinement=16, per_point=True)`` and a
    certify at ``max_refinement=16``, 400,000 seeded refined sub-points
    within their state's bound of the float64 oracle, ``check_certify``
    with no band;
21. the rigor ladder (``phase_rigor``, ``ops.extended_verify``): first
    ``transcendental_ulps`` in float64, torch's exp, sin, cos, tanh and
    sigmoid on the card within ``FP_ERROR_FACTOR64`` units of 2^-53 of
    ``numpy.longdouble``; the float64 kernels' error against
    ``numpy.longdouble`` on 10,000 seeded queries at the bench's and the
    last refinement chunk's inputs within the bound the float64 margins
    assume (``longdouble_check``, ``U_EFF`` a rounding); on the bench
    instance (kernel 1 in float64)
    ``extended_certificate_margin``, the float64 check within it of phase
    20's float64 oracle at all 10^6 states, ``update_safe_set(extended=
    True)`` and ``extended="hybrid"`` in turns, both inside the oracle's
    set and equal bit for bit (the band fraction, each sweep's time beside
    the float32 sweep's), ``get_safe_sample(extended=True)`` with its row's
    float64 future value below ``c_max`` minus the margin; on the adaptive
    instance at count 181 (kernel 3's float64 panel body) the same at
    refinement 16, the float64 check within the per-state margin of the
    oracle at 400,000 seeded refined sub-points and ``check_certify`` with
    no band; then ``one_d_region_of_attraction_estimate --full`` with
    ``--extended`` and ``--hybrid`` (kernel 2 in float64) and
    ``lyapunov_function_learning --full --extended``, each with its
    assertions;
22. the pendulum's rigor run (``phase_pendulum_rigor``):
    ``examples/inverted_pendulum.py --full --hybrid`` through the port's
    module (the 2001x1501 grid, the ``[2, 32, 32, 1]`` network, the
    stacked GP at capacity 64), its depth cut (``PENDULUM_RIGOR_*``):
    after each certify the extended sweep on the
    same state equal to the hybrid's bit for bit and the set inside the
    float64 oracle's at all 3,003,501 states; the margin and band tier of
    each certify; kernel 3 in float64 only inside the float64 checks and
    in float32 elsewhere (``rigor_launches``);
23. the adaptive example's fan-out route (``phase_adaptive_sequential``):
    ``examples/adaptive_safety_verification.py --full --sequential``
    through the port's module, its updates cut to
    ``ADAPTIVE_SEQUENTIAL_UPDATES`` (GP count 136): the first certify equal
    to phase 10's stacked one, kernel 2 alone, its panel body above count
    128, each certify there against the float64 oracle outside the
    calibrated band (``check_certify``), the example's assertion;
24. the bench grown (``phase_bench_grown``): ``bench.py``'s instance at
    512 and 2,048 training points, kernel 1 once a certify on its panel and
    strip bodies (``gp_kernel.stationary_body``), at 512 every decrease
    verdict against the float64 oracle outside the calibrated band and the
    ``c_max`` gap, at 2,048 the host float64 factorization's time;
25. the adaptive example grown past the panel body
    (``phase_adaptive_grown``): ``run(full=True, updates=3,
    data_per_update=340, capacity=1024)``, certifies at counts 1, 341, 681
    and 1,021: kernel 3's launches and bodies, the device appends, the
    oracle gate at 1,021, the fan-out re-certify equal, the rigor
    certifies at 341 (refinement 4) and 1,021 (refinement 16; hybrid =
    extended, inside the oracle's verdicts), the example's assertion;
26. count cases, kernel 1 and kernels 2 and 3 (``COUNT_CASES``: counts 0,
    1, 10, both sides of each bucket edge 16/32/64/128, 129 and 2048,
    below and at capacity; kernel 1 also at d = 6, and at d = 5, p = 4 and
    d = 16, p = 8, ``WIDE_COUNT_CASES``; kernels 2 and 3 also the panel
    body's ``panel_count_cases``: counts 129 to its largest count and one
    past it, S = 1 to 3, p up to 8, d up to 16, each taking the body its
    count selects): the kernels' loops bounded by the count, against the
    plain versions at full capacity, exact zeros at count 0; then the
    float64 DMMA bodies at their edges (``phase_dmma_cases``:
    ``DMMA_COUNTS``, 1 to 256 across every k step, row tile and bucket,
    p 1 to 8, S 1 to 3), far queries with subnormal k within
    ``underflow_bounds``, and ``position_check``: each query's float64
    outputs bit for bit the same at each of ``position_shifts`` in its
    query tile, reversed and alone;
27. kernel times: each kernel against its plain version on its path's
    own inputs, on the device alone (a CUDA graph of 10 calls,
    ``graph_ms``; of 2 calls for a plain version, ``PLAIN_GRAPH``, whose
    change from 10 replays of 10 calls ``plain_method_check`` reads at the
    bench) and as a caller sees it (10 eager calls), and each
    kernel's bound at those inputs (``kernel_bound``) and the solve's
    product alone as ``library_ms`` (``stationary_product_ms``,
    ``product_ms``): kernel 1 at the cart-pole's sweep, a batch of the
    10^8 streamed sweep and the bench's sweep, kernel 2 at the 1-D ROA's,
    the 1-D example's and the flagship fan-out sweep, kernel 3 at the
    flagship, a training ascent step, the safe-learning sweep and the
    adaptive path's sampler step, refinement chunk and coarse pass (count
    181, ``panel_times``: the panel body in turns with the streamed
    body), kernels 1 to 3 on the grown paths (``grown_bench_times``,
    ``grown_times``: the bench at 512 and 2,048, the grown loop's sampler
    step, chunk, coarse pass and fan-out coarse pass at count 1,021, the
    strip body in turns with the streamed body); kernels 1 to 3 in float64
    at the rigor paths' inputs (the
    bench, the adaptive coarse pass and last refinement chunk, the 1-D
    ROA, the pendulum's rigor sweep at S = 2; ``kernel_bound`` at the FP64
    peak; ``"design": "dmma"``), under the rows' ``paths``; kernel 2's
    panel body at the
    fan-out route's coarse pass (count 136); kernels 1 and 3 at one rank's
    inputs of phase 16's sharded paths (``sharded_paths``: the bench's
    first shard, a batch of the 10^8 sweep's second rank, the adaptive
    coarse pass's first shard), under ``paths`` with every rank's
    launches;
    then kernel 1's four variants
    (``phase_kernel_variants``, the pipelined, interleaved by 2 and 4,
    folded and expanded-distance kernels of the port's benchmark modules):
    (a) each against its plain version within its bound
    (``rounding_bounds``, ``folded_bounds``, ``expanded_bounds``; kernels
    6 and 7's three-pass TF32 bodies with ``tf32x3``) in float32 and
    float64, the four kinds, capacities 8, 128 and 2048 and the
    cart-pole's d = 5, p = 4, then in float32 the count edges ``VARIANT_COUNTS`` with queries on
    training rows; (b) at the bench's and the cart-pole's
    kernel-1 inputs, their path, ``pipelined_predict.run`` and
    ``distance_mxu_experiment.run`` (launches counted; each variant's max
    |d| from kernel 1 and speed-up), then each against its plain version,
    device times in turns with kernel 1's, eager and plain times, and
    the solve's product alone at those inputs as their ``library_ms``; (c) the
    folded and expanded forms' and kernel 1's errors against the float64
    oracle; then
    the loop's step times again, to show how far the work before moved
    them;
28. profiles, after every time: ``profiling.trace`` over the safe-learning and
    the bench sweeps (``profile_sweep``), over 20 pretraining and 20
    penalised ascent steps (``profile_training``) and over the adaptive
    path's batches and certifies (``profile_adaptive``), the device's busy
    share, its operations per unit and where its time goes; the ascent
    fails if the host waits for the device inside its step loop
    (``torch.cuda.set_sync_debug_mode``).

The end-to-end times (phases 7 to 19, the sweeps of 21, 22 and 23) come
before the count cases and before any CUDA graph is captured.

The second-to-last line is a JSON object describing each kernel
(``kernel_rows``: launches, error, times, bound and its kind, per path);
the last line is ``{"ok": true, "device": {...}}``.

``python3 chip_smoke.py --rigor-certify`` runs phase 21's adaptive
certify alone and prints its times as one JSON line
(``rigor_certify_times``); with ``python3 -P`` and ``PYTHONPATH`` set to
another checkout it times that checkout's package, so two commits can be
timed in turns on the same card.
"""

import collections
import concurrent.futures
import contextlib
import copy
import functools
import hashlib
import importlib.util
import json
import multiprocessing
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import types
import warnings

import numpy as np
import torch

import safe_learning_tpu_torch as st
from safe_learning_tpu_torch import explore as explore_mod
from safe_learning_tpu_torch import lyapunov as lyapunov_mod
from safe_learning_tpu_torch import profiling
from safe_learning_tpu_torch.functions.base import concatenate_inputs
from safe_learning_tpu_torch.lyapunov import (_decrease_bound, _fused_update,
                                              _negative_batch, _threshold,
                                              refinement_offsets)
from safe_learning_tpu_torch.benchmarks import distance_mxu_experiment
from safe_learning_tpu_torch.examples import (adaptive_safety_verification,
                                              inverted_pendulum)
from safe_learning_tpu_torch.examples.adaptive_safety_verification import (
    ACTION_LIMITS as ADAPTIVE_LIMITS, ACTION_VARIATION as ADAPTIVE_VARIATION,
    CAPACITY as ADAPTIVE_CAPACITY, DATA_PER_UPDATE as ADAPTIVE_DATA,
    REFINEMENT as ADAPTIVE_REFINEMENT, UPDATES as ADAPTIVE_UPDATES,
    build_instance as build_adaptive_instance)
from safe_learning_tpu_torch.examples.inverted_pendulum import (
    ACTION_VARIATION, DATA_PER_ITER, EXPLORATION_SAMPLES, GAMMA, OUTER_ITERS,
    POLICY_ITERS, PRETRAIN_ITERS, SafeTraining, build_safe_learning_instance,
    measure_and_append, pendulum_kernel as flagship_kernel, safe_sample)
from safe_learning_tpu_torch.benchmarks import giant_sweep_1e8
from safe_learning_tpu_torch.benchmarks import pipelined_predict
from safe_learning_tpu_torch.ops import extended_verify, gp_kernel
from safe_learning_tpu_torch.ops.build import build_reports

KERNEL_CLASSES = {"rbf": st.RBF, "matern12": st.Matern12,
                  "matern32": st.Matern32, "matern52": st.Matern52}

#: Each kernel: its wrapper (whose ``launches`` the paths read), its
#: source, and the Pallas body it replaces (``gp_kernel.kernels``). Kernel
#: 1's variants run on the port's benchmark modules
#: (``phase_kernel_variants``); kernel 3's streamed body only where it is
#: compared.
KERNELS = gp_kernel.kernels()

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


#: The cart-pole verification grid, 51^4 = 6,765,201 states: the
#: reference's largest workload (``benchmarks/cartpole_51x4_sweep.py:30``).
CARTPOLE_POINTS = 51


def build_cartpole_instance(num_points=CARTPOLE_POINTS):
    """The 51^4 cart-pole verification instance in the port.

    As ``benchmarks/cartpole_51x4_sweep.py:14-38`` builds it: the
    notebook's cart-pole normalized with ``u_max = (m + M) 4 / x_max``; the
    LQR gain and Riccati matrix ``P`` of its autodiff linearization
    (``Q = 0.1 I``, ``R = 0.1``); a GP with ``RBF(1e-10, [0.4] * 5)``,
    noise 1e-12 and the linearization ``[A, B]`` as prior mean on 128
    inputs uniform in ``[-1, 1]^5`` from ``default_rng(0)`` with the
    cart-pole's next states as targets; the saturated LQR policy; the
    candidate ``x' (P / max|P|) x`` with the scalar ``L_v = 2 |P / max|P||_2``
    and ``L_f = |A - B K|_2``; ``tau`` a thousandth of the smallest cell
    edge of the ``num_points^4`` grid over ``[-1, 1]^4``; the initial set
    at the 0.001 quantile of v. Returns ``(lyapunov, inst)``.
    """
    m, cart_mass, length, friction = 0.175, 1.732, 0.28, 0.01
    x_max, theta_max = 0.5, np.deg2rad(30)
    u_max = (m + cart_mass) * 4.0 / x_max
    norms = ((x_max, theta_max, 2.0, np.deg2rad(30)), (u_max,))
    system = st.CartPole(m, cart_mass, length, friction, 0.01,
                         normalization=norms)
    a, b = system.linearize()
    k, p = st.utils.dlqr(a, b, 0.1 * np.eye(4), 0.1 * np.eye(1))
    policy = st.Saturation(st.LinearSystem(-k), -1.0, 1.0)
    p = p / np.abs(p).max()
    v = st.QuadraticFunction(p)

    rng = np.random.default_rng(0)
    x_train = rng.uniform(-1, 1, size=(128, 5))
    y_train = system(x_train[:, :4], x_train[:, 4:]).cpu().numpy()
    gp = st.GaussianProcess(st.RBF(1e-10, [0.4] * 5, input_dim=5), x_train,
                            y_train, noise_variance=1e-12,
                            mean_function=st.LinearSystem([a, b]))
    grid = st.GridWorld([[-1.0, 1.0]] * 4, num_points)
    lv = float(2 * np.linalg.norm(p, 2))
    lf = float(np.linalg.norm(a - b @ k, 2))
    tau = float(np.min(grid.unit_maxes)) * 1e-3
    values = v(grid.all_points).reshape(-1).cpu().numpy()
    initial_set = np.where(values <= np.quantile(values, 0.001))[0]
    lyap = st.Lyapunov(grid, v, gp, lf, lv, tau, policy,
                       initial_set=initial_set)
    return lyap, dict(system=system, a=a, b=b, k=k, p=p, x_train=x_train,
                      y_train=y_train, lv=lv, lf=lf, tau=tau,
                      initial_set=initial_set)


#: The standard normals that draw the 1-D example's true system at its
#: default seed: ``jax.random.normal(jax.random.PRNGKey(0), (1, 201),
#: jnp.float32)`` (``examples/one_d_region_of_attraction_estimate.py:
#: 72-75``), held here because the two packages' generators differ;
#: ``tests/test_torch_gp_fit.py`` checks them against JAX's draw.
ONE_D_NORMALS = (
    1.6226422, 2.0252647, -0.43359444, -0.07861735, 0.1760909, -0.97208923,
    -0.49529874, 0.4943786, 0.6643493, -0.9501635, 2.1795304, -1.9551506,
    0.35857072, 0.15779513, 1.2770847, 1.5104648, 0.970656, 0.59960806,
    0.024700705, -1.9164772, -1.8593491, 1.728144, 0.04719035, 0.814128,
    0.13132767, 0.28284705, 1.2435943, 0.6902801, -0.80073744, -0.74099,
    -1.5388287, 0.30269185, -0.020716045, 0.11328721, -0.2206547, 0.07052256,
    0.8532958, -0.8217738, -0.014614211, -0.15046217, -0.9001352, -0.7590727,
    0.33309513, 0.80924904, 0.042692553, -0.57767123, -0.41439894, -1.9412533,
    1.3161184, 0.7542728, 0.16170931, -0.03483307, -1.3306409, 0.39362028,
    0.48259583, 0.80382955, -0.6337168, 1.038756, -0.74159133, -0.4299588,
    -0.22510043, -0.51966715, -1.6692165, 0.67535436, 0.22738722, -1.1800426,
    -0.97673357, 1.1969604, -0.84127563, 0.6598078, 1.0680159, 0.31542128,
    0.43766403, 1.1718564, 0.9077099, 1.2226242, -0.54639524, 0.85630435,
    -0.007965775, 0.47343913, -1.1090349, 2.6423514, 0.88957626, 0.9952015,
    0.2551972, 0.124961376, 1.164173, 0.19296366, -0.19099544, -0.43659472,
    -1.1461989, 0.19760251, 1.1686655, -0.8733985, 0.8818086, -0.3441057,
    -0.14614972, -0.91352165, 1.370097, -0.7800775, 0.36481506, 0.9761402,
    -0.007172703, 0.21052206, 0.19035842, 0.38291267, -1.2656332, -1.4843545,
    -0.114543624, 1.1037136, 0.19846702, 0.21388935, -0.6605348, -0.72722006,
    0.40443972, 0.18965738, -0.6031794, 0.9450588, 1.0838778, -2.0560737,
    -0.71382153, 0.59286827, 1.0507762, -1.4646238, 0.66001135, -0.30172178,
    0.13313177, -0.33281323, 1.5700098, 0.5745121, 0.7234155, 0.6966845,
    -0.66423434, -1.9669566, -2.4162543, 0.27330154, 1.1603173, 0.2655127,
    0.6909093, -0.2560643, -2.0227401, -0.6231289, 0.2795317, -1.3503172,
    0.10128845, 0.51268137, 0.2640195, -1.8291276, 1.4337775, 1.3188555,
    -1.4953226, 0.93327594, 1.4092648, -0.16788375, -0.11862286, -0.2428249,
    -0.96175927, -0.75636, 2.5728257, -1.0601792, 0.31232905, 0.3275118,
    0.08283223, -1.0826886, -0.7722345, -0.63460463, 1.2264103, -1.487015,
    -0.79286903, 0.5531185, -1.1855397, 0.9769094, -0.43845034, -0.329756,
    0.33254716, -0.6527196, -1.2052122, -0.88630825, -2.1088374, -0.15503536,
    -0.65793204, -0.663254, -0.03336205, -0.8959291, 0.0771168, -0.909823,
    1.276052, -0.40167663, -0.99992526, 0.017341979, 0.40454188, -1.0713243,
    1.0366626, -0.6684805, -0.07793187, 1.2080221, 2.0031455, -0.07060029,
    0.33603913, 2.354045, -0.2431693,
)


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


def program_plain(route, inputs, programs):
    """Kernel 2's (``route="general"``) or 3's plain twin on ``inputs``,
    ``PLAIN_ROWS`` queries at a time where the ``cap x Q`` intermediates
    of one call would exceed 2^28 values."""
    points = inputs[0]
    plain = (gp_kernel.gp_predict_general_plain if route == "general"
             else gp_kernel.gp_predict_stacked_plain)
    arg = programs[0] if route == "general" else programs
    step = (PLAIN_ROWS if points.shape[0] * inputs[1].shape[0] > 2 ** 28
            else points.shape[0])
    outs = [plain(points[start:start + step], *inputs[1:], arg)
            for start in range(0, points.shape[0], step)]
    return tuple(torch.cat(parts) for parts in zip(*outs))


def compare_program(route, inputs, programs, count=None):
    """Kernel 2 (``route="general"``) or 3 (``"stacked"``; ``"streamed"``:
    kernel 3 on its streamed body) against its plain version on one input
    set, the kernel's loops bounded by ``count`` (``None``: the capacity);
    returns the errors and the worst error-to-bound ratio."""
    points, x, params, chol_inv, alpha, mask, s2 = inputs
    if route == "general":
        (program,) = programs
        mean_k, var_k = gp_kernel.gp_predict_general_cuda(*inputs, program,
                                                          count=count)
        mean_p, var_p = program_plain(route, inputs, programs)
        li, al = chol_inv[None], alpha[None]
    else:
        cuda = (gp_kernel.gp_predict_stacked_streamed_cuda
                if route == "streamed" else gp_kernel.gp_predict_stacked_cuda)
        mean_k, var_k = cuda(*inputs, programs, count=count)
        mean_p, var_p = program_plain("stacked", inputs, programs)
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


def program_case(route, names, cap, p, scale, dtype, seed, n=None, d=3):
    """Inputs of one kernel-2/3 case: a GP (general) or a stacked GP over
    ``n`` (default ``cap - cap // 4``) random points in ``d`` dimensions
    (above 3 only for programs that read their columns through
    ``ActiveDims``, as ``product``)."""
    rng = np.random.default_rng(seed)
    n = cap - cap // 4 if n is None else n
    x = rng.uniform(-1.0, 1.0, (n, d))
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
    """``n_q`` queries in the dimensions of the training inputs ``like``."""
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.uniform(-1.2, 1.2, (n_q, like.shape[1])),
                           dtype=like.dtype, device=like.device)


def program_library_sets():
    """Every program tuple this script launches: the cases', the
    flagship's (which has the structure of the ``flagship`` case), the
    1-D ROA example's, the 1-D example's (2-D inputs) and the dryrun's."""
    from safe_learning_tpu_torch.examples import \
        one_d_region_of_attraction_estimate as one_d
    from safe_learning_tpu_torch.examples import one_d_example

    progs = case_programs()
    sets = [(name,) for name in progs] + list(STACKED_SETS.values())
    tuples = []
    for names in sets:
        programs, _ = compiled([progs[n] for n in names],
                               torch.zeros(1, dtype=torch.float64))
        if programs not in tuples:
            tuples.append(programs)
    one_d_program, _ = gp_kernel.compile_kernel_program(one_d.kernel(),
                                                        input_dim=2)
    tuples.append((one_d_program,))
    example_program, _ = gp_kernel.compile_kernel_program(
        one_d_example.kernel(), input_dim=2)
    tuples.append((example_program,))
    from safe_learning_tpu_torch.parallel import dryrun

    # The dryrun's stacked GP (and benchmarks/mesh_scaling.py's, the same
    # two RBF programs), launched by phase_sharded's child processes.
    tuples += [p for p in dryrun.program_tuples() if p not in tuples]
    return tuples


#: Milliseconds one ``cuda_ms`` or ``graph_ms`` reading may spend on its
#: runs: a call slow enough to exceed it at the asked repetitions (the
#: strip body's and the streamed body's at 1,021 to 2,048 rows) is timed
#: in fewer calls a run, then fewer runs (at least 3).
TIMING_BUDGET_MS = 1000.0


def _within_budget(ms, reps, batch):
    """``(reps, batch)`` cut so that ``reps * batch`` calls of ``ms`` each
    fit ``TIMING_BUDGET_MS``."""
    while reps * batch * ms > TIMING_BUDGET_MS and batch > 1:
        batch = max(1, batch // 2)
    while reps * batch * ms > TIMING_BUDGET_MS and reps > 3:
        reps -= 1
    return reps, batch


def cuda_ms(fn, reps=10, warmup=2, batch=1):
    """Median milliseconds of ``fn()`` over ``reps`` runs (CUDA events).

    Each run times ``batch`` calls back to back and divides by ``batch``.
    With ``batch=1`` a run includes the host's work before the first
    launch, as a caller of one sweep sees it; a kernel is timed with
    ``batch=10``, so the device stays busy and the time is the kernel's.
    A call too slow for ``TIMING_BUDGET_MS`` is timed in fewer
    (``_within_budget``), from the last warm-up call's time.
    """
    for _ in range(warmup - 1):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    reps, batch = _within_budget(start.elapsed_time(end), reps, batch)
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


def rounding_bounds(inputs, kind, product_units=None):
    """Elementwise bounds on ``|kernel - plain|`` for both outputs.

    Standard forward-error bounds for the two dot-product stages, each
    counted twice (kernel and plain version both round), in float64:
    ``k`` carries a relative error below ``(16 + 2 r^2) u`` (differences,
    sum of squares, exp; ``r^2`` because exp amplifies the error of its
    argument); ``a = L^-1 k`` adds ``cap u |L^-1| |k|``; the mean and the
    variance add ``cap u`` of their absolute sums. ``product_units``
    replaces the kernel's ``cap`` units of ``a`` (the plain side keeps
    ``cap``): ``folded_bounds`` with ``tf32x3``.
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
    units = cap if product_units is None else (cap + product_units) / 2
    w = li.abs() @ ((units + 16 + 2 * r2) * k.abs())
    del r2
    a = (li @ k).abs()
    del k
    tol_mean = 2 * u * (w.T @ alpha.abs() + cap * (a.T @ alpha.abs()))
    tol_var = 2 * u * (2 * (a * w).sum(0) + cap * (a * a).sum(0))
    return tol_mean, tol_var


def folded_bounds(inputs, kind, tf32x3=False):
    """``rounding_bounds`` of the folded variant: its inputs ``(q, x,
    chol_inv_scaled, alpha)`` and a bare ``k`` (unit scale and mask).

    ``tf32x3``: the bound of kernel 6's float32 tiled body, which takes
    the product ``L^-1 K`` on the tensor cores in three TF32 passes, as
    ``expanded_bounds``'s ``tf32x3`` term does for kernel 7: each product
    carries the split's residual (``TF32X3_SPLIT_U`` units of
    ``|l_ij k_j|``) and each sum inside the tensor cores ``2u`` an addition
    over the ``3 (cap + 7)`` terms of a row (its k steps of 8), so the
    kernel's product takes ``TF32X3_SPLIT_U + 6 (cap + 7)`` units in place
    of ``cap``. No cross-term part applies: its ``r^2`` is kernel 1's,
    formed by per-dimension differences on the CUDA cores in IEEE
    float32."""
    q, x, li, alpha = inputs
    ones = torch.ones(x.shape[0], dtype=q.dtype, device=q.device)
    units = None
    if tf32x3:
        units = TF32X3_SPLIT_U + 6 * (x.shape[0] + 7)
    return rounding_bounds((q, x, li, alpha, ones, ones[0]), kind, units)


#: Per stationary kind: ``r*``, where ``|f'(r)|`` of the covariance as a
#: function of ``r = sqrt(r^2)`` peaks, and ``|f'(r)|`` itself (with
#: ``s = sqrt(3) r`` or ``sqrt(5) r`` for the Matern kinds). Every one is
#: at most 1, and falls monotonically past ``r*``.
COV_SLOPE = {
    "rbf": (1.0, lambda r: r * torch.exp(-0.5 * r * r)),
    "matern12": (0.0, lambda r: torch.exp(-r)),
    "matern32": (3 ** -0.5, lambda r: 3 * r * torch.exp(-(3 ** 0.5) * r)),
    "matern52": ((1 + 5 ** 0.5) / 2 / 5 ** 0.5,
                 lambda r: 5 ** 0.5 / 3 * (5 ** 0.5 * r)
                 * (1 + 5 ** 0.5 * r) * torch.exp(-(5 ** 0.5) * r)),
}


#: The three-pass TF32 split's residual on one product, in units of
#: float32's ``u = 2^-24``: each operand's small TF32 half leaves ``2^-22``
#: of it (``2^-11`` of the ``2^-11`` its big half leaves) and the dropped
#: ``small x small`` term is another ``2^-22``: ``3 x 2^-22 = 12 u``, and
#: one to spare.
TF32X3_SPLIT_U = 13


def expanded_bounds(inputs, kind, tf32x3=False):
    """Elementwise bounds on ``|kernel - plain|`` of the expanded-distance
    variant, both computing ``r^2 = max(xx - 2 x.q + qq, 0)``.

    Each side's ``r^2`` lies within ``(d + 3) u S`` of the exact squared
    distance, ``S = xx + 2 |x|.|q| + qq``: ``d`` roundings in each of the
    three sums, two in the combination (Higham's forward bound for a dot
    product, ``gamma_d``, plus one unit each), one to spare. So the two
    sides differ by at most ``eps = 2 (d + 3) u S``; the clamp at 0 is a
    projection and never adds to it. Through the covariance
    ``f(sqrt(r^2))``: ``|dr| <= min(sqrt(eps), eps / (2 r_lo))`` with
    ``r_lo = sqrt(max(r^2 - eps, 0))``, and ``|dk| <= |f'|max dr`` with
    ``|f'|max`` the slope's largest value past ``r_lo`` (``COV_SLOPE``),
    times the scale and the mask. Unlike the per-dimension differences,
    this error is absolute: it does not shrink with ``k``. The rest is
    ``rounding_bounds`` without its ``2 r^2`` term (that term is the
    relative error of the differences' ``r^2``): ``16 u`` relative for
    the covariance, the scale and the mask, ``cap u`` for each dot
    product stage, counted twice.

    ``tf32x3``: the bound of kernel 7's float32 tiled body, which takes
    the cross term ``x.q`` and the product ``L^-1 K`` on the tensor cores
    in three TF32 passes. Each product there carries the split's residual
    (``TF32X3_SPLIT_U`` units of ``|x_c q_c|`` or ``|l_ij k_j|``), and
    each sum inside the tensor cores is taken at ``2u`` an addition
    (truncation: NVIDIA does not document the accumulation as
    round-to-nearest, and published measurements of earlier tensor cores
    found truncation) over ``3 depth`` terms for the cross term (``depth``,
    the dimensions padded to one or two k steps of 8) and ``3 (cap + 7)``
    for a row of the product (its k steps of 8). So the kernel's ``r^2``
    adds ``(TF32X3_SPLIT_U + 6 depth) u 2 |x|.|q|`` to ``eps``, and its
    product ``(TF32X3_SPLIT_U + 6 (cap + 7)) u`` in place of ``cap u``; the
    plain side is as above.
    """
    q, x, li, alpha, mask, var_s2 = (t.double() for t in inputs)
    u = torch.finfo(inputs[0].dtype).eps / 2
    cap, d = x.shape
    r2 = None
    for i in range(d):
        diff = x[:, i][:, None] - q[:, i][None, :]
        r2 = diff * diff if r2 is None else r2 + diff * diff
    cross = x.abs() @ q.abs().T
    eps = 2 * (d + 3) * u * ((x * x).sum(1)[:, None] + 2 * cross
                             + (q * q).sum(1)[None, :])
    if tf32x3:
        depth = 8 if d <= 8 else 16
        eps += 2 * (TF32X3_SPLIT_U + 6 * depth) * u * cross
    del cross
    r_lo = (r2 - eps).clamp(min=0).sqrt()
    tiny = torch.finfo(torch.float64).tiny
    dr = torch.minimum(eps.sqrt(), eps / (2 * r_lo).clamp(min=tiny))
    r_star, slope = COV_SLOPE[kind]
    dk = slope(r_lo.clamp(min=r_star)) * dr * var_s2 * mask[:, None]
    del eps, r_lo, dr
    k = st.functions.gp.STATIONARY_COVARIANCES[kind](r2) * var_s2 \
        * mask[:, None]
    del r2
    # The product's and k's units of both sides, over two (as counted
    # twice below).
    units = cap + 16
    if tf32x3:
        units = (units + TF32X3_SPLIT_U + 6 * (cap + 7) + 16) / 2
    w = li.abs() @ (units * k.abs() + dk / (2 * u))
    del dk
    a = (li @ k).abs()
    del k
    tol_mean = 2 * u * (w.T @ alpha.abs() + cap * (a.T @ alpha.abs()))
    tol_var = 2 * u * (2 * (a * w).sum(0) + cap * (a * a).sum(0))
    return tol_mean, tol_var


def compare_outputs(outs, plain, bounds, inputs, chunk=2 ** 20):
    """Kernel outputs against the plain version on one input set: for
    each ``(mean, var)`` of ``outs`` (all computed from ``inputs``) the
    largest errors and err/bound. ``plain(part)`` and ``bounds(part)`` take
    the inputs with ``chunk`` queries at a time, which bounds their
    float64 intermediates; a zero bound (all k underflowed) admits only a
    zero error. Returns ``[(max|dmean|, max|dvar|, err/bound)]``."""
    torch.cuda.synchronize()
    for mean_k, var_k in outs:
        if not (torch.isfinite(mean_k).all() and torch.isfinite(var_k).all()):
            raise AssertionError("kernel output is not finite")
    tiny = torch.finfo(torch.float64).tiny
    worst = [[0.0, 0.0, 0.0] for _ in outs]
    for start in range(0, inputs[0].shape[0], chunk):
        part = (inputs[0][start:start + chunk],) + tuple(inputs[1:])
        mean_p, var_p = plain(part)
        tol_mean, tol_var = bounds(part)
        for w, (mean_k, var_k) in zip(worst, outs):
            err_mean = (mean_k[start:start + chunk].double()
                        - mean_p.double()).abs()
            err_var = (var_k[start:start + chunk].double()
                       - var_p.double()).abs()
            w[0] = max(w[0], float(err_mean.max()))
            w[1] = max(w[1], float(err_var.max()))
            w[2] = max(w[2],
                       float((err_mean / tol_mean.clamp(min=tiny)).max()),
                       float((err_var / tol_var.clamp(min=tiny)).max()))
    return [tuple(w) for w in worst]


def compare(inputs, kind, count=None, chunk=2 ** 20):
    """Kernel 1 against plain on one input set, the kernel's loops bounded
    by ``count`` (``None``: the capacity); returns the errors. The kernel
    runs once on all the queries; the plain version and the bounds are
    taken ``chunk`` queries at a time (``compare_outputs``)."""
    out = gp_kernel.gp_predict_cuda(*inputs, kind=kind, count=count)
    (errors,) = compare_outputs(
        [out], lambda part: gp_kernel.gp_predict_plain(*part, kind=kind),
        lambda part: rounding_bounds(part, kind), inputs, chunk)
    return errors


def case_inputs(gp, n_q, seed):
    """Random queries against ``gp``, as the kernel's arguments."""
    rng = np.random.default_rng(seed)
    q = torch.as_tensor(rng.uniform(-1.2, 1.2, (n_q, gp.input_dim)),
                        dtype=gp.X_buf.dtype, device=gp.X_buf.device)
    ls = gp.kernel.lengthscales
    return ((q / ls).contiguous(), (gp.X_buf / ls).contiguous(),
            gp.chol_inv, gp.alpha, gp._mask(),
            gp.kernel.variance * gp.scale ** 2)


def case_gp(kind, cap, p, scale, dtype, seed, n=None, d=3):
    """A GP at capacity ``cap`` over ``n`` random points (default: a
    quarter of the rows padding) in ``d`` dimensions."""
    rng = np.random.default_rng(seed)
    n = cap - cap // 4 if n is None else n
    x = rng.uniform(-1.0, 1.0, (n, d))
    ls = [0.7, 1.4, 0.9] if d == 3 else np.linspace(0.7, 1.4, d)
    y = np.column_stack([np.sin((j + 1) * x.sum(axis=1) + 0.3 * j)
                         for j in range(p)])
    old = st.config.dtype
    st.config.dtype = dtype
    try:
        return st.GaussianProcess(
            KERNEL_CLASSES[kind](1.3, ls, input_dim=d), x, y,
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
        # Each entry function (mangled), its registers and spills.
        print("\n".join(line for line in report.splitlines()
                        if "Compiling entry function" in line
                        or "Used" in line or "spill" in line))
    print("build: {} libraries in {:.3f} s wall".format(len(names), wall))
    for programs in tuples:
        print("program library: {!r}".format(programs))
    for programs in (tuples[0], next(t for t in tuples if len(t) == 2)):
        lib = gp_kernel.program_library(programs)
        print("dynamic shared memory per block and body, S={}, p=1, d=3: "
              .format(len(programs)) + ", ".join(
                  "{} B at count {} ({}, {})".format(
                      lib.gp_program_smem_bytes(count, size, 1, 3), count,
                      name, gp_kernel.PROGRAM_BODIES[
                          lib.gp_program_body(count, size, 1, 3)])
                  for count in (10, 32, 64, 128, 129, 181, 256, 257, 512,
                                513)
                  for size, name in ((4, "f32"), (8, "f64"))))
    print("panel body: counts 129 to {} in float32, to {} in float64; the "
          "strip body above".format(
              *(gp_kernel.program_panel_max(tuples[0], dtype)
                for dtype in (torch.float32, torch.float64))))
    sass_check(tuples)


#: A kernel function of kernels 1-3 in ``cuobjdump``'s listing: the body
#: and the template's value type (``d`` float64, ``f`` float32) as mangled.
SASS_KERNEL = re.compile(
    r"gp_(?:predict|program)_(tiled|panel|strip|streamed)(?:_dmma)?I([df])")

#: A kernel function of kernel 1's variants (``gp_predict_variants.cu``):
#: its body (the float32 tiled bodies ``tiled_pipelined_ws`` of kernel 4,
#: ``tiled_interleaved_chains`` of kernel 5, ``tiled_folded_tf32`` of kernel
#: 6 and ``tiled_expanded_tf32`` of kernel 7) and its value type, the first
#: template argument or, for those four, that of its ``Args``.
SASS_VARIANT = re.compile(
    r"(tiled_expanded_tf32|tiled_folded_tf32|tiled_pipelined_ws|"
    r"tiled_interleaved_chains|tiled_pipelined|tiled_interleaved|"
    r"tiled_serial|streamed)I(?:([df])|.*ArgsI([df])E)")

#: The variants' bodies whose product runs on the TF32 tensor cores
#: (``wgmma``): kernels 6 and 7's float32 tiled bodies. No other kernel
#: may hold a TF32 tensor-core instruction.
SASS_TF32_BODIES = ("tiled_folded_tf32", "tiled_expanded_tf32")

#: The redesigned float32 tiled bodies of kernels 4-7, each of which must
#: be found in the variants' SASS.
SASS_REDESIGNED = ("tiled_pipelined_ws", "tiled_interleaved_chains",
                   "tiled_folded_tf32", "tiled_expanded_tf32")

#: A tensor-core instruction on TF32 operands (``HGMMA`` of ``wgmma``,
#: ``HMMA`` of ``mma.sync``).
SASS_TF32 = re.compile(r"\bH(?:G)?MMA\.\S*TF32")


def sass_check(tuples):
    """``cuobjdump --dump-sass`` of kernels 1-3's libraries (the stationary
    one and each program tuple's) and of the variants' library. Kernels
    1-3: every float64 tiled, panel and strip kernel contains ``DMMA``
    (the product on the FP64 tensor cores), no float32 kernel does, the
    float64 streamed kernels (the CUDA-core body of the comparison
    entries) do not, and no float32 kernel contains a TF32 tensor-core
    instruction
    (``SASS_TF32``): TF32 is not allowed on the kernels' path. The
    variants: kernels 6 and 7's float32 tiled kernels
    (``SASS_TF32_BODIES``) contain TF32 ``HGMMA`` (``wgmma``), and no other
    variant kernel holds a TF32 tensor-core instruction (kernels 4 and 5's
    float32 bodies, ``tiled_pipelined_ws`` and
    ``tiled_interleaved_chains``, and the streamed bodies are FP32 on the
    CUDA cores); each of the four redesigned float32 bodies
    (``SASS_REDESIGNED``) is found. TF32 is allowed only in kernels 6 and
    7's float32 tiled bodies. A missing ``cuobjdump`` fails."""
    from safe_learning_tpu_torch.ops.build import _nvcc

    tool = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(_nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        raise AssertionError("cuobjdump not found beside nvcc ({})".format(
            tool))
    libs = [gp_kernel.kernel_library()] + [gp_kernel.program_library(
        tuple(p)) for p in tuples]
    variants = gp_kernel.variants_library()
    # One cuobjdump a library, all at once.
    procs = [subprocess.Popen([tool, "--dump-sass", lib._name],
                              stdout=subprocess.PIPE, text=True)
             for lib in libs + [variants]]
    found = collections.Counter()
    tf32_forms = set()
    for lib, proc in zip(libs + [variants], procs):
        sass = proc.communicate()[0]
        if proc.returncode != 0:
            raise AssertionError("cuobjdump failed on {}".format(lib._name))
        for part in sass.split("Function : ")[1:]:
            name = part.split("\n", 1)[0].strip()
            tf32 = SASS_TF32.findall(part)
            tf32_forms.update(form.split(" ")[0] for form in tf32)
            if lib is variants:
                m = SASS_VARIANT.search(name)
                if m is None:
                    continue
                body, t = m.group(1), m.group(2) or m.group(3)
                want = body in SASS_TF32_BODIES
                found["variant " + body, t, "TF32" if tf32 else "no TF32"] \
                    += 1
                if bool(tf32) != want or (want and not any(
                        form.startswith("HGMMA") for form in tf32)):
                    raise AssertionError("{} has {} TF32 tensor-core "
                                         "instructions ({})".format(
                                             name, len(tf32),
                                             sorted(set(tf32))))
                continue
            m = SASS_KERNEL.search(name)
            if m is None:
                continue
            body, t = m.groups()
            dmma = part.count("DMMA")
            want = t == "d" and body != "streamed"
            found[body, t, "DMMA" if dmma else "no DMMA"] += 1
            if (dmma > 0) != want:
                raise AssertionError("{} has {} DMMA instructions ({})"
                                     .format(name, dmma, os.path.basename(
                                         lib._name)))
            if tf32:
                raise AssertionError("{} of kernels 1-3 has {} TF32 tensor-"
                                     "core instructions".format(name,
                                                                len(tf32)))
    print("SASS of kernels 1-3 and the variants ({} libraries, cuobjdump "
          "--dump-sass): {}; TF32 tensor-core instructions only in "
          "kernels 6 and 7's float32 tiled bodies ({})".format(
              len(libs) + 1, ", ".join(
                  "{} {} {}: {}".format(body, {"d": "f64", "f": "f32"}[t],
                                        has, n)
                  for (body, t, has), n in sorted(found.items())),
              ", ".join(sorted(tf32_forms))))
    for body in ("tiled", "panel", "strip"):
        if not found[body, "d", "DMMA"]:
            raise AssertionError("no float64 {} kernel found in the SASS"
                                 .format(body))
    for body in SASS_REDESIGNED:
        if not sum(n for (b, t, _), n in found.items()
                   if b == "variant " + body and t == "f"):
            raise AssertionError("no float32 {} kernel found in the SASS"
                                 .format(body))


#: ``(count, capacity)`` of the count cases: a GP holding ``count`` points
#: at that capacity, the kernels' loops bounded by the count. Count 0 (an
#: all-zero mask), small counts, both sides of every bucket edge of the
#: tiled body (16, 32, 64, 128), the panel body above it and the strip
#: body at 2048, and count below and equal to capacity.
COUNT_CASES = ((0, 64), (1, 128), (10, 64), (15, 16), (16, 128), (17, 32),
               (31, 32), (32, 32), (33, 64), (64, 64), (65, 128),
               (127, 128), (128, 128), (129, 256), (2048, 2048))


def count_queries(count):
    """Ragged query counts of the count cases (fewer above 128 rows)."""
    return 65537 if count > 128 else (1001, 100003)[count % 2]


def panel_count_cases(n_panel):
    """``(count, cap, route, names, p, d)`` of the panel body's count cases
    in a dtype whose panel body ends at ``n_panel``: counts just above the
    tiled body, the adaptive example's 181 (at its capacity), both sides
    of 256 and of ``n_panel`` (the streamed body above it), and count 0 at
    a panel-sized capacity. Each count runs the general kernel (the
    ``product`` program, whose ``ActiveDims`` read 3 of up to 16 input
    columns, p up to 8) and the stacked kernel (S = 1, 2 and 3 in turns)."""
    counts = sorted({129, 136, 181, 192, 255, 256, 257, n_panel,
                     n_panel + 1})
    shapes = ((1, 3), (8, 16), (2, 5), (4, 16), (3, 3))
    cases = []
    for i, count in enumerate([0] + counts):
        cap = (ADAPTIVE_CAPACITY if count in (129, 181)
               else next(c for c in (256, 512, 1024) if c >= count))
        p, d = shapes[i % len(shapes)]
        cases.append((count, cap, "general", ("product",), p, d))
        cases.append((count, cap, "stacked", STACKED_SETS[1 + i % 3], 1, 3))
    return cases


def panel_max(dtype):
    """The largest count of the panel body in ``dtype`` (one number for
    every program library), from the stacked flagship pair's library."""
    programs, _ = compiled([case_programs()[name]
                            for name in STACKED_SETS[2]],
                           torch.zeros(1, dtype=torch.float64))
    return gp_kernel.program_panel_max(programs, dtype)


def expected_body(count, n_panel):
    """The body kernels 1-3 take at ``count`` rows (blocks that fit)."""
    return ("tiled" if count <= 128 else "panel" if count <= n_panel
            else "strip")


#: The float64 DMMA bodies' edges (``csrc/gp_predict_common.cuh``): every
#: k step (mma depth 4 to 16), 16-row tile and bucket edge of the tiled
#: body (1 to 128), the panel body's row tiles (129 to 256) and the strip
#: body's strips, warps' row tiles and chunks (257 to 1,024).
DMMA_COUNTS = (1, 4, 5, 8, 9, 10, 16, 17, 24, 32, 64, 127, 128, 129, 136,
               181, 255, 256, 257, 271, 272, 511, 512, 513, 1021)


def dmma_count_cases():
    """``(count, cap, p, d, n_out)`` of the float64 count cases at
    ``DMMA_COUNTS``: p cycles through 1 to 8, the stacked outputs S
    through 1 to 3, d is 3 or 5, and the capacity is the count's or the
    next of 16, 64, 181, 256, 512 and 1024 above it."""
    cases = []
    for i, count in enumerate(DMMA_COUNTS):
        larger = [c for c in (16, 64, 181, 256, 512, 1024) if c > count]
        cap = count if i % 3 == 0 or not larger else larger[0]
        cases.append((count, cap, 1 + i % 8, (3, 5)[i % 2], 1 + i % 3))
    return cases


#: The query tile of the float64 DMMA bodies by the largest count they
#: take at p <= 2, d = 3 (``TileD``, ``PanelD``, ``Strip`` of
#: ``csrc/gp_predict_common.cuh``): the tiled buckets, chol_inv resident to
#: 192 rows, the streaming panel body to 256, the strip body above. A
#: query's shift within a launch runs 1 to the tile - 1.
DMMA_QUERY_TILE = ((16, 256), (32, 256), (64, 128), (128, 32), (192, 16),
                   (256, 64), (2048, 64))


def dmma_query_tile(count):
    """The query tile a float64 launch at ``count`` rows runs on."""
    return next(tile for top, tile in DMMA_QUERY_TILE if count <= top)


def position_shifts(tile):
    """Shifts of ``position_check`` in this script: every one up to 32 (a
    query's lane, its 8-query mma tile and its fill thread), then each
    multiple of 32 (its mma warp) and ``tile - 1``. The ``cuda`` tests
    take every shift from 1 to ``tile - 1``."""
    return sorted(set(range(1, min(tile, 33))) | set(range(32, tile, 32))
                  | {tile - 1})


def position_check(fn, queries, tile, shifts=None):
    """Bit equality of each query's float64 outputs wherever it lies in a
    launch: ``fn(q)`` returns the outputs, rows by query; the queries as
    one batch against the same queries after ``shifts`` others (by
    default 1 to ``tile - 1``), reversed, and as batches of one (every
    97th query). Returns the launches made."""
    def key(outs):
        return [o.contiguous().view(torch.int64) for o in outs]

    ref = key(fn(queries))
    launches = 1
    fill = queries.flip(0) * 0.5 + 0.25
    for shift in range(1, tile) if shifts is None else shifts:
        out = key(fn(torch.cat([fill[:shift], queries]).contiguous()))
        launches += 1
        if not all(torch.equal(o[shift:], r) for o, r in zip(out, ref)):
            raise AssertionError("a query's outputs change with its shift "
                                 "{} in the launch".format(shift))
    out = key(fn(queries.flip(0).contiguous()))
    launches += 1
    if not all(torch.equal(o.flip(0), r) for o, r in zip(out, ref)):
        raise AssertionError("a query's outputs change with the launch's "
                             "order")
    for i in range(0, queries.shape[0], 97):
        out = key(fn(queries[i:i + 1].contiguous()))
        launches += 1
        if not all(torch.equal(o, r[i:i + 1]) for o, r in zip(out, ref)):
            raise AssertionError("query {}'s outputs change in a batch of "
                                 "one".format(i))
    return launches


def underflow_bounds(inputs, kind):
    """``rounding_bounds`` with gradual underflow, for far queries whose k
    is subnormal (r^2 past about 1,416 in float64): a product or FMA may
    err by half the smallest subnormal ``s`` beyond its relative rounding,
    and exp below the normal range by one subnormal ulp, so k carries
    ``2 s`` more, ``a = L^-1 k`` ``|L^-1| 2 s`` plus ``cap s``, the mean
    and the variance ``cap s`` more, counted twice (kernel and plain)."""
    tol_mean, tol_var = rounding_bounds(inputs, kind)
    q, x, li, alpha, mask, var_s2 = (t.double() for t in inputs)
    dtype = torch.finfo(inputs[0].dtype)
    sub = dtype.tiny * dtype.eps
    cap = x.shape[0]
    r2 = None
    for i in range(q.shape[1]):
        diff = x[:, i][:, None] - q[:, i][None, :]
        r2 = diff * diff if r2 is None else r2 + diff * diff
    k = st.functions.gp.STATIONARY_COVARIANCES[kind](r2) * var_s2 \
        * mask[:, None]
    a = (li @ k).abs()
    da = (li.abs().sum(1) * 2 * sub + cap * sub)[:, None]
    tol_mean = tol_mean + 2 * (da.T @ alpha.abs() + cap * sub)
    tol_var = tol_var + 2 * (2 * (a * da).sum(0) + cap * sub)
    return tol_mean, tol_var


def phase_dmma_cases():
    """The float64 DMMA bodies at their edges (``dmma_count_cases``):
    kernel 1, kernel 2 (``product`` program, p and d as the case gives)
    and kernel 3 (S outputs) at every count, each against its plain
    version within its bound, the query count not a multiple of the query
    tile; far queries with subnormal k through kernel 1 within
    ``underflow_bounds``; then ``position_check`` on kernel 1 (counts 10,
    128, 200 on the panel body and 600 on the strip body), kernel 2 (136,
    600) and kernel 3 (17, 181 with chol_inv resident, 250 streaming
    chol_inv, 300 and 1,021 on the strip body)."""
    worst, case = 0.0, 0
    for count, cap, p, d, n_out in dmma_count_cases():
        n_q = 4099 if count % 2 else 20011
        kind = gp_kernel.KINDS[case % len(gp_kernel.KINDS)]
        gp = case_gp(kind, cap, p, 2.5, torch.float64, seed=900 + case,
                     n=count, d=d)
        runs = [("kernel 1 " + kind, compare(
            case_inputs(gp, n_q, 900 + case), kind, count=count))]
        for route, names, pp, dd in (("general", ("product",), p, d),
                                     ("stacked", STACKED_SETS[n_out], 1, 3)):
            inputs, programs = program_case(route, names, cap, pp, 2.5,
                                            torch.float64, seed=900 + case,
                                            n=count, d=dd)
            points = case_queries(n_q, inputs[0], 900 + case)
            runs.append(("{} S={}".format(route, len(programs)),
                         compare_program(route, (points,) + inputs, programs,
                                         count=count)))
        for label, (em, ev, ratio) in runs:
            case += 1
            print("float64 DMMA case {:2d} {} count={:3d} cap={:3d} p={} d={} "
                  "Q={}: max|dmean|={:.3e} max|dvar|={:.3e} err/bound={:.3f}"
                  .format(case, label, count, cap, p, d, n_q, em, ev, ratio))
            if not ratio <= 1.0:
                raise AssertionError("float64 {} at count {} disagrees with "
                                     "plain".format(label, count))
            worst = max(worst, ratio)
    # Far queries: k below the normal range, then zero.
    gp = case_gp("rbf", 128, 2, 2.5, torch.float64, seed=950, n=100)
    inputs = case_inputs(gp, 3001, 950)
    far = torch.linspace(37.0, 40.0, 3001, dtype=torch.float64,
                         device=inputs[0].device)[:, None] / 3 ** 0.5
    far = (far + inputs[0] * 0.01).contiguous()
    out = gp_kernel.gp_predict_cuda(far, *inputs[1:], kind="rbf",
                                    count=gp.count)
    (errors,) = compare_outputs(
        [out], lambda part: gp_kernel.gp_predict_plain(*part, kind="rbf"),
        lambda part: underflow_bounds(part, "rbf"), (far,) + inputs[1:])
    print("float64 DMMA far queries (r^2 about 1,370 to 1,600, k subnormal "
          "or 0): {} of 3001 means nonzero, smallest |mean| {!r}; max|dmean|"
          "={:.3e} max|dvar|={:.3e} err/bound={:.3f} (underflow_bounds)"
          .format(int((out[0] != 0).any(1).sum()),
                  float(out[0].abs()[out[0] != 0].min()), *errors))
    if not errors[2] <= 1.0:
        raise AssertionError("float64 kernel 1 disagrees at far queries")
    launches = 0
    for count in (10, 128, 200, 600):
        gp = case_gp("matern32", max(128, count), 2, 2.5, torch.float64,
                     seed=960 + count, n=count)
        inputs = case_inputs(gp, 1000, 960)
        launches += position_check(
            lambda q: gp_kernel.gp_predict_cuda(
                q, *inputs[1:], kind="matern32", count=count),
            inputs[0], dmma_query_tile(count),
            position_shifts(dmma_query_tile(count)))
    for route, names, count, cap in (
            ("general", ("product",), 136, 181),
            ("stacked", STACKED_SETS[1], 17, 32),
            ("stacked", STACKED_SETS[2], 181, 181),
            ("stacked", STACKED_SETS[2], 250, 256),
            ("general", ("product",), 600, 600),
            ("stacked", STACKED_SETS[2], 300, 300),
            ("stacked", STACKED_SETS[2], 1021, 1024)):
        inputs, programs = program_case(route, names, cap, 2, 2.5,
                                        torch.float64, seed=970, n=count)
        cuda = (gp_kernel.gp_predict_general_cuda if route == "general"
                else gp_kernel.gp_predict_stacked_cuda)
        arg = programs[0] if route == "general" else programs
        launches += position_check(
            lambda q: cuda(q, *inputs, arg, count=count),
            case_queries(1000, inputs[0], 970), dmma_query_tile(count),
            position_shifts(dmma_query_tile(count)))
    print("float64 DMMA bodies: {} count cases, worst err/bound {:.3f}; far "
          "queries; every query's outputs bit for bit the same at each "
          "position_shifts in its query tile, reversed and alone ({} "
          "launches)".format(
              case, worst, launches))


def phase_program_count_cases():
    """Kernels 2 and 3 with the loops bounded by the GP's count, against
    their plain versions (full capacity) within ``program_bounds``: the
    general kernel on the ``product`` program with 2 outputs, the stacked
    kernel on two flagship programs (one ``sum3`` output at capacity
    2048, as the GP routes allow), float32 and float64; then the panel
    body's cases (``panel_count_cases``), each printing the body it took,
    which must be the one its count selects. At count 0 the outputs must
    be exact zeros."""
    worst, case = 0.0, 0
    for dtype in (torch.float32, torch.float64):
        for count, cap in COUNT_CASES:
            stacked = ("sum3",) if cap > 1024 else STACKED_SETS[2]
            for route, names, p in (("general", ("product",), 2),
                                    ("stacked", stacked, 1)):
                case += 1
                inputs, programs = program_case(route, names, cap, p, 2.5,
                                                dtype, seed=500 + case,
                                                n=count)
                n_q = count_queries(count)
                points = case_queries(n_q, inputs[0], 500 + case)
                em, ev, ratio = compare_program(route, (points,) + inputs,
                                                programs, count=count)
                print("{} count case {:2d} {} count={:4d} cap={:4d} Q={:6d}: "
                      "max|dmean|={:.3e} max|dvar|={:.3e} err/bound={:.3f}"
                      .format(route, case, str(dtype)[6:], count, cap, n_q,
                              em, ev, ratio))
                if not ratio <= 1.0 or (count == 0 and em + ev != 0.0):
                    raise AssertionError("{} kernel at count {} disagrees "
                                         "with plain".format(route, count))
                worst = max(worst, ratio)
        n_panel = panel_max(dtype)
        for count, cap, route, names, p, d in panel_count_cases(n_panel):
            case += 1
            inputs, programs = program_case(route, names, cap, p, 2.5, dtype,
                                            seed=500 + case, n=count, d=d)
            n_q = (4099, 20011)[case % 2]
            points = case_queries(n_q, inputs[0], 500 + case)
            em, ev, ratio = compare_program(route, (points,) + inputs,
                                            programs, count=count)
            body = gp_kernel.program_body(programs, count, dtype, p, d)
            print("{} count case {:2d} {} count={:4d} cap={:4d} S={} p={} "
                  "d={:2d} Q={:5d} body={}: max|dmean|={:.3e} max|dvar|="
                  "{:.3e} err/bound={:.3f}".format(
                      route, case, str(dtype)[6:], count, cap, len(programs),
                      p, d, n_q, body, em, ev, ratio))
            if body != expected_body(count, n_panel):
                raise AssertionError("count {} took the {} body".format(
                    count, body))
            if not ratio <= 1.0 or (count == 0 and em + ev != 0.0):
                raise AssertionError("{} kernel at count {} disagrees "
                                     "with plain".format(route, count))
            worst = max(worst, ratio)
    print("kernels 2 and 3 at counts below capacity: {} cases, worst "
          "err/bound {:.3f} (bound: program_bounds)".format(case, worst))


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
    # The panel body: capacities 256 and 512, three quarters full.
    for dtype in (torch.float32, torch.float64):
        for ci, cap in enumerate((256, 512)):
            for route, names, p in (("general", ("sum3",), 1 + ci),
                                    ("stacked", STACKED_SETS[2 + ci], 1)):
                case += 1
                inputs, programs = program_case(route, names, cap, p, 2.5,
                                                dtype, seed=case)
                points = case_queries(65537, inputs[0], case)
                em, ev, ratio = compare_program(route, (points,) + inputs,
                                                programs)
                print("{} case {:2d} {} S={} cap={:4d} p={} Q=65537 body={}: "
                      "max|dmean|={:.3e} max|dvar|={:.3e} err/bound={:.3f}"
                      .format(route, case, str(dtype)[6:], len(programs), cap,
                              p, gp_kernel.program_body(
                                  programs, cap - cap // 4, dtype, p),
                              em, ev, ratio))
                if not ratio <= 1.0:
                    raise AssertionError("{} kernel and plain disagree "
                                         "beyond the bound".format(route))
                worst = max(worst, ratio)
    print("kernels 2 and 3 against plain: {} cases, worst err/bound {:.3f} "
          "(bound: program_bounds)".format(case, worst))

    # One gradient per kernel through its autograd rule, and kernel 3's at
    # the adaptive example's capacity and count (the panel body).
    for route, set_names, p, cap, n in (
            ("general", ("flagship",), 2, 32, None),
            ("stacked", STACKED_SETS[3], 1, 32, None),
            ("stacked", STACKED_SETS[2], 1, ADAPTIVE_CAPACITY,
             ADAPTIVE_CAPACITY)):
        inputs, programs = program_case(route, set_names, cap, p, 2.5,
                                        torch.float64, seed=99, n=n)
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
        print("{} gradient wrt queries at capacity {}, autograd rule vs "
              "plain: max abs diff {:.3e} (tolerance 1e-12)".format(
                  route, cap, gerr))
        if not gerr <= 1e-12:
            raise AssertionError("gradient through the {} kernel differs"
                                 .format(route))


#: ``(d, p, capacity, queries)`` of kernel 1's wide cases: the cart-pole
#: sweep's inputs and outputs, and the ``D_MAX`` / ``P_MAX`` edge of
#: ``csrc/gp_predict_common.cuh`` in the tiled and the streamed body.
WIDE_CASES = ((5, 4, 128, 1000003), (16, 8, 128, 65537),
              (16, 8, 2048, 65537))

#: ``(count, capacity, d, p)`` of kernel 1's wide count cases.
WIDE_COUNT_CASES = ((128, 128, 5, 4), (100, 128, 16, 8), (129, 256, 16, 8),
                    (2048, 2048, 16, 8))

#: ``(count, capacity)`` of kernel 1 above the tiled body: the panel
#: body's range (129 to 512 in float32, to 256 in float64) and the strip
#: body's above it, on both sides of each edge.
STATIONARY_WIDE_COUNTS = ((129, 256), (192, 256), (193, 256), (256, 256),
                          (257, 512), (512, 512), (513, 1024),
                          (1021, 1024))


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
        # Past the 4 dimensions k unrolls from registers: the cart-pole's
        # d = 5, p = 4 (tiled), the D_MAX / P_MAX edge d = 16, p = 8
        # (tiled and, at capacity 2048, the strip body).
        for d, p, cap, n_q in WIDE_CASES:
            case += 1
            gp = case_gp("rbf", cap, p, 2.5, dtype, seed=case, d=d)
            em, ev, ratio = compare(case_inputs(gp, n_q, case), "rbf")
            print("case {:2d} {} rbf d={:2d} cap={:4d} p={} Q={:7d}: "
                  "max|dmean|={:.3e} max|dvar|={:.3e} err/bound={:.3f}"
                  .format(case, str(dtype)[6:], d, cap, p, n_q, em, ev,
                          ratio))
            if not ratio <= 1.0:
                raise AssertionError(
                    "kernel and plain disagree beyond the rounding bound at "
                    "d={}, p={} (err/bound {:.3f})".format(d, p, ratio))
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


def phase_kernel_count_cases():
    """Kernel 1 with its loops bounded by the GP's count (``COUNT_CASES``
    and ``STATIONARY_WIDE_COUNTS``, the kinds in turn, float32 and
    float64) against its plain version at full capacity, within
    ``rounding_bounds``, each taking the body its count selects
    (``gp_kernel.stationary_body``; the panel and strip bodies above 128
    rows, as kernels 2 and 3). At count 0 the outputs must be exact
    zeros."""
    worst, case = 0.0, 0
    # d = 6 once per dtype, and the wide count cases: the dimensions past
    # the 4 that k unrolls from registers, and up to 8 outputs.
    cases = ([(count, cap, 3, 2) for count, cap in COUNT_CASES]
             + [(count, cap, 3, 1 + i % 3) for i, (count, cap)
                in enumerate(STATIONARY_WIDE_COUNTS)]
             + [(40, 64, 6, 2)] + list(WIDE_COUNT_CASES))
    for dtype in (torch.float32, torch.float64):
        n_panel = panel_max(dtype)
        for ci, (count, cap, d, p) in enumerate(cases):
            kind = gp_kernel.KINDS[ci % len(gp_kernel.KINDS)]
            case += 1
            gp = case_gp(kind, cap, p, 2.5, dtype, seed=300 + case, n=count,
                         d=d)
            n_q = count_queries(count)
            em, ev, ratio = compare(case_inputs(gp, n_q, 300 + case), kind,
                                    count=gp.count)
            body = gp_kernel.stationary_body(count, dtype, p, d)
            print("count case {:2d} {} {:8s} d={:2d} p={} count={:4d} "
                  "cap={:4d} Q={:6d} body={}: max|dmean|={:.3e} max|dvar|="
                  "{:.3e} err/bound={:.3f}".format(
                      case, str(dtype)[6:], kind, d, p, count, cap, n_q,
                      body, em, ev, ratio))
            if body != expected_body(count, n_panel):
                raise AssertionError("kernel 1 at count {} took the {} "
                                     "body".format(count, body))
            if not ratio <= 1.0 or (count == 0 and em + ev != 0.0):
                raise AssertionError("kernel 1 at count {} disagrees with "
                                     "plain".format(count))
            worst = max(worst, ratio)
    print("kernel 1 at counts below capacity: {} cases, worst err/bound "
          "{:.3f} (bound: rounding_bounds)".format(case, worst))


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
    return lyap, launches


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


def oracle_gate(lyap, label, initial=None, explain=None, margins64=None):
    """A certified sweep against the port's float64 oracle.

    ``lyap`` has just run ``update_safe_set``. ``bench.py``'s first gate
    on its level; then the decrease verdict of every grid point on the card
    against the sign of its float64 margin, wherever that margin lies
    outside the band of ``oracle.calibrate_certificate_margin``. Outside
    the band, a point the card passes and the oracle fails always fails
    the run; a point the card fails and the oracle passes (the conservative
    direction) fails it unless ``explain`` (grid indices to a cause, or
    ``None``, for each) names a cause. Every such point is listed. With
    ``initial`` (the exempt initial set, a boolean mask), some point beyond
    it must pass. Then sweeps again with the calibrated margin installed:
    that safe set must lie inside the oracle's, and its level pass
    ``bench.py``'s second gate. ``margins64``: the oracle's margins of
    the same instance, computed already (the flagship's second route).
    Returns the float64 margins it held the card to.
    """
    c_dev = lyap.c_max
    safe = np.array(lyap.safe_set)
    points = lyap._device_points()
    negative = _negative_batch(
        lyap.policy, lyap.dynamics, lyap.lyapunov_function,
        lyap._lipschitz_lyapunov, lyap._lipschitz_dynamics, lyap.tau,
        points)[0].cpu().numpy()
    margin = st.oracle.calibrate_certificate_margin(lyap, num_samples=4096)
    start = time.perf_counter()
    all_points = lyap.discretization.all_points
    reused = margins64 is not None
    if not reused:
        margins64 = st.oracle.oracle_margins(lyap, all_points)
    oracle_safe, c_ref = st.oracle.oracle_safe_set(lyap, margins=margins64)
    print("{}: {} points, c_max={!r} (f64 oracle {!r}), {} safe points "
          "(oracle {}); f64 host oracle in {:.3f} s{}".format(
              label, len(all_points), c_dev, c_ref, int(safe.sum()),
              int(oracle_safe.sum()), time.perf_counter() - start,
              " (the margins of the same instance, computed already)"
              if reused else ""))
    gate_1(c_dev, c_ref)

    differ = negative != (margins64 < 0)
    band = np.abs(margins64) <= margin
    outside = np.flatnonzero(differ & ~band)
    print("{}: decrease check: {} points pass on the card, {} in the f64 "
          "oracle; {} disagree, {} within the calibrated band |margin| <= "
          "{!r} ({} points in it), {} outside it".format(
              label, int(negative.sum()), int((margins64 < 0).sum()),
              int(differ.sum()), int((differ & band).sum()), margin,
              int(band.sum()), len(outside)))
    conservative = outside[~negative[outside]]
    causes = dict(zip(conservative.tolist(), explain(conservative))) \
        if explain is not None and len(conservative) else {}
    failed = 0
    for j in outside:
        cause = ("the card passes a point the f64 oracle fails"
                 if negative[j] else causes.get(int(j)))
        failed += bool(negative[j]) or cause is None
        print("  point {} x={} f64 margin {!r}, card verdict {}: {}".format(
            j, all_points[j].tolist(), float(margins64[j]),
            bool(negative[j]), cause or "UNEXPLAINED"))
    if failed:
        raise AssertionError("{}: {} decrease verdicts differ from the f64 "
                             "oracle outside the calibrated band".format(
                                 label, failed))
    if initial is not None:
        passing = int((negative & ~initial).sum())
        print("{}: {} points pass outside the {} exempt initial points"
              .format(label, passing, int(initial.sum())))
        if passing == 0:
            raise AssertionError("no point beyond the initial set passes "
                                 "the decrease check")

    lyap.update_safe_set()
    check_values(lyap)
    safe = np.array(lyap.safe_set)
    unsafe = int((safe & ~oracle_safe).sum())
    print("{}: with margin={!r} level_margin={!r} installed c_max={!r} "
          "(<= oracle {!r}), {} safe points, {} of them outside the "
          "oracle's safe set".format(label, margin, lyap.level_margin,
                                     lyap.c_max, c_ref, int(safe.sum()),
                                     unsafe))
    if unsafe:
        raise AssertionError("{}: the certified set holds {} points the f64 "
                             "oracle does not".format(label, unsafe))
    gate_2(lyap.c_max, c_ref)
    return margins64


def phase_flagship_path(route, margins64=None):
    """The flagship verification at full width by one route: the stacked
    GP (kernel 3, one launch per sweep) or the fan-out of two GPs
    (kernel 2, one launch per member per sweep), through ``oracle_gate``.

    Some points beyond the exempt initial set must pass the decrease
    check. (The certified level set cannot grow past the initial set on
    this instance, in exact arithmetic too: near the origin the GP error
    term keeps the decrease bound above the threshold
    ``-L_v (1 + L_f) tau``.)

    Both routes model the same GPs on the same data, so the second route
    is held to the float64 margins the first computed (``margins64``;
    about 22 s of host oracle less). Returns ``(lyap, launches,
    margins64)``.
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
    initial = np.zeros(lyap.discretization.nindex, dtype=bool)
    initial[inst["initial_set"]] = True
    print("flagship {} path: {} points, tau {!r}, L_v {!r}, L_f {!r}, "
          "threshold {!r}; built in {:.3f} s".format(
              route, lyap.discretization.nindex, inst["tau"], inst["lv"],
              inst["lf"], -inst["lv"] * (1 + inst["lf"]) * inst["tau"],
              build_s))
    margins64 = oracle_gate(lyap, "flagship " + route, initial=initial,
                            margins64=margins64)
    launches = read_launches()
    print("kernel launches during the flagship {} path: first sweep {}, "
          "whole path {}".format(route, first, launches))
    if first[kernel] != per_sweep:
        raise AssertionError("the flagship {} sweep launched {} {} times, "
                             "not {}".format(route, kernel, first[kernel],
                                             per_sweep))
    return lyap, launches, margins64


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


#: Kernel-name fragments of the profile's categories, first match wins.
PROFILE_GROUPS = (("GP kernel", ("gp_predict", "gp_program")),
                  ("cuBLAS", ("gemm", "gemv", "cublas", "xmma", "cutlass")),
                  ("reduction", ("reduce",)),
                  ("gather/index", ("index", "gather", "scatter")),
                  ("elementwise", ("elementwise", "vectorized")),
                  ("copy/fill", ("copy", "fill", "memcpy", "memset")))


def profile_sweep(name, lyap, card, sweeps=5):
    """``profile_window`` over ``sweeps`` sweeps."""
    sweep = sweep_fn(lyap)

    def run():
        for _ in range(sweeps):
            sweep()

    return profile_window("{} sweep".format(name), run, sweeps, card)


def profile_window(label, run, reps, card):
    """Where the device time of ``run`` (``reps`` repetitions of a unit:
    a sweep, an ascent step) goes: ``profiling.trace`` over one call after
    a warm-up call, the call in a ``profiling.named_scope`` of ``label``,
    kernels grouped by ``PROFILE_GROUPS``, beside the CUDA-event time of
    the same window. Prints the device's busy share, the device
    operations a unit, the largest kernels and the size of the Chrome
    trace (written to a temporary directory and dropped); returns the
    groups' milliseconds per unit."""
    from torch.autograd import DeviceType

    run()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with tempfile.TemporaryDirectory() as log_dir:
        with profiling.trace(log_dir) as prof:
            with profiling.named_scope(label):
                start.record()
                run()
                end.record()
                torch.cuda.synchronize()
        trace_bytes = sum(os.path.getsize(os.path.join(log_dir, f))
                          for f in os.listdir(log_dir))
    wall = start.elapsed_time(end) / reps
    kernels, host = [], []
    for ev in prof.key_averages():
        # The named scope spans the window on both timelines; it is no
        # operation of the host nor a kernel of the device.
        if ev.key == label:
            continue
        if ev.device_type != DeviceType.CUDA:
            host.append((ev.self_cpu_time_total / 1e3 / reps, ev.key))
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        kernels.append((us / 1e3 / reps, ev.count / reps, ev.key))
    busy = sum(ms for ms, _, _ in kernels)
    print("{} trace: {} bytes of Chrome trace".format(label, trace_bytes))
    print("{} host: {!r} ms a unit inside PyTorch's operators (self CPU "
          "time under the profiler), the rest in Python; largest: {}".format(
              label, sum(ms for ms, _ in host), ", ".join(
                  "{} {:.4f} ms".format(key, ms)
                  for ms, key in sorted(host, reverse=True)[:6])))
    groups = {}
    for ms, _, key in kernels:
        group = next((g for g, frags in PROFILE_GROUPS
                      if any(f in key.lower() for f in frags)), "other")
        groups[group] = groups.get(group, 0.0) + ms
    print("{} profile: {!r} ms a unit by CUDA events, device busy {!r} ms "
          "({:.1%}), {!r} device operations a unit [{}]".format(
              label, wall, busy, busy / wall if wall else 0.0,
              sum(count for _, count, _ in kernels), card))
    for group, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print("  {}: {!r} ms ({:.1%} of busy)".format(group, ms,
                                                      ms / busy))
    for ms, count, key in sorted(kernels, reverse=True)[:8]:
        print("  {!r} ms, {!r} a unit: {}".format(ms, count, key[:110]))
    return groups


def graph_ms(fn, reps=10, batch=10):
    """Median milliseconds of one call of ``fn`` on the device: ``batch``
    calls captured in a CUDA graph, the graph replayed ``reps`` times
    between CUDA events (fewer of each for a call too slow for
    ``TIMING_BUDGET_MS``). The host's work per call (argument checks,
    allocations, the ctypes call) is not in it."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    reps, batch = _within_budget(start.elapsed_time(end), reps, batch)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(batch):
            fn()
    ms = cuda_ms(graph.replay, reps=reps, warmup=1) / batch
    del graph
    return ms


#: ``graph_ms``' replays and calls a graph for a plain version, as the
#: variants' plain versions are timed: its calls take 3-80 ms, and 100 a
#: run cost more than a minute of the script's time over the paths.
#: ``plain_method_check`` reads both methods on one path.
PLAIN_GRAPH = dict(reps=3, batch=2)


def plain_method_check(card, lyap):
    """Kernel 1's plain version at the bench inputs timed both ways, in
    turns (10 replays of 10 calls, ``PLAIN_GRAPH``, ``PLAIN_GRAPH``, 10 of
    10): what ``PLAIN_GRAPH`` changes in a ``plain_ms``."""
    inputs, _ = sweep_inputs(lyap)

    def plain():
        return gp_kernel.gp_predict_plain(*inputs, kind="rbf")

    full = [graph_ms(plain)]
    short = [graph_ms(plain, **PLAIN_GRAPH), graph_ms(plain, **PLAIN_GRAPH)]
    full.append(graph_ms(plain))
    print("plain_ms method, kernel 1's plain version at the bench inputs: "
          "10 replays of 10 calls {!r} ms, PLAIN_GRAPH {!r} ms [{}]".format(
              full, short, card))


def time_against_plain(name, kernel, plain, card, shape):
    """Kernel against plain on the device (``graph_ms``; the plain version
    at ``PLAIN_GRAPH``), in turns (plain, kernel, kernel, plain); then the
    kernel as a caller sees it, 10 eager calls back to back
    (``cuda_ms``), host work included. Returns ``(kernel_ms, plain_ms,
    eager_ms)``."""
    plain_runs = [graph_ms(plain, **PLAIN_GRAPH)]
    kernel_runs = [graph_ms(kernel), graph_ms(kernel)]
    plain_runs.append(graph_ms(plain, **PLAIN_GRAPH))
    eager_ms = cuda_ms(kernel, batch=10)
    kernel_ms = statistics.mean(kernel_runs)
    plain_ms = statistics.mean(plain_runs)
    print("{} at {}: kernel {!r} ms (runs {!r}), plain {!r} ms (runs {!r}); "
          "kernel by 10 eager calls {!r} ms [{}]".format(
              name, shape, kernel_ms, kernel_runs, plain_ms, plain_runs,
              eager_ms, card))
    return kernel_ms, plain_ms, eager_ms


#: The H100 SXM's published peaks (NVIDIA's data sheet, dense, 700 W):
#: FP32 on the CUDA cores, FP64 on the CUDA cores and on the tensor cores
#: (DMMA, IEEE float64), TF32 on the tensor cores, and HBM3 bandwidth. TF32
#: is not IEEE float32 and is not allowed on the kernels' path, so FP32 is
#: a float32 kernel's arithmetic peak (kernel 1's arithmetic is IEEE
#: float32; three TF32 passes are not). The exceptions are kernels 6 and
#: 7's float32 tiled bodies, off every path, whose ``L^-1 K`` runs in three
#: TF32 passes: their bound (``tf32x3``) takes that product at a third of
#: ``TF32_TC_FLOPS``. A float64 kernel's matrix product ``L^-1 K`` could
#: run on DMMA, so its bound takes that product at ``FP64_TC_FLOPS`` and
#: the rest at ``FP64_FLOPS``, whatever instructions the kernel executes.
FP32_FLOPS = 67e12
FP64_FLOPS = 34e12
FP64_TC_FLOPS = 67e12
TF32_TC_FLOPS = 495e12
HBM_BYTES_PER_S = 3.35e12

#: Operations of one stationary covariance from r^2 (exp and sqrt one
#: each), as ``gp_predict_common.cuh`` writes them.
COV_OPS = {"rbf": 2, "matern12": 4, "matern32": 7, "matern52": 10}


def stationary_ops(kind, d):
    """Operations of kernel 1's ``k_j`` per row and query: ``d``
    differences, ``d`` squares and ``d - 1`` adds for ``r^2``, the
    covariance, the scale and the mask."""
    return 3 * d - 1 + COV_OPS[kind] + 2


def folded_ops(kind, d):
    """Operations of kernel 6's bare ``k_j`` per row and query: kernel 1's
    without the scale and the mask, which the wrapper folds into the
    columns of ``chol_inv`` once per call (``count^2`` multiplies, left
    out)."""
    return stationary_ops(kind, d) - 2


def program_ops(programs):
    """Operations of every output's ``k_j`` per row and query, counted as
    the function needs them: each distinct column difference or product
    once across all outputs (they do not depend on the parameters; the
    plain twin shares them), then per output its parameter multiplies,
    ``n - 1`` adds per ``n``-term sum, each covariance, the sums and
    products of the program's nodes, the scale and the mask."""
    columns = set()

    def ops(node):
        op = node[0]
        if op == "stationary":
            _, fam, sel = node[:3]
            columns.update(("diff", dim) for dim in sel)
            # Lengthscale multiplies, squares, adds, covariance, variance.
            return 3 * len(sel) - 1 + COV_OPS[fam] + 1
        if op == "linear":
            columns.update(("prod", dim) for dim in node[1])
            return 2 * len(node[1]) - 1
        return ops(node[1]) + ops(node[2]) + 1

    per_output = sum(ops(program) + 2 for program in programs)
    return len(columns) + per_output


def kernel_bound(n_q, d, count, p, n_out, k_ops, itemsize, tf32x3=False):
    """The least time of one predict on the H100 at these inputs:
    ``(bound_ms, bound_by, bound_kind)``.

    Operations, with ``n = count``: per query and output ``n^2`` for the
    triangular solve, the product ``L^-1 K`` (``n (n + 1) / 2``
    multiplies, ``n (n - 1) / 2`` adds), and ``(p + 1) (2 n - 1)`` for
    the reductions; per query ``n * k_ops`` for k (``k_ops``: every
    output's operations per row, ``stationary_ops`` or ``program_ops``).
    For 4-byte values all of them over ``FP32_FLOPS``; for 8-byte ones the
    product over ``FP64_TC_FLOPS`` and the rest over ``FP64_FLOPS``; with
    ``tf32x3`` (kernels 6 and 7's float32 tiled bodies, kind ``tf32x3``) the
    product over ``TF32_TC_FLOPS / 3`` (three TF32 passes) and the rest
    over ``FP32_FLOPS``. Bytes: queries, the active rows of x, chol_inv,
    alpha and the mask read once, the outputs written once, over
    ``HBM_BYTES_PER_S``. The larger wins.
    """
    product = n_q * n_out * count * count
    rest = n_q * (n_out * (p + 1) * max(2 * count - 1, 0) + count * k_ops)
    values = (n_q * d + count * d + n_out * count * (count + p) + count
              + n_q * n_out * (p + 1))
    if itemsize == 8:
        ops_ms = (product / FP64_TC_FLOPS + rest / FP64_FLOPS) * 1e3
        kind = "fp64"
    elif tf32x3:
        ops_ms = (product / (TF32_TC_FLOPS / 3) + rest / FP32_FLOPS) * 1e3
        kind = "tf32x3"
    else:
        ops_ms = (product + rest) / FP32_FLOPS * 1e3
        kind = "fp32"
    bytes_ms = values * itemsize / HBM_BYTES_PER_S * 1e3
    if ops_ms >= bytes_ms:
        return ops_ms, "operations", kind
    return bytes_ms, "bytes", "hbm"


def sweep_inputs(lyap):
    """Kernel 1's inputs exactly as a sweep of ``lyap`` (a stationary
    ``GaussianProcess``) makes them, and the GP."""
    points = lyap._device_points()
    gp = lyap.dynamics
    states = concatenate_inputs(points, lyap.policy(points))
    return pipelined_predict.kernel_inputs(gp, states), gp


def phase_times(card, lyap, label="bench"):
    """Kernel 1 against its plain version on a sweep's inputs (the bench
    path's, or the cart-pole's): ``stationary_times``."""
    return stationary_times(card, *sweep_inputs(lyap), label)


#: Queries a call of kernel 1's plain version and of its bounds takes
#: above 512 rows (``stationary_times``).
PLAIN_ROWS = 2 ** 18


def stationary_times(card, inputs, gp, label):
    """Kernel 1 against its plain version on one path's inputs:
    ``(max_abs_err, ms, plain_ms, eager_ms, bound_ms, bound_by,
    bound_kind, library_ms)``, ``library_ms`` the product alone
    (``stationary_product_ms``). Above 512 rows the comparison's bounds
    and the plain version run ``PLAIN_ROWS`` queries at a time, which
    bounds their ``count x Q`` intermediates."""
    states = inputs[0]
    chunk = PLAIN_ROWS if gp.count > 512 else 2 ** 20
    em, ev, ratio = compare(inputs, "rbf", count=gp.count, chunk=chunk)
    print("{}-path inputs (Q={}, d={}, cap={}, count={}, p={}): max|dmean|="
          "{:.3e} max|dvar|={:.3e} err/bound={:.3f}".format(
              label, states.shape[0], states.shape[1], gp.capacity, gp.count,
              gp.output_dim, em, ev, ratio))
    if not ratio <= 1.0:
        raise AssertionError("kernel disagrees on the {}-path inputs"
                             .format(label))
    def plain():
        for start in range(0, states.shape[0], chunk):
            gp_kernel.gp_predict_plain(states[start:start + chunk],
                                       *inputs[1:], kind="rbf")

    kernel_ms, plain_ms, eager_ms = time_against_plain(
        "gp predict ({})".format(label),
        lambda: gp_kernel.gp_predict_cuda(*inputs, kind="rbf",
                                          count=gp.count), plain, card,
        "Q={}, d={}, cap {}, count {}, p={}".format(
            states.shape[0], states.shape[1], gp.capacity, gp.count,
            gp.output_dim))
    bound = kernel_bound(states.shape[0], states.shape[1], gp.count,
                         gp.output_dim, 1,
                         stationary_ops("rbf", states.shape[1]),
                         states.element_size())
    library_ms = stationary_product_ms(inputs, "rbf", gp.count)
    print("gp predict ({}): the product alone {!r} ms [{}]".format(
        label, library_ms, card))
    return (max(em, ev), kernel_ms, plain_ms, eager_ms) + bound + (
        library_ms,)


#: ``bench.py``'s instance (1000x1000, Q = 10^6) with more training points
#: (``n_train``): kernel 1 on its panel body (512) and its strip body
#: (2,048, the most a GP routes to a kernel).
BENCH_GROWN = (512, 2048)


def phase_bench_grown(card):
    """``bench.py``'s instance built by the port at ``BENCH_GROWN`` training
    points: one certify each, kernel 1 launched once on the body its count
    selects, its wall time; at 512 the decrease verdict of every grid
    point against the float64 oracle outside
    ``calibrate_certificate_margin``'s band and the ``c_max`` gap to the
    oracle's (``bench.py``'s 5e-4 gate is not held: its noise was tuned for
    128 points); at 2,048, where the host oracle would cost about 2 10^12
    FMAs, kernel 1 is held to its plain twin on the card
    (``grown_bench_times``). Returns ``[(lyap, launches)]``."""
    out = []
    for n_train in BENCH_GROWN:
        inst = build_bench_instance(1000, n_train=n_train)
        lyap = st.Lyapunov(inst["grid"], inst["v"], inst["gp"], inst["lf"],
                           inst["lv"], inst["tau"], inst["policy"],
                           initial_set=inst["initial_set"])
        label = "bench at {} training points".format(n_train)
        reset_launches()
        _, sweep_s = synchronised_s(lyap.update_safe_set)
        launches = read_launches()
        if launches != dict({n: 0 for n in KERNELS}, gp_predict=1):
            raise AssertionError("{}: the certify launched {}".format(
                label, launches))
        body = gp_kernel.stationary_body(lyap.dynamics.count,
                                         torch.float32, 2, 3)
        print("{}: count {}, kernel 1 on its {} body, one launch; safe "
              "fraction {!r}, c_max {!r}; certify {!r} s wall [{}]".format(
                  label, lyap.dynamics.count, body,
                  float(lyap.safe_set.mean()), lyap.c_max, sweep_s, card))
        if body != expected_body(lyap.dynamics.count,
                                 panel_max(torch.float32)):
            raise AssertionError("{}: kernel 1 took the {} body".format(
                label, body))
        if n_train == BENCH_GROWN[-1]:
            host_factorization_time(lyap.dynamics, label, card)
        if n_train == BENCH_GROWN[0]:
            with uncounted():
                band = st.oracle.calibrate_certificate_margin(
                    lyap, num_samples=4096, set_margin=False)
                negative = _negative_batch(
                    lyap.policy, lyap.dynamics, lyap.lyapunov_function,
                    lyap._lipschitz_lyapunov, lyap._lipschitz_dynamics,
                    lyap.tau, lyap._device_points())[0].cpu().numpy()
            margins64, oracle_s = synchronised_s(
                lambda: st.oracle.oracle_margins(
                    lyap, lyap.discretization.all_points))
            _, c_ref = st.oracle.oracle_safe_set(lyap, margins=margins64)
            differ = negative != (margins64 < 0)
            outside = int((differ & (np.abs(margins64) > band)).sum())
            print("{}: decrease verdicts at all {} points: {} pass on the "
                  "card, {} in the f64 oracle ({!r} s), {} differ, {} of "
                  "them outside the band {!r}; c_max {!r} against the "
                  "oracle's {!r} (gap {!r} relative)".format(
                      label, len(negative), int(negative.sum()),
                      int((margins64 < 0).sum()), oracle_s,
                      int(differ.sum()), outside, band, lyap.c_max, c_ref,
                      abs(lyap.c_max - c_ref) / abs(c_ref)))
            if outside:
                raise AssertionError("{}: {} decrease verdicts differ from "
                                     "the f64 oracle outside the band"
                                     .format(label, outside))
        time_sweep(label, lyap, card)
        out.append((lyap, launches["gp_predict"]))
    return out


def host_factorization_time(gp, label, card, reps=3):
    """The wall seconds of the GP's host float64 factorization of its data
    at its capacity (``_host_factorize``: the Cholesky factor, its inverse
    and alpha, as a fresh GP or a refresh after appends computes them),
    the median of ``reps``."""
    from safe_learning_tpu_torch.functions.gp import _host_factorize

    x_buf, y_buf = gp.X_buf.cpu().numpy(), gp.Y_buf.cpu().numpy()
    times = []
    for _ in range(reps):
        start = time.perf_counter()
        _host_factorize(gp.kernel, x_buf, y_buf, gp.mean_function, gp.count,
                        float(gp.noise_variance), gp.scale)
        times.append(time.perf_counter() - start)
    print("{}: the host float64 factorization at capacity {}, count {}: "
          "{!r} s (median of {}: {!r}) [{}]".format(
              label, gp.capacity, gp.count, statistics.median(times), reps,
              times, card))


def grown_bench_times(card, lyap, launches):
    """Kernel 1 on a grown bench instance's sweep inputs
    (``stationary_times``, then the streamed body,
    ``gp_predict_streamed_cuda``), in float32 and, at 2,048 rows,
    the same inputs in float64. Returns the paths for ``kernel_rows``."""
    inputs, gp = sweep_inputs(lyap)
    count = gp.count
    entries = []
    for dtype in (torch.float32, torch.float64):
        if dtype == torch.float64 and count < BENCH_GROWN[-1]:
            continue
        ins = tuple(t.to(dtype) if torch.is_tensor(t) else t
                    for t in inputs)
        label = "bench {} {}".format(count, str(dtype)[6:])

        def timed(ins=ins, label=label, dtype=dtype):
            entry = dict(zip(("max_abs_err", "ms", "plain_ms", "eager_ms",
                              "bound_ms", "bound_by", "bound_kind",
                              "library_ms"),
                             stationary_times(card, ins, gp, label)))

            def streamed():
                gp_kernel.gp_predict_streamed_cuda(*ins, kind="rbf",
                                                   count=count)
            # The streamed body read once, after the body's two readings in
            # ``stationary_times``' turns (its calls take 27 ms to 1.4 s
            # here); its eager time is not read.
            entry.update(
                body=gp_kernel.stationary_body(count, dtype, 2, 3),
                streamed_ms=graph_ms(streamed), streamed_eager_ms=None,
                library_call=PRODUCT_CALL, queries=ins[0].shape[0],
                count=count)
            print("kernel 1 at {} (Q={}, count {}): {} body {!r} ms, then "
                  "the streamed body {!r} ms [{}]".format(
                      label, ins[0].shape[0], count, entry["body"],
                      entry["ms"], entry["streamed_ms"], card))
            return entry
        # The float64 reading times the shape: no path runs kernel 1 in
        # float64 at 2,048 rows, so it carries no launches.
        entries.append(timed_path(
            "gp_predict", "bench_{}".format(count) + (
                "_float64" if dtype == torch.float64 else ""),
            0 if dtype == torch.float64 else launches,
            in_float64(timed) if dtype == torch.float64 else timed))
    return entries


# ---------------------------------------------------------------------------
# Kernel 1's variants: the port's benchmark modules
# ---------------------------------------------------------------------------
#: The variants in ``pipelined_predict.run``'s order: the name ``run``
#: reports, the kernel (``KERNELS``), the k form, the keywords of a call.
VARIANTS = (("pipelined", "pipelined_gp_predict", "stationary", {}),
            ("interleaved2", "interleaved_gp_predict", "stationary",
             {"halves": 2}),
            ("interleaved4", "interleaved_gp_predict", "stationary",
             {"halves": 4}),
            ("folded", "folded_gp_predict", "folded", {}),
            ("expanded", "fused_predict_mxu_dist", "expanded", {}))
FORMS = ("stationary", "folded", "expanded")


def form_inputs(inputs, form):
    """A k form's kernel arguments from kernel 1's: the folded form takes
    ``(q, x, chol_inv_scaled, alpha)``, the fold made here."""
    if form != "folded":
        return inputs
    q, x, li, alpha, mask, var_s2 = inputs
    return (q, x, pipelined_predict.fold_chol_inv(li, mask, var_s2), alpha)


def tf32x3_body(inputs, count):
    """Whether kernels 6 and 7 take their three-pass TF32 bodies on these
    inputs: float32 and the loops bounded at 128 rows or fewer (the tiled
    bodies; ``count`` ``None``: the capacity)."""
    n = inputs[1].shape[0] if count is None else count
    return inputs[0].dtype == torch.float32 and n <= 128


def form_plain(form, kind, tf32x3=False):
    """``(plain(part), bounds(part))`` of a k form: its plain version and
    its rounding bound (``rounding_bounds``, ``folded_bounds``,
    ``expanded_bounds``; with ``tf32x3`` the folded and expanded forms'
    three-pass TF32 bounds, ``tf32x3_body``)."""
    if form == "stationary":
        return (lambda part: gp_kernel.gp_predict_plain(*part, kind=kind),
                lambda part: rounding_bounds(part, kind))
    if form == "folded":
        return (lambda part: pipelined_predict.folded_gp_predict_plain(
            *part, kind=kind),
                lambda part: folded_bounds(part, kind, tf32x3))
    return (lambda part: distance_mxu_experiment.fused_predict_mxu_dist_plain(
        *part, kind=kind), lambda part: expanded_bounds(part, kind, tf32x3))


def kernel_calls(inputs, kind, count):
    """``[(name, call)]``: kernel 1's wrapper and each variant's on
    kernel 1's ``inputs`` (each k form's arguments made once, here)."""
    args = {form: form_inputs(inputs, form) for form in FORMS}
    calls = [("kernel1", functools.partial(
        gp_kernel.gp_predict_cuda, *inputs, kind=kind, count=count))]
    for name, kernel, form, kw in VARIANTS:
        calls.append((name, functools.partial(
            KERNELS[kernel][0], *args[form], kind=kind, count=count, **kw)))
    return calls


def check_variants(inputs, kind, count, chunk=2 ** 19):
    """Every variant against its plain version on kernel 1's inputs, its
    loops bounded by ``count``: ``{name: (max|dmean|, max|dvar|,
    err/bound)}``."""
    calls = dict(kernel_calls(inputs, kind, count))
    results = {}
    for form in FORMS:
        names = [name for name, _, f, _ in VARIANTS if f == form]
        outs = [calls[name]() for name in names]
        plain, bounds = form_plain(form, kind, tf32x3_body(inputs, count))
        errors = compare_outputs(outs, plain, bounds,
                                 form_inputs(inputs, form), chunk)
        results.update(zip(names, errors))
        del outs
    return results


#: Count edges of kernels 4-7's float32 tiled bodies: one row, one and two
#: 8-row k steps and 16-row tiles (and 4-row groups of kernel 6's fill),
#: the 64-row split of kernels 6 and 7's solve warpgroups, the bucket's
#: last rows; 129 takes the streamed body.
VARIANT_COUNTS = (0, 1, 16, 17, 64, 127, 128, 129)


def on_training_rows(inputs, count):
    """Kernel inputs with the GP's first ``count`` (scaled) training rows
    put before the queries: ``r^2 = 0`` there, where the expanded form
    cancels."""
    q, x = inputs[:2]
    return (torch.cat([x[:count], q]),) + tuple(inputs[1:])


def variant_cases():
    """Part (a) of ``phase_kernel_variants``: every variant against its
    plain version within its bound, float32 and float64, the four kinds,
    capacities 8, 128 (tiled) and 2048 (streamed) with a quarter of the
    rows padding, the cart-pole's d = 5, p = 4, and many outputs at
    capacity 128 (p = 8 at d = 2, p = 7 at d = 16, where kernel 5's
    partial sums take its K tile's room); the loops bounded by
    the count in every other case, by the capacity in the rest. The query
    counts are ragged and give every block of the persistent grid several
    tiles (and groups of 4 tiles). Then, in float32, the count edges
    ``VARIANT_COUNTS`` at the four kinds, d = 3, p = 2 and d = 5, p = 4 in
    turn, the queries led by the GP's training rows
    (``on_training_rows``). Kernels 6 and 7's float32 tiled bodies are
    held to ``folded_bounds(..., tf32x3=True)`` and ``expanded_bounds(...,
    tf32x3=True)``, their other cases to the bounds without."""
    worst = {name: 0.0 for name, _, _, _ in VARIANTS}
    case = 0
    specs = [(kind, cap, 1 + (ki + ci) % 2, 3)
             for ki, kind in enumerate(gp_kernel.KINDS)
             for ci, cap in enumerate((8, 128, 2048))] + [
                 ("rbf", 128, 4, 5), ("rbf", 128, 8, 2),
                 ("matern32", 128, 7, 16)]
    cases = [(dtype, kind, cap, p, d, None) for dtype in (torch.float32,
                                                         torch.float64)
             for kind, cap, p, d in specs]
    cases += [(torch.float32, kind, 128 if n <= 128 else 256,
               *((2, 3), (4, 5))[(ci + ki) % 2], n)
              for ci, n in enumerate(VARIANT_COUNTS)
              for ki, kind in enumerate(gp_kernel.KINDS)]
    for dtype, kind, cap, p, d, n in cases:
        case += 1
        scale = (1.0, 2.5)[case % 2]
        gp = case_gp(kind, cap, p, scale, dtype, seed=500 + case, n=n, d=d)
        if n is None:
            n_q = 65537 if cap > 128 else 100003
            count = gp.count if case % 2 else None
            inputs = case_inputs(gp, n_q, 500 + case)
        else:
            count = gp.count
            inputs = on_training_rows(case_inputs(gp, 4099, 500 + case), n)
            n_q = inputs[0].shape[0]
        errors = check_variants(inputs, kind, count)
        print("variant case {:2d} {} {:8s} d={} cap={:4d} count={} p={} "
              "scale={} Q={:6d}{}: ".format(
                  case, str(dtype)[6:], kind, d, cap, count, p, scale, n_q,
                  " (training rows first)" if n is not None else "")
              + ", ".join("{} {:.3e}/{:.3e} ({:.3f})".format(name, *err)
                          for name, err in errors.items()))
        for name, (_, _, ratio) in errors.items():
            if not ratio <= 1.0:
                raise AssertionError(
                    "variant {} and its plain version disagree beyond "
                    "the rounding bound (err/bound {:.3f})".format(
                        name, ratio))
            worst[name] = max(worst[name], ratio)
    print("variants against plain: {} cases each, worst err/bound {} "
          "(bounds: rounding_bounds, folded_bounds, expanded_bounds, "
          "in kernels 6 and 7's float32 tiled bodies with tf32x3)".format(
              case, {k: round(v, 4) for k, v in worst.items()}))


def variant_times(card, label, inputs, count):
    """Part (b) and (c) of ``phase_kernel_variants`` on one instance's
    kernel-1 inputs.

    The variants' path: ``pipelined_predict.run`` and
    ``distance_mxu_experiment.run``, as a user runs them, with every
    counter set to 0 before and read after (each variant's max |d| from
    kernel 1 and speed-up; kernel 1's and the expanded form's error
    against the float64 oracle). Then, uncounted: each variant against its
    plain version within its bound; device times (``graph_ms``) of kernel
    1 and every variant in turns, two rounds; eager times; the plain
    versions' device times. Returns the ``paths`` entries; a variant's
    ``bound_ms`` is the ``kernel_bound`` of kernel 1's work (kernel 6's
    without the scale and the mask, ``folded_ops``), over the three-pass
    TF32 rate in kernels 6 and 7's float32 tiled bodies.
    """
    n_q, d = inputs[0].shape
    p = inputs[3].shape[1]
    reset_launches()
    bench = pipelined_predict.run(inputs, reps=3, count=count, batch=5)
    oracle = distance_mxu_experiment.run(inputs, reps=3, count=count,
                                         batch=5)
    launches = read_launches()
    shape = "Q={}, d={}, count={}, p={}".format(n_q, d, count, p)
    for name, entry in bench.items():
        print("variants path ({}, {}): {} {!r} ms (runs {!r}){} [{}]".format(
            label, shape, name, entry["ms"], entry["runs"],
            "" if name == "kernel1" else
            ", speed-up {!r}, max|dmean| from kernel 1 {:.3e}, max|dvar| "
            "{:.3e}, bit for bit kernel 1's: {}".format(
                entry["speedup"], entry["max_abs_mean_diff"],
                entry["max_abs_var_diff"], entry["bitwise_identical"]),
            card))
    for name, entry in oracle.items():
        print("distance experiment ({}): {} {!r} ms per 1M predicts, "
              "|mean err vs f64| {:.3e} (first 4096 queries) [{}]".format(
                  label, name, entry["ms_per_1m"],
                  entry["max_abs_err_vs_f64"], card))
    with torch.no_grad(), uncounted():
        errors = check_variants(inputs, "rbf", count)
        calls = kernel_calls(inputs, "rbf", count)
        # Kernel 6's error against the float64 oracle on the queries
        # distance_mxu_experiment.run holds kernel 1 and kernel 7 to.
        ref = distance_mxu_experiment.oracle_mean(inputs, "rbf", 4096)
        folded_f64 = float((dict(calls)["folded"]()[0][:4096].to(
            "cpu", torch.float64) - ref).abs().max())
        print("variants ({}): |mean err vs f64| (first 4096 queries): "
              "kernel 1 {:.3e}, folded {:.3e}, expanded {:.3e} [{}]".format(
                  label, oracle["kernel1"]["max_abs_err_vs_f64"],
                  folded_f64, oracle["expanded"]["max_abs_err_vs_f64"],
                  card))
        runs = {name: [] for name, _ in calls}
        for _ in range(2):
            for name, fn in calls:
                runs[name].append(graph_ms(fn, reps=5, batch=5))
        eager = {name: cuda_ms(fn, reps=5, batch=5) for name, fn in calls}
        plain_ms = {}
        for form in FORMS:
            plain, _ = form_plain(form, "rbf")
            args = form_inputs(inputs, form)
            plain_ms[form] = graph_ms(lambda: plain(args), **PLAIN_GRAPH)
        # Every variant computes kernel 1's function at kernel 1's inputs:
        # the same yardstick, the solve's product alone.
        library_ms = stationary_product_ms(inputs, "rbf", count)
    def form_bounds(form):
        """``(FP32 bound, tf32x3 bound)`` of a k form: kernel 6's folded
        form counts ``folded_ops``, the others kernel 1's work; the second
        for kernels 6 and 7's float32 tiled bodies (L^-1 K in three TF32
        passes)."""
        k_ops = (folded_ops if form == "folded" else stationary_ops)("rbf", d)
        return tuple(kernel_bound(n_q, d, count, p, 1, k_ops,
                                  inputs[0].element_size(), tf32x3=tc)
                     for tc in (False, True))

    bound = form_bounds("stationary")[0]
    k1_ms = statistics.mean(runs["kernel1"])
    print("variants ({}, {}): kernel 1 {!r} ms (runs {!r}), eager {!r} ms, "
          "plain {!r} ms; bound {!r} ms ({}); the product alone {!r} ms "
          "[{}]".format(label, shape, k1_ms, runs["kernel1"],
                        eager["kernel1"], plain_ms["stationary"], bound[0],
                        bound[1], library_ms, card))
    entries = []
    for name, kernel, form, kw in VARIANTS:
        ms = statistics.mean(runs[name])
        em, ev, ratio = errors[name]
        fp32, tf32x3 = form_bounds(form)
        own = fp32
        if form != "stationary" and tf32x3_body(inputs, count):
            own = tf32x3
        print("variant {} ({}): {!r} ms (runs {!r}), {:.3f} of kernel 1's "
              "time, eager {!r} ms, plain {!r} ms, {:.1%} of its bound "
              "{!r} ms ({}; FP32 bound {:.1%}); against plain max|dmean| "
              "{:.3e} max|dvar| {:.3e} err/bound {:.3f}; {} launches on the "
              "path [{}]".format(
                  name, label, ms, runs[name], ms / k1_ms, eager[name],
                  plain_ms[form], own[0] / ms, own[0], own[2],
                  fp32[0] / ms, em, ev, ratio, launches[kernel], card))
        if not ratio <= 1.0:
            raise AssertionError("variant {} disagrees with its plain version "
                                 "on the {} inputs".format(name, label))
        if launches[kernel] < 1:
            raise AssertionError("the variants path never launched {}"
                                 .format(kernel))
        path = label + ("_halves{}".format(kw["halves"]) if kw else "")
        entries.append((kernel, path, (launches[kernel], max(em, ev), ms,
                                       plain_ms[form], eager[name]) + own
                        + (library_ms,)))
    return entries


def phase_kernel_variants(card, bench_lyap, cart_lyap):
    """Kernel 1's four variants (``csrc/gp_predict_variants.cu``): (a)
    ``variant_cases``; (b) and (c) ``variant_times`` at the bench sweep's
    and the cart-pole sweep's kernel-1 inputs. Returns the ``paths``
    entries of both instances."""
    start = time.perf_counter()
    variant_cases()
    entries = []
    for label, lyap in (("bench", bench_lyap), ("cartpole_51x4", cart_lyap)):
        inputs, gp = sweep_inputs(lyap)
        entries += variant_times(card, label, inputs, gp.count)
        del inputs
    print("kernel variants phase: {:.3f} s".format(
        time.perf_counter() - start))
    return entries


def program_times(card, route, lyap, label):
    """Kernel 3 (``route="stacked"``) or kernel 2 (``"general"``, on the
    GP or the first member of a ``FunctionStack``) against its plain
    version on a sweep's own inputs: the flagship's or the 1-D
    example's."""
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
        gp = getattr(lyap.dynamics, "functions", (lyap.dynamics,))[0]
        program, params = gp_kernel.compile_kernel_program(
            gp.kernel, input_dim=gp.input_dim)
        programs = (program,)
        inputs = (states, gp.X_buf, gp_kernel.program_params(params, states),
                  gp.chol_inv, gp.alpha, gp._mask(), gp.scale ** 2)
        cuda, plain = (gp_kernel.gp_predict_general_cuda,
                       gp_kernel.gp_predict_general_plain)
        arg = program
    # s2 on the device: a host scalar would be copied to the card inside
    # the CUDA graph that times the kernel, which capture refuses.
    inputs = inputs[:-1] + (torch.tensor(inputs[-1], dtype=states.dtype,
                                         device=states.device),)
    em, ev, ratio = compare_program(route, inputs, programs,
                                    count=gp.count)
    shape = "Q={}, d={}, cap {}, count {}, S={}".format(
        states.shape[0], states.shape[1], gp.capacity, gp.count,
        len(programs))
    print("{} inputs ({}): max|dmean|={:.3e} max|dvar|={:.3e} "
          "err/bound={:.3f}".format(label, shape, em, ev, ratio))
    if not ratio <= 1.0:
        raise AssertionError("kernel disagrees on the {} inputs".format(
            label))
    kernel_ms, plain_ms, eager_ms = time_against_plain(
        "gp predict {} ({})".format(route, label),
        lambda: cuda(*inputs, arg, count=gp.count),
        lambda: plain(*inputs, arg), card, shape)
    bound = kernel_bound(states.shape[0], states.shape[1], gp.count, 1,
                         len(programs), program_ops(programs),
                         states.element_size())
    library_ms = product_ms(inputs, programs, gp.count)
    print("gp predict {} ({}): the product alone {!r} ms [{}]".format(
        route, label, library_ms, card))
    return (max(em, ev), kernel_ms, plain_ms, eager_ms) + bound + (
        library_ms,)


# ---------------------------------------------------------------------------
# The safe-learning loop: certify, explore and append, re-certify
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def plain_stacked_predict():
    """Route the stacked GP's predict through kernel 3's plain twin (the
    same math in plain PyTorch) instead of the kernel, for the duration
    of the block."""
    fused = gp_kernel.fused_gp_predict_stacked
    gp_kernel.fused_gp_predict_stacked = gp_kernel.gp_predict_stacked_plain
    try:
        yield
    finally:
        gp_kernel.fused_gp_predict_stacked = fused


def simplex_flips(lyap, tri, idx, mean=None):
    """Whether the working-dtype pipeline locates grid points ``idx``, or
    their mean next states, in another simplex of the value function
    ``tri`` than float64 arithmetic does.

    The local ``L_v = GradientNorm(tri)`` is piecewise constant, so such a
    point's ``L_v`` differs by a whole gradient step between the two.
    ``mean`` is the working dtype's mean next state at ``idx`` (the GP's,
    on the whole grid, so that the rows round as in the sweep); without it
    only the points are compared. Returns ``(at_x, at_mean)`` boolean
    arrays (``at_mean`` is ``None`` without ``mean``).
    """
    pts = lyap.discretization.all_points[idx]
    at_x = (tri.find_simplex(st.functions.base.as_tensor(pts)).cpu().numpy()
            != _simplex64(tri, pts))
    if mean is None:
        return at_x, None
    dyn64 = st.oracle.lift64(lyap.dynamics)
    policy64 = st.oracle.lift64(lyap.policy)
    with st.oracle._oracle_env():
        q = torch.as_tensor(pts, dtype=torch.float64)
        mean64 = dyn64(q, policy64(q))[0].numpy()
    at_mean = (tri.find_simplex(mean).cpu().numpy()
               != _simplex64(tri, mean64))
    return at_x, at_mean


def _simplex64(tri, points):
    tri64 = st.oracle.lift64(tri)
    with st.oracle._oracle_env():
        return tri64.find_simplex(torch.as_tensor(
            np.asarray(points), dtype=torch.float64)).numpy()


def flip_causes(lyap, tri, idx):
    """Why the card may fail grid points ``idx`` that the float64 oracle
    passes: the working dtype locates the point, or its mean next state,
    in another simplex of the value function ``tri`` than float64 does (a
    jump of the local ``L_v``). One cause, or ``None``, per point."""
    points = lyap._device_points()
    mean = lyap.dynamics(points, lyap.policy(points))[0][
        torch.as_tensor(idx, device=points.device)]
    at_x, at_mean = simplex_flips(lyap, tri, idx, mean)
    return ["x in another simplex" if x
            else "mean next state in another simplex" if m else None
            for x, m in zip(at_x, at_mean)]


def rescore64(lyap, xu):
    """The float64 host re-score of a chosen pair: ``v(mu) + sum_j |L_v_j|
    sigma_j - (c_max - margin)`` with the model lifted to float64, and
    whether the grid index of that ``mu`` is in the safe set."""
    from safe_learning_tpu_torch.explore import _margin_of

    dyn64 = st.oracle.lift64(lyap.dynamics)
    v64 = st.oracle.lift64(lyap.lyapunov_function)
    lv64 = st.oracle.lift64(lyap._lipschitz_lyapunov)
    level = lyap.c_max - _margin_of(lyap)
    with st.oracle._oracle_env():
        mean, std = dyn64(torch.as_tensor(xu, dtype=torch.float64))
        score = (v64(mean).reshape(-1) + (lv64(mean).abs() * std).sum(1)
                 - level)
        idx = int(lyap.discretization.state_to_index(mean)[0])
    return float(score[0]), bool(lyap.safe_set[idx])


def bound_tolerance(lyap, xu):
    """Computed error bound of the summed predictive error at pair ``xu``
    between kernel 3 and its plain twin: ``program_bounds`` on ``var``,
    through ``beta sqrt(kdiag - var / s2)``, plus a few roundings of the
    square roots and the sum."""
    gp = lyap.dynamics
    q = st.functions.base.as_tensor(np.asarray(xu))
    programs, params = gp._programs()
    s2 = gp.scale ** 2
    unit = torch.finfo(q.dtype).eps / 2
    _, tol_var = program_bounds(
        q, gp.X_buf, gp_kernel.program_params(params, q), gp.chol_inv,
        gp.alpha, gp._mask(), s2, programs, unit)
    with plain_stacked_predict():
        _, var = gp.predict(q)
    betas = torch.as_tensor(gp.betas, dtype=torch.float64)
    var, tol_var = var.double().cpu()[0], tol_var.cpu()[0]
    bound = float((betas * var.sqrt()).sum())
    return float((betas * tol_var / s2 / var.sqrt()).sum()) \
        + 8 * unit * bound


def explore_step(lyap, inst, rng, step):
    """One round of the loop, checked. The pair chosen with kernel 3 is
    held against the pair its plain twin chooses from the same RNG state
    (equal, or summed predictive errors within the computed bound), a
    pair not from the fallback must re-score below the level in float64,
    and then the true pendulum is measured there and appended. Returns
    ``(xu, fallback)``."""
    twin_rng = copy.deepcopy(rng)
    before = read_launches()["gp_predict_stacked"]
    with plain_stacked_predict():
        xu_p, bound_p, fallback_p = safe_sample(lyap, inst, twin_rng)
    if read_launches()["gp_predict_stacked"] != before:
        raise AssertionError("the plain twin's step launched kernel 3")
    xu, bound, fallback = safe_sample(lyap, inst, rng)
    launched = read_launches()["gp_predict_stacked"] - before
    if launched != (2 if fallback else 1):
        raise AssertionError("step {} launched kernel 3 {} times".format(
            step, launched))
    score64, in_set = rescore64(lyap, xu)
    same = np.array_equal(xu, xu_p) and fallback == fallback_p
    tol = 0.0 if same else (bound_tolerance(lyap, xu)
                            + bound_tolerance(lyap, xu_p))
    count = lyap.dynamics.count
    measure_and_append(lyap, inst, xu)
    print("step {}: xu={} bound={!r} fallback={} f64 re-score {!r} "
          "mean's grid index in the safe set: {}; plain twin: {} "
          "bound={!r}{}".format(
              step + 1, xu[0].tolist(), bound, fallback, score64, in_set,
              "the same pair" if same else xu_p[0].tolist(), bound_p,
              "" if same else " (|difference| {!r} <= bound {!r}?)".format(
                  abs(bound - bound_p), tol)))
    if not fallback and not score64 < 0.0:
        raise AssertionError("step {}: the chosen pair does not re-score "
                             "safe in float64".format(step + 1))
    if not same and not abs(bound - bound_p) <= tol:
        raise AssertionError("step {}: kernel and plain twin chose pairs "
                             "whose bounds differ beyond the computed "
                             "bound".format(step + 1))
    if lyap.dynamics.count != count + 1:
        raise AssertionError("the append did not add one row")
    return xu, fallback


def append_check(gp):
    """The bordered-append host factors of every output against a fresh
    float64 factorization of the same data; returns the worst relative
    difference (``max |a - b| / max |b|`` over chol, chol_inv, alpha)."""
    from safe_learning_tpu_torch.functions.gp import _host_factorize

    x_buf = gp.X_buf.cpu().numpy()
    y_buf = gp.Y_buf.cpu().numpy()
    noises = gp.noise_variances.cpu().double().numpy()
    worst = 0.0
    for s, host in enumerate(gp._host_caches):
        fresh = _host_factorize(gp.kernels[s], x_buf, y_buf[:, s:s + 1],
                                gp.mean_functions[s], gp.count,
                                float(noises[s]), gp.scale)
        if host.fresh or host.count != fresh.count:
            raise AssertionError("output {}: the host factors are not a "
                                 "bordered append of {} rows".format(
                                     s, gp.count))
        for got, want in ((host.chol, fresh.chol),
                          (host.chol_inv, fresh.chol_inv),
                          (host.alpha, fresh.alpha)):
            worst = max(worst, float(np.abs(got - want).max()
                                     / np.abs(want).max()))
    return worst


def stacked_inputs(lyap, points=None):
    """Kernel 3's inputs at the sweep's own states: ``points`` (default:
    the grid) and the policy's actions there."""
    points = lyap._device_points() if points is None else points
    return gp_inputs(lyap.dynamics,
                     concatenate_inputs(points, lyap.policy(points)))


def gp_inputs(gp, states):
    """Kernel 3's inputs for the stacked GP ``gp`` at state-action rows
    ``states``, and its programs."""
    programs, params = gp._programs()
    # On the device, for the CUDA graph that times the kernel.
    s2 = torch.tensor(gp.scale ** 2, dtype=states.dtype,
                      device=states.device)
    return (states, gp.X_buf, gp_kernel.program_params(params, states),
            gp.chol_inv, gp.alpha[:, :, 0].contiguous(), gp._mask(),
            s2), programs


def phase_safe_learning(card, steps=10, seed=0):
    """The inverted pendulum's safe-learning loop at full width.

    ``build_safe_learning_instance(seed)``: certify (``update_safe_set``
    and ``oracle_gate``, with simplex jumps as the causes it accepts),
    then ``steps`` rounds of ``get_safe_sample``, a measurement of the
    true pendulum and ``StackedGaussianProcess.add_data_point``
    (``explore_step``), then the appends' checks (the bordered factors
    against a fresh factorization within 1e-9 relative, kernel 3 on the
    grid against its plain twin within ``program_bounds``, no library
    built), then re-certify with ``update_values``, ``update_safe_set``
    and the same gate. The counters are set to 0 before each sweep and
    before the steps: each sweep launches kernel 3 once, each step once
    (twice with the backup policy's fallback), and no other kernel runs.
    Then times, on CUDA events beside the card: the sweep, one
    ``get_safe_sample`` and one ``add_data_point`` (``loop_step_times``).
    Returns ``(lyap, inst, launches, max_abs_err, peak)``, ``launches``
    of kernel 3 counting the two sweeps and the steps, ``max_abs_err`` its
    error against the plain twin on the sweep's inputs, ``peak`` the bytes
    a sweep allocates at its peak (``sweep_peak_bytes``).
    """
    builds = dict(build_reports)
    start = time.perf_counter()
    lyap, inst = build_safe_learning_instance(seed)
    tri = inst["value_function"]
    print("safe learning: {} grid points, policy grid {}, NN {}, tau {!r}, "
          "L_f {!r}, GP capacity {} with {} points, {} exempt initial "
          "points; built in {:.3f} s".format(
              lyap.discretization.nindex, tri.discretization.shape,
              lyap.policy.layers, inst["tau"], inst["lf"],
              lyap.dynamics.capacity, lyap.dynamics.count,
              int(inst["initial"].sum()), time.perf_counter() - start))
    explain = functools.partial(flip_causes, lyap, tri)
    sweeps = {}
    reset_launches()
    lyap.update_safe_set()
    sweeps["certify"] = read_launches()
    flips = simplex_flips(lyap, tri, np.arange(lyap.discretization.nindex))
    print("safe learning: the working dtype locates {} grid points in "
          "another simplex of the value function than float64 does".format(
              int(flips[0].sum())))
    oracle_gate(lyap, "certify", explain=explain)

    rng = np.random.default_rng(seed)
    fallbacks = 0
    reset_launches()
    for step in range(steps):
        fallbacks += explore_step(lyap, inst, rng, step)[1]
    explored = read_launches()
    gp = lyap.dynamics
    worst = append_check(gp)
    print("appends: {} points at capacity {}; bordered factors against a "
          "fresh f64 factorization: worst relative difference {!r} "
          "(tolerance 1e-9); {} of {} steps used the backup policy".format(
              gp.count, gp.capacity, worst, fallbacks, steps))
    if not worst <= 1e-9:
        raise AssertionError("the bordered append drifted from a fresh "
                             "factorization")

    reset_launches()
    lyap.update_values()
    lyap.update_safe_set()
    sweeps["re-certify"] = read_launches()
    oracle_gate(lyap, "re-certify", explain=explain)
    print("kernel launches on the safe-learning path: certify sweep {}, "
          "{} steps {}, re-certify sweep {}".format(
              sweeps["certify"], steps, explored, sweeps["re-certify"]))
    expected = {name: 0 for name in KERNELS}
    for name, got in sweeps.items():
        if got != dict(expected, gp_predict_stacked=1):
            raise AssertionError("the {} sweep launched {}, not kernel 3 "
                                 "once".format(name, got))
    if explored != dict(expected, gp_predict_stacked=steps + fallbacks):
        raise AssertionError("the {} steps launched {}".format(steps,
                                                               explored))
    if dict(build_reports) != builds:
        raise AssertionError("the safe-learning path built a library")
    print("libraries built during the safe-learning path: 0")

    inputs, programs = stacked_inputs(lyap)
    em, ev, ratio = compare_program("stacked", inputs, programs,
                                    count=gp.count)
    shape = "Q={}, cap {}, count {}, S={}".format(
        inputs[0].shape[0], gp.capacity, gp.count, len(programs))
    print("safe-learning inputs ({}): max|dmean|={:.3e} max|dvar|={:.3e} "
          "err/bound={:.3f}".format(shape, em, ev, ratio))
    if not ratio <= 1.0:
        raise AssertionError("kernel 3 disagrees on the safe-learning "
                             "inputs")
    peak = sweep_peak_bytes(lyap)
    print("safe-learning sweep: {} bytes allocated at its peak beyond those "
          "held before it".format(peak))
    time_sweep("safe-learning", lyap, card)
    loop_step_times(card, lyap, inst, "before the count cases and the "
                    "CUDA graphs")
    return lyap, inst, 2 + explored["gp_predict_stacked"], max(em, ev), peak


def sweep_peak_bytes(lyap):
    """Device memory one ``update_safe_set`` allocates at its peak beyond
    what was allocated before it (``torch.cuda.max_memory_allocated``
    after ``reset_peak_memory_stats``)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    lyap.update_safe_set()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def loop_step_times(card, lyap, inst, when):
    """One ``get_safe_sample`` and one ``add_data_point`` at the loop's
    last state, CUDA events around the host call, median of 10. Both are
    host-bound, so ``main`` takes them twice: before the count cases and
    the CUDA graphs of the kernel timings, and after them, which shows
    how far the process's history moves them."""
    sample_ms = cuda_ms(lambda: safe_sample(
        lyap, inst, np.random.default_rng(1)))
    xu = safe_sample(lyap, inst, np.random.default_rng(1))[0]
    y = inst["true"](xu[:, :2], xu[:, 2:]).cpu().numpy()
    append_ms = cuda_ms(lambda: lyap.dynamics.add_data_point(xu, y))
    print("get_safe_sample ({} candidates), {}: {!r} ms; add_data_point "
          "at count {}: {!r} ms [{}]".format(
              EXPLORATION_SAMPLES * len(ACTION_VARIATION), when, sample_ms,
              lyap.dynamics.count, append_ms, card))


def safe_learning_times(card, lyap, points=None, label="safe learning"):
    """Kernel 3 against its plain twin on a sweep's inputs (``points``, by
    default the grid): ``(kernel_ms, plain_ms, eager_ms, bound_ms,
    bound_by, bound_kind, library_ms)``."""
    inputs, programs = stacked_inputs(lyap, points)
    gp = lyap.dynamics
    states = inputs[0]
    kernel_ms, plain_ms, eager_ms = time_against_plain(
        "gp predict stacked ({})".format(label),
        lambda: gp_kernel.gp_predict_stacked_cuda(*inputs, programs,
                                                  count=gp.count),
        lambda: gp_kernel.gp_predict_stacked_plain(*inputs, programs),
        card, "Q={}, cap {}, count {}, S={}".format(
            states.shape[0], gp.capacity, gp.count, len(programs)))
    return (kernel_ms, plain_ms, eager_ms) + kernel_bound(
        states.shape[0], states.shape[1], gp.count, 1, len(programs),
        program_ops(programs), states.element_size()) + (
            product_ms(inputs, programs, gp.count),)


# ---------------------------------------------------------------------------
# Training: the example's policy iteration at its --full width
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def uncounted():
    """Launches inside the block (the checks' comparisons) do not count:
    every kernel's counter is restored at its end."""
    saved = read_launches()
    try:
        yield
    finally:
        for name, (wrapper, _, _) in KERNELS.items():
            wrapper.launches = saved[name]


@contextlib.contextmanager
def kernel_route(use_kernels, dtype=None):
    """``config.use_kernels`` (and the working dtype) for the block."""
    old = st.config.use_kernels, st.config.dtype
    st.config.use_kernels = use_kernels
    st.config.dtype = old[1] if dtype is None else dtype
    try:
        yield
    finally:
        st.config.use_kernels, st.config.dtype = old


def _on_device(value, device):
    """A copy of a function, kernel or container with every tensor moved
    to ``device``; other attributes are shared."""
    if torch.is_tensor(value):
        return value.to(device)
    if isinstance(value, (tuple, list)):
        return type(value)(_on_device(v, device) for v in value)
    if isinstance(value, (st.Function, st.functions.gp.Kernel)):
        new = copy.copy(value)
        for name, attr in vars(value).items():
            setattr(new, name, _on_device(attr, device))
        return new
    return value


def float64_copy(fn):
    """Float64 copy of a function on ``config.device``: ``oracle.lift64``
    (GPs rebuilt from their data), then moved."""
    return _on_device(st.oracle.lift64(fn), st.config.device)


def ascent_pieces(trainer, dtype):
    """``(policy, dynamics, reward, value_function, lyapunov pieces)`` of
    the trainer's penalised ascent in ``dtype``: the working objects, or
    their ``float64_copy``."""
    rl, lyap = trainer.rl, trainer.lyap
    if dtype == st.config.dtype:
        return (rl.policy, rl.dynamics, rl.reward_function,
                rl.value_function, (lyap.lyapunov_function,
                                    lyap._lipschitz_lyapunov,
                                    lyap._lipschitz_dynamics, lyap.tau, 1.0))
    vf = float64_copy(rl.value_function)
    return (float64_copy(rl.policy), float64_copy(rl.dynamics),
            float64_copy(rl.reward_function), vf,
            (-vf, st.GradientNorm(vf, ord=np.inf), lyap._lipschitz_dynamics,
             lyap.tau, 1.0))


def ascent_route(pieces, states, penalty, use_kernels, keep=None):
    """One ascent step's pieces by one GP route, as ``rl._policy_ascent``
    takes it: the per-sample future values (and, with ``penalty``, the
    unpenalised ones), the loss ``-mean`` (over the rows ``keep`` only,
    when given, divided by all rows), its gradient with respect to every
    policy weight, and the GP's mean and error at the rows."""
    from safe_learning_tpu_torch.rl import (_future_values_core,
                                            _future_values_lyapunov)
    from safe_learning_tpu_torch.utils import _tree_leaves, _tree_map

    policy, dynamics, reward, vf, lyap = pieces
    with kernel_route(use_kernels, states.dtype):
        leaves = _tree_map(lambda w: w.detach().requires_grad_(True),
                           policy.parameters_dict)
        pol = policy.with_parameters(leaves)
        fv = (_future_values_lyapunov(pol, dynamics, reward, vf, GAMMA,
                                      states, None, *lyap) if penalty
              else _future_values_core(pol, dynamics, reward, vf, GAMMA,
                                       states, None))
        weight = (torch.ones_like(fv) if keep is None
                  else keep.to(fv.dtype).reshape(-1, 1))
        loss = -(fv * weight).sum() / fv.shape[0]
        grads = torch.autograd.grad(loss, _tree_leaves(leaves))
        with torch.no_grad():
            actions = policy(states)
            mean, err = dynamics(states, actions)
            core = _future_values_core(policy, dynamics, reward, vf, GAMMA,
                                       states, actions)
    return dict(fv=fv.detach(), core=core, loss=loss.detach(), grads=grads,
                mean=mean, err=err, actions=actions)


def _relative(a, b):
    """``max |a - b| / max |b|`` over a tuple of tensors."""
    return (max(float((x - y).abs().max()) for x, y in zip(a, b))
            / max(float(y.abs().max()) for y in b))


def future_value_bounds(pieces, states, plain, penalty):
    """Per-sample bound on ``|kernel route - plain route|`` of the future
    values in the working dtype, where both routes locate the next state
    in the same simplex of the value function ``v``.

    The GP means differ by ``program_bounds``' ``tol_mean / scale`` plus
    two roundings of the mean; ``v`` at the next state then by its local
    gradient norm ``G`` (the same in both routes) times the L1 difference,
    plus ``16 u max|v|`` for each route's interpolation rounding. With
    the penalty, the errors ``beta sqrt(var)`` differ by ``beta (dvar /
    sqrt(var) + 2 u sqrt(var))``, ``dvar`` from ``tol_var / s2`` and
    the roundings of the division and subtraction, times ``G``; and the
    penalty's sums round ``4 u`` of their terms. The reward and every term
    at the state itself are the same in both routes.
    """
    policy, gp, _, vf, _ = pieces
    unit = torch.finfo(states.dtype).eps / 2
    q = concatenate_inputs(states, plain["actions"])
    programs, params = gp._programs()
    s2 = gp.scale ** 2
    tol_mean, tol_var = program_bounds(
        q, gp.X_buf, gp_kernel.program_params(params, q), gp.chol_inv,
        gp.alpha, gp._mask(), s2, programs, unit)
    mean = plain["mean"].double()
    dm = (tol_mean / gp.scale + 2 * unit * mean.abs()).sum(dim=1)
    g = st.GradientNorm(vf, ord=np.inf)(plain["mean"]).double().reshape(-1)
    vmax = float(vf.parameters.abs().max())
    dv = g * dm + 16 * unit * vmax
    bound = GAMMA * dv + 2 * unit * plain["core"].double().abs().reshape(-1)
    if not penalty:
        return bound
    betas = torch.as_tensor(gp.betas, dtype=torch.float64,
                            device=states.device)
    var = (plain["err"].double() / betas) ** 2
    kdiag = torch.stack([k.diag(q) for k in gp.kernels], dim=1).double()
    dvar = tol_var / s2 + 2 * unit * (kdiag + var)
    derr = betas * (dvar / var.sqrt() + 2 * unit * var.sqrt())
    constraint = (plain["core"] - plain["fv"]).double().abs().reshape(-1)
    return (bound + dv + g * derr.sum(dim=1)
            + 4 * unit * (constraint + 2 * vmax)
            + 2 * unit * plain["fv"].double().abs().reshape(-1))


def gradient_check(trainer, states, label):
    """Check 2 of the training phase, on one minibatch: the kernel route
    against the plain route, with and without the Lyapunov penalty.

    In float64 on the card (``float64_copy`` of every piece, kernel 3's
    float64 instantiation): the loss within 1e-12 relative and the
    gradient within 1e-9 relative (of its largest entry). In float32: the
    per-sample future values within ``future_value_bounds``, except the
    samples whose next state the two routes locate in different simplices
    of the value function (excluded and counted), and the gradient of the
    loss over the rest within 1e-4 relative.
    """
    for penalty in (False, True):
        with uncounted():
            pieces = ascent_pieces(trainer, torch.float64)
            k64, p64 = (ascent_route(pieces, states.double(), penalty, route)
                        for route in (True, False))
            loss_rel = float((k64["loss"] - p64["loss"]).abs()
                             / p64["loss"].abs())
            grad_rel = _relative(k64["grads"], p64["grads"])
            pieces = ascent_pieces(trainer, st.config.dtype)
            k32, p32 = (ascent_route(pieces, states, penalty, route)
                        for route in (True, False))
            vf = pieces[3]
            flips = vf.find_simplex(k32["mean"]) != vf.find_simplex(
                p32["mean"])
            keep = ~flips
            bound = future_value_bounds(pieces, states, p32, penalty)
            diff = (k32["fv"] - p32["fv"]).double().abs().reshape(-1)
            ratio = float((diff[keep] / bound[keep]).max())
            k32, p32 = (ascent_route(pieces, states, penalty, route, keep)
                        for route in (True, False))
            grad32 = _relative(k32["grads"], p32["grads"])
        print("training gradient check, {}, {}penalty, GP count {}: float64 "
              "loss rel. diff {!r} (<= 1e-12), gradient rel. diff {!r} "
              "(<= 1e-9); float32: {} of {} samples change simplex "
              "(excluded), future values at {!r} of the bound, gradient "
              "rel. diff {!r} (<= 1e-4)".format(
                  label, "" if penalty else "no ", trainer.rl.dynamics.count,
                  loss_rel, grad_rel, int(flips.sum()), len(flips), ratio,
                  grad32))
        if not (loss_rel <= 1e-12 and grad_rel <= 1e-9 and ratio <= 1.0
                and grad32 <= 1e-4):
            raise AssertionError("the gradient through kernel 3's autograd "
                                 "rule differs from the plain route's")


def check_fixed_point(trainer, tol=1e-5):
    """Check 3: the last value solve is a fixed point. On the host in
    float64, with ``B`` from ``Triangulation.parameter_derivative`` at the
    solve's next states: ``max|v - r - gamma B v| / max(1, max|v|) <= 2
    tol``. Returns ``(iterations, residual)``."""
    rl = trainer.rl
    with uncounted(), torch.no_grad():
        actions = rl.policy(rl.state_space)
        nxt = rl.dynamics(rl.state_space, actions)[0]
        r = rl.reward_function(rl.state_space, actions).reshape(-1)
    b = rl.value_function.parameter_derivative(nxt).tocsr()
    v = rl.value_function.parameters[:, 0].double().cpu().numpy()
    r = r.double().cpu().numpy()
    residual = (np.abs(v - r - rl.gamma * (b @ v)).max()
                / max(1.0, np.abs(v).max()))
    iterations, delta = rl._last_solve
    if not residual <= 2 * tol:
        raise AssertionError("the value solve is not a fixed point: "
                             "residual {!r}".format(residual))
    return iterations, delta, residual


class EventTimer:
    """CUDA events around host calls: ``wrap(fn)`` records each call's
    milliseconds in ``times``."""

    def __init__(self):
        self.times = []

    def wrap(self, fn):
        def timed(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            end.synchronize()
            self.times.append((start.elapsed_time(end), kwargs))
            return out
        return timed


def phase_training(card, sweep_peak):
    """The example's training at its ``--full`` width (``SafeTraining``:
    2001x1501 safety grid, 55x55 policy grid, the ``[2, 32, 32, 1]`` MLP,
    batches of 1000, the stacked GP at capacity 64): pretraining, two
    rounds of ``optimize``, certify, then ``OUTER_ITERS`` iterations of
    ``DATA_PER_ITER`` exploration steps, ``optimize`` and certify; then
    the closed loop from ``x0 = (1, -0.5)``.

    Checks, each raising: (1) every stage launches kernel 3 exactly once
    per ascent step, value solve, certify sweep and exploration step
    (twice with the backup fallback), no other kernel, and no library is
    built; (2) ``gradient_check`` at the first penalised step's minibatch
    (GP count 0) and at that of the last iteration; (3)
    ``check_fixed_point`` after every value solve, and
    ``optimize_value_function(max_iter=1)`` raises ``OptimizationError``;
    (4) the trained policy's tensors are detached and a certify sweep's
    peak memory is within 10 % of ``sweep_peak`` (phase 8's); (5) the last
    certify passes ``oracle_gate``, simplex jumps the accepted causes;
    (6) the example's assertion, the true pendulum from ``(1, -0.5)``
    below a state norm of 0.5 within 100 steps. Reported: the rewards of
    the old and new policy, the safe fraction and ``c_max`` after each
    certify, and ``compute_roa`` of the trained closed loop on the safety
    grid. Times: each ascent's per-step ms, each value solve's ms and
    iterations, the example's stages (wall), the trained sweep, a
    ``get_safe_sample`` and an ``add_data_point``, ``compute_roa``.

    Returns ``(trainer, launches, minibatch)``: kernel 3's launches over
    the whole run and the last checked minibatch (for the kernel's
    timing).
    """
    from safe_learning_tpu_torch.utils import _tree_leaves

    if (torch.backends.cuda.matmul.allow_tf32
            or torch.backends.cudnn.allow_tf32):
        raise AssertionError("TF32 is on")
    builds = dict(build_reports)
    start = time.perf_counter()
    trainer = SafeTraining(seed=0)
    rl, lyap, inst = trainer.rl, trainer.lyap, trainer.inst
    print("training: {} grid points, policy grid {}, NN {}, batch {}, GP "
          "capacity {}; pretrain {} steps, 2 + {} rounds of {} penalised "
          "steps, {} exploration steps a round; built in {:.3f} s".format(
              lyap.discretization.nindex,
              rl.value_function.discretization.shape, lyap.policy.layers,
              trainer.batch_size, lyap.dynamics.capacity, PRETRAIN_ITERS,
              OUTER_ITERS, POLICY_ITERS, DATA_PER_ITER,
              time.perf_counter() - start))
    ascents, solves = EventTimer(), EventTimer()
    rl.optimize_policy = ascents.wrap(rl.optimize_policy)
    rl.optimize_value_function = solves.wrap(rl.optimize_value_function)
    checked = {}
    fixed_points = []
    # Seconds the checks take inside a stage; its wall time less these is
    # what the example's Timer reads.
    in_checks = [0.0]

    def before_ascent(tr):
        torch.cuda.synchronize()
        begin = time.perf_counter()
        fixed_points.append(check_fixed_point(tr))
        # The first penalised ascent, and the last iteration's.
        label = {1: "first penalised step",
                 2 + OUTER_ITERS: "last iteration's first step"}.get(
                     len(fixed_points))
        if label is not None:
            twin = torch.Generator(device=st.config.device)
            twin.set_state(tr.generator.get_state())
            space = tr.lyap.discretization.limits
            states = rl._draw_minibatch(
                twin, tr.batch_size, st.functions.base.as_tensor(space[:, 0]),
                st.functions.base.as_tensor(space[:, 1]))
            gradient_check(tr, states, label)
            checked["minibatch"] = states
        torch.cuda.synchronize()
        in_checks[0] += time.perf_counter() - begin

    trainer.before_ascent = before_ascent
    expected = {name: 0 for name in KERNELS}
    total = [0]
    walls = []

    def stage(name, fn, launches):
        reset_launches()
        in_checks[0] = 0.0
        torch.cuda.synchronize()
        begin = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - begin - in_checks[0]
        walls.append(wall)
        got = read_launches()
        want = dict(expected, gp_predict_stacked=launches(out))
        print("{}: {!r} s wall, {!r} s of checks excluded; launches {} "
              "(expected {})".format(name, wall, in_checks[0], got, want))
        if got != want:
            raise AssertionError("{} launched {}, not {}".format(name, got,
                                                                 want))
        total[0] += got["gp_predict_stacked"]
        return out

    def certified(label):
        print("training: after {}: safe fraction {!r}, c_max {!r}".format(
            label, float(lyap.safe_set.mean()), lyap.c_max))

    losses = stage("pretrain policy on mean dynamics",
                   lambda: trainer.pretrain(PRETRAIN_ITERS),
                   lambda out: PRETRAIN_ITERS)
    print("pretrain losses: first {!r}, last {!r}".format(losses[0],
                                                          losses[-1]))
    stage("initial certify", lambda: lyap.update_safe_set(),
          lambda out: 1)
    certified("pretraining")

    def initial():
        trainer.optimize(POLICY_ITERS)
        trainer.optimize(POLICY_ITERS)
        trainer.certify()

    stage("initial safe policy optimization", initial,
          lambda out: 2 * (1 + POLICY_ITERS) + 1)
    certified("the initial policy optimization")
    for it in range(OUTER_ITERS):
        def iteration():
            fallbacks = sum(trainer.update_gp()[1]
                            for _ in range(DATA_PER_ITER))
            trainer.optimize(POLICY_ITERS)
            trainer.certify()
            return fallbacks

        stage("iteration {}".format(it + 1), iteration,
              lambda fallbacks: DATA_PER_ITER + fallbacks + POLICY_ITERS + 2)
        certified("iteration {} (GP count {})".format(it + 1,
                                                      lyap.dynamics.count))
    print("time to a trained, certified policy: {!r} s, the sum of the "
          "stages' wall times [{}]".format(sum(walls), card))
    if dict(build_reports) != builds:
        raise AssertionError("the training phase built a library")
    print("libraries built during the training phase: 0")

    for ms, kwargs in ascents.times:
        steps = kwargs["steps"]
        print("ascent of {} steps ({}): {!r} ms, {!r} ms a step [{}]".format(
            steps, "penalised" if kwargs.get("lyapunov") else "pretraining",
            ms, ms / steps, card))
    for (ms, _), (iters, delta, residual) in zip(solves.times, fixed_points):
        print("value solve: {!r} ms, {} iterations, delta {!r}, float64 "
              "residual {!r} (<= 2e-5) [{}]".format(ms, iters, delta,
                                                    residual, card))
    with uncounted():
        try:
            rl.optimize_value_function(max_iter=1)
        except st.OptimizationError as exc:
            print("optimize_value_function(max_iter=1) raised "
                  "OptimizationError: {}".format(exc))
        else:
            raise AssertionError("a one-iteration value solve converged")

    leaves = _tree_leaves(rl.policy.parameters_dict)
    if any(t.requires_grad or t.grad_fn is not None for t in leaves):
        raise AssertionError("the trained policy holds autograd state")
    peak = sweep_peak_bytes(lyap)
    print("trained sweep: {} bytes at its peak, phase 8's {}; the policy's "
          "{} tensors are detached".format(peak, sweep_peak, len(leaves)))
    if not abs(peak - sweep_peak) <= 0.1 * sweep_peak:
        raise AssertionError("the trained sweep's peak memory differs by "
                             "more than 10 %")

    tri = rl.value_function
    oracle_gate(lyap, "trained certify",
                explain=functools.partial(flip_causes, lyap, tri))

    x0 = np.array([[1.0, -0.5]])
    true = inst["true"]
    with torch.no_grad():
        states_new, actions_new = st.utils.compute_trajectory(
            true, rl.policy, x0, 100)
        init = st.Saturation(st.LinearSystem(-st.utils.dlqr(
            inst["a"], inst["b"], np.diag([1.0, 2.0]),
            1.2 * np.ones((1, 1)))[0]), -1.0, 1.0)
        states_old, actions_old = st.utils.compute_trajectory(
            true, init, x0, 100)
        rewards = [float(trainer.reward(s[:-1], a).sum())
                   for s, a in ((states_old, actions_old),
                                (states_new, actions_new))]
    final_norm = float(torch.linalg.norm(states_new[-1]))
    print("reward old: {!r}  reward new: {!r}; final state norm (new "
          "policy): {!r}".format(rewards[0], rewards[1], final_norm))
    if not final_norm < 0.5:
        raise AssertionError("the learned policy does not stabilize the "
                             "pendulum")

    horizon = 1000
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with torch.no_grad():
        start.record()
        roa = st.compute_roa(lyap.discretization,
                             lambda x: true(x, rl.policy(x)),
                             horizon=horizon, tol=0.01)
        end.record()
        end.synchronize()
    safe = np.array(lyap.safe_set)
    print("compute_roa of the trained closed loop on the true pendulum: {} "
          "of {} grid points reach |x| <= 0.01 within {} steps ({} s of "
          "simulated time); {} of the {} certified points lie in it; {!r} "
          "ms [{}]".format(int(roa.sum()), roa.size, horizon,
                           horizon * true.dt, int((roa & safe).sum()),
                           int(safe.sum()), start.elapsed_time(end), card))
    time_sweep("trained safe-learning", lyap, card)
    loop_step_times(card, lyap, inst, "after training")
    return trainer, total[0], checked["minibatch"]


def training_times(card, trainer, minibatch):
    """Kernel 3 against its plain twin at an ascent step's inputs (the
    checked minibatch and the trained policy's actions, the final GP):
    ``(max_abs_err, kernel_ms, plain_ms, eager_ms, bound_ms, bound_by,
    bound_kind, library_ms)``."""
    gp = trainer.rl.dynamics
    with torch.no_grad():
        states = concatenate_inputs(minibatch,
                                    trainer.rl.policy(minibatch))
    programs, params = gp._programs()
    s2 = torch.tensor(gp.scale ** 2, dtype=states.dtype,
                      device=states.device)
    inputs = (states, gp.X_buf, gp_kernel.program_params(params, states),
              gp.chol_inv, gp.alpha[:, :, 0].contiguous(), gp._mask(), s2)
    em, ev, ratio = compare_program("stacked", inputs, programs,
                                    count=gp.count)
    shape = "Q={}, cap {}, count {}, S={}".format(
        states.shape[0], gp.capacity, gp.count, len(programs))
    print("training inputs ({}): max|dmean|={:.3e} max|dvar|={:.3e} "
          "err/bound={:.3f}".format(shape, em, ev, ratio))
    if not ratio <= 1.0:
        raise AssertionError("kernel 3 disagrees on the training inputs")
    times = time_against_plain(
        "gp predict stacked (training)",
        lambda: gp_kernel.gp_predict_stacked_cuda(*inputs, programs,
                                                  count=gp.count),
        lambda: gp_kernel.gp_predict_stacked_plain(*inputs, programs),
        card, shape)
    return (max(em, ev),) + times + kernel_bound(
        states.shape[0], states.shape[1], gp.count, 1, len(programs),
        program_ops(programs), states.element_size()) + (
            product_ms(inputs, programs, gp.count),)


def profile_training(card, trainer, penalised, steps=20):
    """``profile_window`` over ``steps`` ascent steps, penalised (learning
    rate 0.01, minibatches from the safety grid) or as in pretraining (0.1,
    the policy grid, no penalty), on a copy of the trainer's
    ``PolicyIteration`` with its generator cloned."""
    rl = copy.copy(trainer.rl)
    lyap = trainer.lyap
    twin = torch.Generator(device=st.config.device)
    twin.set_state(trainer.generator.get_state())
    if penalised:
        kwargs = dict(learning_rate=0.01, lyapunov=lyap,
                      lagrange_multiplier=1.0,
                      sample_space=lyap.discretization)
    else:
        kwargs = dict(learning_rate=0.1,
                      sample_space=rl.value_function.discretization)

    def run():
        # The class's method: the instance's own is wrapped by a timer.
        st.PolicyIteration.optimize_policy(
            rl, steps=steps, batch_size=trainer.batch_size, generator=twin,
            **kwargs)

    label = "{} ascent step".format("penalised" if penalised
                                    else "pretraining")
    groups = profile_window(label, run, steps, card)
    # The host may wait for the device around an ascent (its box's limits
    # to the card, its losses back), never inside the step loop: every
    # synchronising call of one run is counted, by caller.
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = collections.Counter(
        "{}:{}".format(w.filename, w.lineno) for w in caught
        if "synchronizing" in str(w.message))
    print("{}: {} synchronising calls in {} steps, by caller: {}".format(
        label, sum(syncs.values()), steps, dict(syncs)))
    if sum(syncs.values()) >= steps:
        raise AssertionError("the host waits for the device inside the "
                             "ascent's step loop")
    return groups


# ---------------------------------------------------------------------------
# The adaptive example: refined certifies and k-step exploration
# ---------------------------------------------------------------------------
#: Rescued states whose full sub-grids the float64 oracle checks when a
#: certify rescued more (a seeded sample), besides every rescued state
#: whose float32 refined margin lies within ``NEAR_BAND`` calibrated
#: margins of failing.
ORACLE_RESCUE_SAMPLE, NEAR_BAND = 4096, 10.0

#: Largest difference, on the mean and on ``beta * std``, between the GP
#: the sampler advanced on the device and the float64-refreshed GP at a
#: batch's chosen pairs, as a share of the smallest summed predictive
#: error the batch chose by: the device GP only ranks candidates. The
#: float32 append's error in ``std`` is the cancellation in ``kdiag -
#: |L^-1 k|^2`` (a variance 1e-4 to 1e-3 of ``kdiag`` at the chosen
#: pairs) over ``2 std``; a first run on the H100 differed by at most
#: 3.6e-6 against errors of 2.3e-3 and more, a share of 1.6e-3.
APPEND_SHARE = 0.01


@contextlib.contextmanager
def patched(module, name, wrap):
    """``module.name`` replaced by ``wrap(module.name)`` for the block."""
    inner = getattr(module, name)
    setattr(module, name, wrap(inner))
    try:
        yield
    finally:
        setattr(module, name, inner)


def no_host_waits(fn):
    """``fn`` under ``torch.cuda.set_sync_debug_mode("error")``: any call
    in it that makes the host wait for the device raises."""
    @functools.wraps(fn)
    def strict(*args, **kwargs):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return fn(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return strict


def recorded(log, keep=lambda args, out: out):
    """A wrapper that appends ``keep(args, out)`` of each call to ``log``."""
    def wrap(fn):
        @functools.wraps(fn)
        def record(*args, **kwargs):
            out = fn(*args, **kwargs)
            log.append(keep(args, out))
            return out
        return record
    return wrap


@contextlib.contextmanager
def kernel3_calls(log):
    """Every kernel-3 launch in the block appended to ``log`` as the
    arguments of its ``_launch_program`` call (``programs, points, x,
    params, chol_inv, alpha, mask, s2, count, mean_num, var_num``). The
    wrapper, and so its launch counter, is untouched."""
    def wrap(fn):
        @functools.wraps(fn)
        def record(*args):
            log.append(args)
            return fn(*args)
        return record
    with patched(gp_kernel, "_launch_program", wrap):
        yield


def replayed_ms(calls, entry):
    """Device milliseconds of recorded kernel-3 launches replayed through
    the library's ``entry`` (``"gp_program"``: the body each launch takes;
    ``"gp_program_streamed"``: the streamed body), each the median of 3
    after a warm-up."""
    return sum(cuda_ms(lambda a=a: gp_kernel._launch_entry(entry, *a),
                       reps=3, warmup=1) for a in calls)


def sample_batch(lyap, inst, rng, apply=True, strict=True):
    """One update's ``get_safe_sample_batch`` with the example's settings
    (``examples/adaptive_safety_verification.py:176-178``, ``:207-210``),
    with ``strict`` its k device steps (``explore._sample_steps``) under
    ``no_host_waits``. Returns ``(result, gps)``: ``gps`` are the GPs the
    sampler advanced on the device, one a step."""
    gps = []
    with patched(explore_mod, "_sample_steps",
                 no_host_waits if strict else (lambda fn: fn)), \
            patched(explore_mod, "_device_border_append", recorded(gps)):
        out = st.get_safe_sample_batch(
            lyap, inst["measure"], ADAPTIVE_DATA, ADAPTIVE_VARIATION,
            ADAPTIVE_LIMITS, positive=True, num_samples=EXPLORATION_SAMPLES,
            rng=rng, apply=apply)
    return out, gps


def check_batch(update, lyap, gp0, got, gps, twin):
    """Checks 3 and 4 of ``phase_adaptive`` on one batch.

    The pairs chosen through kernel 3 against those its plain twin chose
    from the same rng (``twin``): equal, or at the first step where they
    differ (the trajectories part there, and the comparison stops),
    summed predictive errors within ``bound_tolerance`` at the GP both
    carried to that step, and the twin's preference for its own pair no
    larger than the two routes' difference at the two pairs
    (``pair_scores``). Then every device append's precondition
    (``chol_inv[:, n:, :n] == 0``, the rows past the count as the host
    factorization left them, ``mask[n:] == 0``), and the device-advanced
    GP against the float64-refreshed one at the chosen pairs within
    ``APPEND_SHARE``. Returns ``(steps that matched the twin, mean
    difference, error difference, share)``."""
    sas, _, bounds, safes = got
    tsas, _, tbounds, tsafes = twin
    matched = len(sas)
    for j in range(len(sas)):
        if np.array_equal(sas[j], tsas[j]) and safes[j] == tsafes[j]:
            continue
        gp_j = gps[j - 1] if j else gp0
        holder = types.SimpleNamespace(dynamics=gp_j)
        tol = (bound_tolerance(holder, sas[j:j + 1])
               + bound_tolerance(holder, tsas[j:j + 1]))
        diff = abs(float(bounds[j]) - float(tbounds[j]))
        # Both pairs scored by both routes as the sampler scores them: the
        # kernel's pick is its argmax, so where the twin's pick is safe
        # under the kernel too, the twin can prefer its own pick by no
        # more than the two routes differ at the two pairs.
        pairs = np.concatenate([sas[j:j + 1], tsas[j:j + 1]])
        k_err, k_safe = pair_scores(lyap, gp_j, pairs)
        with plain_stacked_predict():
            t_err, _ = pair_scores(lyap, gp_j, pairs)
        gap = float(t_err[1] - t_err[0])
        # Plus a few float32 spacings: the pairs are scored here in a
        # launch of 2 queries, in the batch among 2,000.
        rounding = float(np.abs(k_err - t_err).sum()
                         + 8 * np.finfo(np.float32).eps * t_err.max())
        print("update {} step {}: kernel 3 chose {} (bound {!r}), its plain "
              "twin {} (bound {!r}){}; |difference| {!r} <= computed bound "
              "{!r}?; the twin prefers its pair by {!r}, the routes differ "
              "by {!r} at the two pairs{}".format(
                  update, j + 1, sas[j].tolist(), float(bounds[j]),
                  tsas[j].tolist(), float(tbounds[j]),
                  ", the mirror image" if np.array_equal(sas[j], -tsas[j])
                  else "", diff, tol, gap, rounding,
                  "" if k_safe[1] else " (the twin's pair fails the level "
                  "test under kernel 3)"))
        if not diff <= tol or (k_safe[1] and not gap <= rounding):
            raise AssertionError("update {} step {}: kernel 3 and its plain "
                                 "twin chose pairs whose bounds differ "
                                 "beyond what their rounding explains"
                                 .format(update, j + 1))
        matched = j
        break

    append_precondition(gp0, gps, "update {}".format(update))
    q = st.functions.base.as_tensor(sas)
    (mean_d, err_d), (mean_r, err_r) = gps[-1](q), lyap.dynamics(q)
    d_mean = float((mean_d - mean_r).abs().max())
    d_err = float((err_d - err_r).abs().max())
    share = max(d_mean, d_err) / float(bounds.min())
    if not share <= APPEND_SHARE:
        raise AssertionError("update {}: the device-advanced GP differs from "
                             "the float64 refresh by {!r} (mean) and {!r} "
                             "(beta std) at the chosen pairs, {!r} of the "
                             "smallest chosen error".format(
                                 update, d_mean, d_err, share))
    return matched, d_mean, d_err, share


def append_precondition(gp0, gps, label):
    """Each GP the sampler advanced on the device from ``gp0`` (``gps``,
    one a step) holds one row more and keeps the kernels' count
    precondition: ``chol_inv[:, n:, :n] == 0``, the rows past the count as
    the host factorization left them, ``mask[n:] == 0``."""
    n0, fresh = gp0.count, gp0.chol_inv
    holds = []
    for j, gp in enumerate(gps):
        n = n0 + j + 1
        if gp.count != n:
            raise AssertionError("{}: device append {} left count {}".format(
                label, j + 1, gp.count))
        holds.append((gp.chol_inv[:, n:, :n] == 0).all()
                     & (gp.chol_inv[:, n:] == fresh[:, n:]).all()
                     & (gp._mask()[n:] == 0).all())
    if not bool(torch.stack(holds).all()):
        raise AssertionError("{}: a device append broke the kernels' count "
                             "precondition".format(label))


def pair_scores(lyap, gp, pairs):
    """The sampler's scores of host ``pairs`` against ``gp``
    (``explore._score_candidates``): the summed predictive errors as
    float64 host values, and the level test."""
    _, err, safe = explore_mod._score_candidates(
        gp, lyap.lyapunov_function, lyap._lipschitz_lyapunov, lyap.c_max,
        st.functions.base.as_tensor(pairs), explore_mod._margin_of(lyap))
    return err.double().cpu().numpy(), safe.cpu().numpy()


def refined_margins(lyap, idx, r, states_per_chunk=4096):
    """Float32 margins ``decrease - threshold`` at every point of the
    ``R^d`` sub-grids of grid states ``idx`` at ``tau / R``, as the
    refinement walk computes them: a float64 host ``(len(idx), R^d)``
    array (``float32_margins``)."""
    points = lyap._device_points()
    offsets = refinement_offsets(lyap.discretization.unit_maxes, r, points)
    out = []
    for start in range(0, len(idx), states_per_chunk):
        flat = sub_points(grid_states(points, idx[start:start +
                                                  states_per_chunk]),
                          offsets)
        out.append(float32_margins(lyap, flat, lyap.tau / r)
                   .reshape(-1, offsets.shape[0]))
    return np.concatenate(out) if out else np.zeros((0, offsets.shape[0]))


def grid_states(points, idx):
    """The device points at host grid indices ``idx``."""
    return points[torch.as_tensor(np.asarray(idx), device=points.device)]


def sub_points(states, offsets):
    """The sub-grid points of ``states`` on the device, state by state, in
    ``lyapunov._refined_negative_batch``'s order."""
    return (states[:, None, :] + offsets[None]).reshape(-1, states.shape[1])


def check_certify(lyap, exempt, band, r, label):
    """Check 5 of ``phase_adaptive``: every state the certify's prefix
    holds passes the host float64 oracle (``oracle.oracle_margins``) or
    lies inside the calibrated band ``|margin| <= band``. Coarse passes
    (``_refinement == 1``) are held at ``tau``; refined rescues
    (``_refinement == R``) at all ``R^d`` sub-points at ``tau / R``, all
    of them, or a seeded sample of ``ORACLE_RESCUE_SAMPLE`` plus every one
    whose float32 refined margin is within ``NEAR_BAND`` bands of
    failing; exempt states pass by definition."""
    safe, ref = np.asarray(lyap.safe_set), lyap._refinement
    checked = safe & ~exempt
    coarse = np.flatnonzero(checked & (ref == 1))
    rescued = np.flatnonzero(checked & (ref == r))
    if (checked & (ref != 1) & (ref != r)).any():
        raise AssertionError("{}: a certified state has a refinement "
                             "other than 1 and {}".format(label, r))
    start = time.perf_counter()
    pts = lyap.discretization.all_points
    bad = int((st.oracle.oracle_margins(lyap, pts[coarse]) > band).sum())
    worst = refined_margins(lyap, rescued, r).max(axis=1)
    near = rescued[worst > -NEAR_BAND * band]
    sample = rescued
    if len(rescued) > ORACLE_RESCUE_SAMPLE:
        sample = np.random.default_rng(0).choice(
            rescued, ORACLE_RESCUE_SAMPLE, replace=False)
    held = np.union1d(sample, near)
    points = lyap._device_points()
    offsets = refinement_offsets(lyap.discretization.unit_maxes, r, points)
    subs = sub_points(grid_states(points, held), offsets).cpu().numpy()
    bad_refined = int((st.oracle.oracle_margins(
        lyap, subs, tau=lyap.tau / r) > band).sum())
    print("{}: {} certified states beyond the {} exempt ones: {} coarse "
          "passes held at tau, {} fail the f64 oracle outside the band "
          "{!r}; {} refined rescues, {} of them held at all {} sub-points "
          "at tau/{} ({} sampled, {} within {}x the band of failing in "
          "float32, {} with a float32 sub-point margin >= 0), {} sub-points "
          "fail outside the band; {:.3f} s".format(
              label, len(coarse) + len(rescued), int(exempt.sum()),
              len(coarse), bad, band, len(rescued), len(held),
              offsets.shape[0], r, len(sample), len(near), NEAR_BAND,
              int((worst >= 0).sum()), bad_refined,
              time.perf_counter() - start))
    if bad or bad_refined:
        raise AssertionError("{}: the certify holds states the f64 oracle "
                             "fails outside the calibrated band".format(
                                 label))


def timed_certify(lyap, r):
    """``update_safe_set(can_shrink=False, max_refinement=r)`` as the
    example runs it, with its wall time (synchronised), its coarse
    passes' and refinement chunks' CUDA-event times and the states of
    its last chunk. Returns ``(wall_ms, coarse_ms, chunks_ms,
    last_chunk_states)``."""
    coarse, chunks, states = EventTimer(), EventTimer(), []
    torch.cuda.synchronize()
    start = time.perf_counter()
    with patched(lyapunov_mod, "_negative_batch", coarse.wrap), \
            patched(lyapunov_mod, "_refined_negative_batch", chunks.wrap), \
            patched(lyapunov_mod, "_refined_negative_batch",
                    recorded(states, lambda args, out: args[6])):
        lyap.update_safe_set(can_shrink=False, max_refinement=r)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - start) * 1e3
    return (wall, sum(ms for ms, _ in coarse.times),
            sum(ms for ms, _ in chunks.times), states[-1] if states else None)


def phase_adaptive(card, updates=ADAPTIVE_UPDATES):
    """``examples/adaptive_safety_verification.py --full`` on the card.

    ``build_adaptive_instance()``: the 501x501 grid, the stacked GP at
    capacity 181, ``max_refinement`` 16. Certify, then ``updates`` times
    ``get_safe_sample_batch`` (15 measurements, ``default_rng(0)``) and a
    certify, each ``can_shrink=False``; then the example's assertion
    ``history[-1] >= history[0] > 0``. Checks, each raising:

    1. kernel 3 launches exactly once per sampler step, coarse pass and
       refinement chunk, no other kernel, and no library is built;
    2. the sampler's k steps make the host wait for the device nowhere
       (``no_host_waits``): the one copy after them is the only sync;
    3. each batch's pairs against those of kernel 3's plain twin from the
       same rng (``check_batch``);
    4. each device append keeps the kernels' count precondition, and the
       device-advanced GP predicts the chosen pairs as the float64
       refresh does within ``APPEND_TOL`` (``check_batch``);
    5. the first certify, the last and every one above count 128 (the
       panel body's) against the float64 oracle, with
       ``calibrate_certificate_margin(refinement=16)`` (not installed, as
       the example runs) as the band (``check_certify``);
    6. the first certify by the fan-out route (``route="fan_out"``,
       kernel 2, twice a predict) gives the same safe set, ``c_max`` and
       ``_refinement``;
    7. the example's assertion.

    Prints per update the safe fraction, ``c_max`` and the largest N(x),
    the refinement chunks and refined points, the batch's and the
    certify's wall ms and the coarse pass's and chunks' CUDA-event ms;
    for each certify above count 128, the device time of its kernel-3
    launches replayed on the body they take and on the streamed body.
    Returns a namespace: ``lyap``, ``inst``, ``launches`` (kernel 3's
    over the run), ``chunk_states`` (the last refinement chunk's states),
    ``gp_before_last`` (the GP the last batch started from), ``kernel3``
    (each kernel-3 launch's GP count by part: sampler steps, coarse
    passes, refinement chunks), ``step_rows`` (the last sampler step's
    rows) and ``first`` (the first certify's safe set, ``c_max`` and
    ``_refinement``).
    """
    r = ADAPTIVE_REFINEMENT
    builds = dict(build_reports)

    # 6, first: the fan-out route's first certify, with its own counts.
    fan, _ = build_adaptive_instance(route="fan_out")
    reset_launches()
    fan.update_safe_set(can_shrink=False, max_refinement=r)
    fan_launches = read_launches()
    fan_counts = fan.last_sweep_counts
    expected = {name: 0 for name in KERNELS}
    per_pass = 1 + fan_counts["refinement_chunks"]
    if fan_launches != dict(expected, gp_predict_general=2 * per_pass):
        raise AssertionError("the fan-out certify launched {}, not kernel 2 "
                             "twice in each of {} passes".format(
                                 fan_launches, per_pass))
    fan_result = (np.array(fan.safe_set), fan.c_max, fan._refinement.copy())
    del fan

    start = time.perf_counter()
    lyap, inst = build_adaptive_instance()
    grid = lyap.discretization
    print("adaptive: grid size {}, tau {!r}, L_f {!r}, GP capacity {} with "
          "{} point, {} exempt initial states, max_refinement {}; built in "
          "{:.3f} s".format(grid.nindex, lyap.tau, inst["lf"],
                            lyap.dynamics.capacity, lyap.dynamics.count,
                            int(inst["initial"].sum()), r,
                            time.perf_counter() - start))

    def certify(label, oracle):
        """One certify with checks 1 and (when ``oracle``) 5."""
        exempt = inst["initial"] | np.asarray(lyap.safe_set)
        if oracle:
            with uncounted():
                band = st.oracle.calibrate_certificate_margin(
                    lyap, refinement=r, set_margin=False)
        before = read_launches()
        calls = []
        with kernel3_calls(calls):
            wall, coarse_ms, chunks_ms, chunk_states = timed_certify(lyap, r)
        got = {k: v - before[k] for k, v in read_launches().items()}
        counts = lyap.last_sweep_counts
        passes = counts["coarse_batches"] + counts["refinement_chunks"]
        if got != dict(expected, gp_predict_stacked=passes):
            raise AssertionError("the {} launched {}, not kernel 3 once in "
                                 "each of {} passes".format(label, got,
                                                            passes))
        coarse = counts["coarse_batches"]
        kernel3["coarse"] += [a[8] for a in calls[:coarse]]
        kernel3["chunk"] += [a[8] for a in calls[coarse:]]
        check_values(lyap)
        if oracle:
            with uncounted():
                check_certify(lyap, exempt, band, r, label)
        count = lyap.dynamics.count
        if count > 128:
            # The same launches on the panel body and on the streamed body
            # (the one every launch above count 128 took before it).
            panel_ms = replayed_ms(calls, "gp_program")
            streamed_ms = replayed_ms(calls, "gp_program_streamed")
            print("{}: kernel 3 at count {}, {} launches ({} queries): "
                  "{!r} ms of device time on the {} body, {!r} ms on the "
                  "streamed body [{}]".format(
                      label, count, len(calls),
                      sum(a[1].shape[0] for a in calls), panel_ms,
                      gp_kernel.program_body(calls[0][0], count,
                                             calls[0][1].dtype),
                      streamed_ms, card))
        return wall, coarse_ms, chunks_ms, chunk_states, got

    # Each kernel-3 launch's GP count, by part of the path.
    kernel3 = {"step": [], "coarse": [], "chunk": []}
    reset_launches()
    first = certify("first certify", oracle=True)
    first_result = (np.array(lyap.safe_set), lyap.c_max,
                    lyap._refinement.copy())
    for name, a, b in zip(("safe_set", "c_max", "_refinement"),
                          first_result, fan_result):
        if not np.array_equal(a, b):
            raise AssertionError("the fan-out route's first certify gives "
                                 "another {}".format(name))
    print("adaptive: the fan-out route (kernel 2, {} launches in {} passes) "
          "certifies the same safe set, c_max and _refinement".format(
              fan_launches["gp_predict_general"], per_pass))
    print("initial certified fraction: {:.4f}  c_max: {!r}  max N(x): {}; "
          "{}; certify {!r} ms wall, coarse pass {!r} ms, chunks {!r} ms "
          "[{}]".format(float(lyap.safe_set.mean()), lyap.c_max,
                        int(lyap._refinement.max()), lyap.last_sweep_counts,
                        first[0], first[1], first[2], card))

    rng = np.random.default_rng(0)
    history = []
    matched = steps = 0
    last_chunk = first[3]
    for update in range(1, updates + 1):
        gp0 = lyap.dynamics
        with uncounted(), plain_stacked_predict():
            before = read_launches()
            twin, _ = sample_batch(lyap, inst, copy.deepcopy(rng),
                                   apply=False, strict=False)
            if read_launches() != before:
                raise AssertionError("the plain twin's batch launched a "
                                     "kernel")
        before = read_launches()
        steps_log = []
        torch.cuda.synchronize()
        start = time.perf_counter()
        with kernel3_calls(steps_log):
            got, gps = sample_batch(lyap, inst, rng)
        batch_ms = (time.perf_counter() - start) * 1e3
        kernel3["step"] += [a[8] for a in steps_log]
        step_rows = steps_log[-1][1]
        sampled = {k: v - before[k] for k, v in read_launches().items()}
        if sampled != dict(expected, gp_predict_stacked=ADAPTIVE_DATA):
            raise AssertionError("update {}: the batch launched {}".format(
                update, sampled))
        with uncounted():
            same, d_mean, d_err, share = check_batch(update, lyap, gp0, got,
                                                     gps, twin)
        matched += same
        steps += ADAPTIVE_DATA
        wall, coarse_ms, chunks_ms, chunk_states, swept = certify(
            "certify {}".format(update),
            oracle=update == updates or lyap.dynamics.count > 128)
        history.append(float(lyap.safe_set.mean()))
        counts = lyap.last_sweep_counts
        print("update {}: safe fraction {:.4f}  c_max {!r}  max N(x) {}; {} "
              "refinement chunks, {} refined points, {} rescued states; "
              "batch {!r} ms ({} backup steps, {} of {} pairs as the plain "
              "twin's, device GP within {!r} / {!r} of the f64 refresh, "
              "{!r} of the smallest chosen error), "
              "certify {!r} ms wall, coarse pass {!r} ms, chunks {!r} ms by "
              "CUDA events; kernel 3 launches: batch {}, certify {} "
              "[{}]".format(
                  update, history[-1], lyap.c_max,
                  int(lyap._refinement.max()), counts["refinement_chunks"],
                  counts["refined_points"], counts["rescued_states"],
                  batch_ms, int((~got[3]).sum()), same, ADAPTIVE_DATA,
                  d_mean, d_err, share, wall, coarse_ms, chunks_ms,
                  sampled["gp_predict_stacked"],
                  swept["gp_predict_stacked"], card))
        if chunk_states is not None:
            last_chunk = chunk_states
    launches = read_launches()
    if not history[-1] >= history[0] > 0:
        raise AssertionError("safe set should not shrink: {}".format(
            history))
    print("safe-set growth: {}".format(" ".join(
        "{:.4f}".format(h) for h in history)))
    print("adaptive: {} of {} sampler steps chose the plain twin's pair; "
          "kernel launches over the run {}; GP count {}".format(
              matched, steps, launches, lyap.dynamics.count))
    print("adaptive: kernel 3 launched by {}".format(", ".join(
        "{} {} ({} above count 128)".format(len(counts), part,
                                            sum(c > 128 for c in counts))
        for part, counts in (("sampler steps", kernel3["step"]),
                             ("coarse passes", kernel3["coarse"]),
                             ("refinement chunks", kernel3["chunk"])))))
    if dict(build_reports) != builds:
        raise AssertionError("the adaptive path built a library")
    print("libraries built during the adaptive path: 0")
    if last_chunk is None:
        raise AssertionError("no certify ran a refinement chunk")
    return types.SimpleNamespace(
        lyap=lyap, inst=inst, launches=launches["gp_predict_stacked"],
        chunk_states=last_chunk, gp_before_last=gp0, kernel3=kernel3,
        step_rows=step_rows, first=first_result)


def profile_adaptive(card, run, reps=3):
    """``profile_window`` over the adaptive path's two units at its last
    update: a 15-step batch from the GP the last batch started from
    (``apply=False``: the GP stays as it is) and a certify (the same
    safe set again: nothing changed since the last one)."""
    lyap = run.lyap
    final = lyap.dynamics

    def batches():
        lyap.dynamics = run.gp_before_last
        try:
            for seed in range(reps):
                sample_batch(lyap, run.inst, np.random.default_rng(seed),
                             apply=False, strict=False)
        finally:
            lyap.dynamics = final

    def certifies():
        for _ in range(reps):
            lyap.update_safe_set(can_shrink=False,
                                 max_refinement=ADAPTIVE_REFINEMENT)

    with uncounted():
        profile_window("adaptive batch of {} steps".format(ADAPTIVE_DATA),
                       batches, reps, card)
        profile_window("adaptive certify", certifies, reps, card)


def product_blocks(n_q, rows_a_query):
    """The column blocks ``[(start, stop)]`` of a product timing over all
    ``n_q`` queries: one block, or, where their ``K`` would exceed 2^28
    values, blocks of ``PLAIN_ROWS`` (the last one shorter), each block's
    product a call on the first block's ``K`` (the values are the first
    ``PLAIN_ROWS`` queries', the work that of all ``n_q``)."""
    if n_q * rows_a_query <= 2 ** 28:
        return [(0, n_q)]
    return [(start, min(start + PLAIN_ROWS, n_q))
            for start in range(0, n_q, PLAIN_ROWS)]


def blocked_product(chol, ks, blocks):
    """A function running ``torch.matmul(chol[s], ks[s][:, :stop -
    start])`` for each output ``s`` and each column block, into one
    buffer a block width (made here): the product over all the blocks'
    columns."""
    calls = []
    for li, k in zip(chol, ks):
        outs = {}
        for start, stop in blocks:
            width = stop - start
            if width not in outs:
                outs[width] = torch.empty((li.shape[0], width),
                                          dtype=k.dtype, device=k.device)
            calls.append((li, k[:, :width], outs[width]))

    def product():
        for li, kb, out in calls:
            torch.matmul(li, kb, out=out)
    return product


def product_ms(inputs, programs, count):
    """The yardstick ``library_ms`` of kernels 2 and 3: the solve's
    product alone, ``torch.matmul(chol_inv[s, :n, :n], K_s)`` summed over
    the outputs, with ``K_s`` (the plain twin's k, scaled and masked)
    computed beforehand, in the working dtype with TF32 off, on the device
    alone (``graph_ms``), over column blocks where ``K`` would be large
    (``product_blocks``). No PyTorch call computes the whole posterior
    numerator; the port never calls this. ``inputs`` are kernel 3's, or
    kernel 2's (one ``chol_inv``)."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on for matmul")
    states, x, params, chol_inv, _, mask, s2 = inputs
    if chol_inv.dim() == 2:
        chol_inv = chol_inv[None]
    blocks = product_blocks(states.shape[0], count * len(programs))
    states = states[:blocks[0][1]]
    cache, chol, ks = {}, [], []
    for s, program in enumerate(programs):
        k = gp_kernel._eval_program(program, params, x.T, states.T, cache)
        ks.append((k * s2 * mask[:, None])[:count].contiguous())
        chol.append(chol_inv[s, :count, :count].contiguous())
    del cache, k
    return graph_ms(blocked_product(chol, ks, blocks))


PRODUCT_CALL = ("torch.matmul(chol_inv[s, :n, :n], K_s) summed over the S "
                "outputs (S = 1 for kernels 1 and 2), K precomputed: the "
                "solve's product alone, not the function (where K of all "
                "queries would exceed 2^28 values, one call a block of 2^18 "
                "query columns over the first block's K, all the queries' "
                "work in one graph: product_blocks)")


def panel_times(card, label, inputs, programs, count):
    """Kernel 3 above count 128 on one input set of the adaptive path:
    the body its launch takes (``program_body``: the panel or the strip
    body) and the streamed body (``gp_predict_stacked_streamed_cuda``, the
    body before those existed), each against the plain twin within
    ``program_bounds`` (the streamed body only where K holds at most 2^28
    values); device times by CUDA graphs in turns (streamed, body, body,
    streamed), each by eager calls, the plain twin's, the product alone
    (``product_ms``) and the bound. Returns the path's entry for
    ``kernel_rows``."""
    states = inputs[0]
    body = gp_kernel.program_body(programs, count, states.dtype)
    errors = {}
    # The streamed body is held to the plain twin where its comparison is
    # cheap (up to 2^28 values of K); above, its time alone is read.
    large = states.shape[0] * count * len(programs) > 2 ** 28
    for route in ("stacked",) if large else ("stacked", "streamed"):
        em, ev, ratio = compare_program(route, inputs, programs, count=count)
        print("adaptive {} inputs (Q={}, count {}), {} body: max|dmean|="
              "{:.3e} max|dvar|={:.3e} err/bound={:.3f}".format(
                  label, states.shape[0], count,
                  body if route == "stacked" else "streamed", em, ev, ratio))
        if not ratio <= 1.0:
            raise AssertionError("kernel 3 ({}) disagrees on the adaptive {} "
                                 "inputs".format(route, label))
        errors[route] = max(em, ev)

    def panel():
        gp_kernel.gp_predict_stacked_cuda(*inputs, programs, count=count)

    def streamed():
        gp_kernel.gp_predict_stacked_streamed_cuda(*inputs, programs,
                                                   count=count)

    if large:
        # One streamed reading between the body's two (a streamed call
        # takes a quarter of a second to a second here); its eager time is
        # not read.
        panel_runs = [graph_ms(panel)]
        streamed_runs = [graph_ms(streamed)]
        panel_runs.append(graph_ms(panel))
    else:
        streamed_runs = [graph_ms(streamed)]
        panel_runs = [graph_ms(panel), graph_ms(panel)]
        streamed_runs.append(graph_ms(streamed))
    entry = dict(
        max_abs_err=errors["stacked"], body=body,
        ms=statistics.mean(panel_runs),
        eager_ms=cuda_ms(panel, batch=10),
        streamed_ms=statistics.mean(streamed_runs),
        streamed_eager_ms=None if large else cuda_ms(streamed, batch=10),
        plain_ms=graph_ms(lambda: program_plain("stacked", inputs,
                                                programs), **PLAIN_GRAPH),
        library_ms=product_ms(inputs, programs, count),
        library_call=PRODUCT_CALL, queries=states.shape[0], count=count)
    entry.update(zip(("bound_ms", "bound_by", "bound_kind"), kernel_bound(
        states.shape[0], states.shape[1], count, 1, len(programs),
        program_ops(programs), states.element_size())))
    print("kernel 3 at the adaptive {} (Q={}, count {}, S={}): {} body "
          "{!r} ms (runs {!r}), streamed body {!r} ms (runs {!r}); by 10 "
          "eager calls {!r} and {!r} ms; plain {!r} ms; the product alone "
          "{!r} ms; bound {!r} ms ({}): {:.1%} of it, streamed {:.1%} "
          "[{}]".format(label, states.shape[0], count, len(programs), body,
                        entry["ms"], panel_runs, entry["streamed_ms"],
                        streamed_runs, entry["eager_ms"],
                        entry["streamed_eager_ms"], entry["plain_ms"],
                        entry["library_ms"], entry["bound_ms"],
                        entry["bound_by"], entry["bound_ms"] / entry["ms"],
                        entry["bound_ms"] / entry["streamed_ms"], card))
    return entry


def adaptive_times(card, run):
    """Kernel 3 on the adaptive path's inputs at the final GP (count 181):
    a sampler step's rows (the last batch's last step), the last certify's
    last refinement chunk (its states' sub-grids) and a coarse pass over
    the grid, each through ``panel_times``. Returns the three paths'
    entries, with their launches over the run and how many of them ran
    above count 128."""
    lyap = run.lyap
    count = lyap.dynamics.count
    points = lyap._device_points()
    offsets = refinement_offsets(lyap.discretization.unit_maxes,
                                 ADAPTIVE_REFINEMENT, points)
    entries = []
    for path, part, label, make in (
            ("adaptive_sampler_step", "step", "sampler step",
             lambda: gp_inputs(lyap.dynamics, run.step_rows)),
            ("adaptive_refinement_chunk", "chunk", "refinement chunk",
             lambda: stacked_inputs(lyap, sub_points(run.chunk_states,
                                                     offsets))),
            ("adaptive", "coarse", "coarse pass",
             lambda: stacked_inputs(lyap, points))):
        inputs, programs = make()
        entry = panel_times(card, label, inputs, programs, count)
        del inputs
        counts = run.kernel3[part]
        entry.update(launches=len(counts),
                     launches_above_128=sum(c > 128 for c in counts))
        entries.append((path, entry))
    return entries


# ---------------------------------------------------------------------------
# The adaptive loop grown past the panel body
# ---------------------------------------------------------------------------
#: ``examples/adaptive_safety_verification.py --full`` grown by its keyword
#: sizes: 3 updates of 340 measurements at capacity 1,024 (``S cap^2 <=
#: 2048^2``, the GPs' route to kernel 3), so the certifies run at counts 1,
#: 341, 681 and 1,021: 341 on the float32 panel body and above the float64
#: one, 681 and 1,021 on the strip body in both dtypes.
GROWN_UPDATES, GROWN_DATA, GROWN_CAPACITY = 3, 340, 1024

#: The updates after whose certify the rigor certifies run, and the
#: refinement of each: at count 341 refinement 4 (its per-state margin 17
#: passes over the grid), at 1,021 the loop's refinement 16 (257 passes,
#: most of the phase's time).
GROWN_RIGOR = {1: 4, 3: ADAPTIVE_REFINEMENT}

#: States held to the float64 oracle at all their refined sub-points: a
#: seeded sample of the last certify's last refinement chunk, and of each
#: rigor certify's refined rescues (the full refined oracle at count 1,021
#: is about 10^12 host FMAs).
GROWN_REFINED_SAMPLE = 64


def refined_oracle_check(lyap, states, band, r, label):
    """The float32 refined verdicts at every sub-point of the device grid
    ``states`` (at ``tau / r``, as the refinement walk computes them)
    against the float64 oracle's, wherever its margin lies outside
    ``band``. Returns ``(sub-points, disagreements inside the band)``."""
    offsets = refinement_offsets(lyap.discretization.unit_maxes, r, states)
    subs = sub_points(states, offsets)
    with uncounted():
        got = float32_margins(lyap, subs, lyap.tau / r)
    want = st.oracle.oracle_margins(lyap, subs.cpu().numpy(),
                                    tau=lyap.tau / r)
    differ = (got < 0) != (want < 0)
    outside = int((differ & (np.abs(want) > band)).sum())
    if outside:
        raise AssertionError("{}: {} refined verdicts differ from the f64 "
                             "oracle outside the band {!r}".format(
                                 label, outside, band))
    return len(want), int(differ.sum())


def grown_rigor(lyap, update, card, margins64, paths):
    """The rigor certifies at one count of the grown loop, on a fresh
    ``Lyapunov`` over the same models (the float32 run goes on as without
    them): the per-state extended margin at the refinement
    ``GROWN_RIGOR`` gives this update, then ``rigor_sweeps`` (extended and
    hybrid, bit for bit, kernel 3 in float64), and the rigor set inside the
    float64 oracle's verdicts on the states it judges: every state a
    coarse pass certified has a negative oracle margin at ``tau`` (from
    ``margins64``, the oracle's margins at every state, or, where it is
    ``None``, the oracle at those states alone), and every sub-point of a
    seeded sample of the refined rescues one at ``tau / r``. Prints the
    hybrid's band fraction and the margin's size; at the last count
    appends the float64 coarse pass's and refinement chunk's kernel-3
    times to ``paths``."""
    r = GROWN_RIGOR[update]
    count = lyap.dynamics.count
    label = "adaptive grown, rigor at count {}".format(count)
    fresh = st.Lyapunov(lyap.discretization, lyap.lyapunov_function,
                        lyap.dynamics, lyap._lipschitz_dynamics,
                        lyap._lipschitz_lyapunov, lyap.tau, lyap.policy,
                        initial_set=np.flatnonzero(lyap.initial_safe_set),
                        adaptive=True)
    margin, derive_s = synchronised_s(
        lambda: extended_verify.extended_certificate_margin(
            fresh, refinement=r, per_point=True, batch_size=DERIVE_BATCH))
    margin = np.asarray(margin.cpu() if torch.is_tensor(margin) else margin)
    ext, hyb, ext_s, hyb_s = rigor_sweeps(fresh, label, card, None, r=r,
                                          reps=1)
    initial = np.asarray(fresh.initial_safe_set, dtype=bool)
    held = ext["safe"] & ~initial
    coarse = np.flatnonzero(held & (ext["refinement"] == 1))
    rescued = np.flatnonzero(held & (ext["refinement"] == r)) if r > 1 \
        else np.zeros(0, dtype=np.int64)
    all_points = fresh.discretization.all_points
    coarse64 = (margins64[coarse] if margins64 is not None
                else st.oracle.oracle_margins(fresh, all_points[coarse]))
    bad = int((coarse64 >= 0).sum())
    sample = rescued
    if len(rescued) > GROWN_REFINED_SAMPLE:
        sample = np.sort(np.random.default_rng(update).choice(
            rescued, GROWN_REFINED_SAMPLE, replace=False))
    points = fresh._device_points()
    bad_refined, n_subs = 0, 0
    if len(sample):
        subs = sub_points(grid_states(points, sample), refinement_offsets(
            fresh.discretization.unit_maxes, r, points)).cpu().numpy()
        n_subs = len(subs)
        bad_refined = int((st.oracle.oracle_margins(
            fresh, subs, tau=fresh.tau / r) >= 0).sum())
    print("{}: refinement {}; per-state extended margin up to {!r} (mean "
          "{!r}; derived in {!r} s); extended {!r} s, hybrid {!r} s, equal "
          "bit for bit, band fraction {!r}; safe fraction {!r}, c_max {!r}; "
          "{} coarse passes and {} refined rescues beyond the initial set: "
          "{} coarse ones with a float64 oracle margin >= 0 at tau, {} of {} "
          "sub-points of {} sampled rescues >= 0 at tau/{} [{}]".format(
              label, r, float(np.max(margin)), float(np.mean(margin)),
              derive_s, ext_s, hyb_s, hyb["band"], float(ext["safe"].mean()),
              ext["c_max"], len(coarse), len(rescued), bad, bad_refined,
              n_subs, len(sample), r, card))
    if bad or bad_refined:
        raise AssertionError("{}: the rigor set holds states the float64 "
                             "oracle fails".format(label))
    if update != GROWN_UPDATES:
        return
    sweep = fresh._get_extended_sweep()
    view = float64_view(sweep, points)
    chunk_launches = sum(n for _, n in ext["chunks"])
    if not ext["chunks"] or any(n < 1 for _, n in ext["chunks"]):
        raise AssertionError("every float64 refinement chunk must launch "
                             "kernel 3")
    chunk_states = ext["chunks"][-1][0]
    chunk_points = sub_points(chunk_states, refinement_offsets(
        fresh.discretization.unit_maxes, r, chunk_states)).double()
    paths.append(("gp_predict_stacked", "adaptive_grown_extended_float64",
                  ext["launches"]["gp_predict_stacked"] - chunk_launches,
                  in_float64(lambda: panel_times(
                      card, "grown coarse pass, float64",
                      *stacked_inputs(view), count))))
    paths.append(("gp_predict_stacked",
                  "adaptive_grown_refinement_chunk_extended_float64",
                  chunk_launches, in_float64(lambda: panel_times(
                      card, "grown refinement chunk, float64",
                      *stacked_inputs(view, chunk_points), count))))


def phase_adaptive_grown(card):
    """The adaptive example grown past the panel body, through its entry
    point: ``adaptive_safety_verification.run(full=True, updates=3,
    data_per_update=340, capacity=1024)`` (the ``--full`` instance, 501x501,
    the stacked Matern GP at S = 2, refinement 16, one
    ``get_safe_sample_batch`` an update), certifies at counts 1, 341, 681
    and 1,021. Checks, each raising and none caught:

    1. kernel 3 launches exactly once per sampler step, coarse pass and
       refinement chunk, no other kernel, and no library is built;
    2. every kernel-3 launch takes the body its count selects
       (``program_body``: tiled, panel, strip; never the streamed body);
    3. every device append keeps the kernels' count precondition
       (``append_precondition``);
    4. the oracle gate at the last certify (count 1,021): the coarse
       verdicts at every state, and the refined verdicts at every
       sub-point of a seeded sample of the last refinement chunk's states
       (``refined_oracle_check``), against the float64 host oracle
       outside ``calibrate_certificate_margin(refinement=16)``'s band;
    5. the last certify again by the fan-out route (kernel 2, twice a
       predict, the same GP's factors, ``StackedGaussianProcess.unstack``)
       from the same state: the same safe set, ``c_max`` and
       ``_refinement``;
    6. the rigor certifies at counts 341 (refinement 4) and 1,021
       (refinement 16; ``grown_rigor``, ``GROWN_RIGOR``): hybrid =
       extended bit for bit, kernel 3 in float64, the rigor set inside the
       float64 oracle's verdicts on the states it judges;
    7. the example's assertion ``history[-1] >= history[0] > 0``.

    Prints each batch's and certify's wall ms and the coarse passes' and
    chunks' CUDA-event ms; the launch shapes at count 1,021 are timed on
    the body they take and on the streamed body once each, in the timing
    phase (``grown_times``) and, in float64, here (``grown_rigor``). Returns ``(paths, run)``: the float64 kernel-3 paths
    of the rigor certify at count 1,021 and a namespace of the float32
    run (``lyap``, the last chunk's states, the last sampler step's rows,
    the kernel-3 launches by part, the fan-out's kernel-2 launches)."""
    r = ADAPTIVE_REFINEMENT
    builds = dict(build_reports)
    expected = {name: 0 for name in KERNELS}
    calls, gps, chunk_states = [], [], []
    coarse_t, chunk_t = EventTimer(), EventTimer()
    mark = dict(launches=read_launches(), calls=0, gp0=None)
    info, parts, rigor_paths = {}, collections.Counter(), []
    snapshot, gate = {}, {}
    inner_update = lyapunov_mod.Lyapunov.update_safe_set
    inner_batch = adaptive_safety_verification.get_safe_sample_batch

    def timed_update(self, *args, **kwargs):
        if kwargs.get("extended"):
            return inner_update(self, *args, **kwargs)
        coarse_t.times.clear()
        chunk_t.times.clear()
        chunk_states.clear()
        out, seconds = synchronised_s(
            lambda: inner_update(self, *args, **kwargs))
        info.update(certify_ms=seconds * 1e3,
                    coarse_ms=sum(ms for ms, _ in coarse_t.times),
                    chunks_ms=sum(ms for ms, _ in chunk_t.times))
        return out

    def timed_batch(lyap, *args, **kwargs):
        mark["gp0"] = lyap.dynamics
        gps.clear()
        out, seconds = synchronised_s(lambda: inner_batch(lyap, *args,
                                                          **kwargs))
        info["batch_ms"] = seconds * 1e3
        return out

    def after_certify(lyap, update):
        count = lyap.dynamics.count
        label = "adaptive grown, certify {} (count {})".format(update, count)
        got = {k: v - mark["launches"][k] for k, v in read_launches().items()}
        counts = lyap.last_sweep_counts
        n_coarse = counts["coarse_batches"]
        passes = n_coarse + counts["refinement_chunks"]
        steps = GROWN_DATA if update else 0
        if got != dict(expected, gp_predict_stacked=steps + passes):
            raise AssertionError("{}: launched {}, not kernel 3 once in each "
                                 "of {} sampler steps and {} passes".format(
                                     label, got, steps, passes))
        new = calls[mark["calls"]:]
        by_part = (("sampler step", new[:steps]),
                   ("coarse pass", new[steps:steps + n_coarse]),
                   ("refinement chunk", new[steps + n_coarse:]))
        for part, part_calls in by_part:
            for a in part_calls:
                body = gp_kernel.program_body(a[0], a[8], a[1].dtype)
                if body != expected_body(a[8], panel_max(a[1].dtype)):
                    raise AssertionError("{}: a {} at count {} took the {} "
                                         "body".format(label, part, a[8],
                                                       body))
                parts[part, body] += 1
        if update:
            append_precondition(mark["gp0"], gps, label)
        print("{}: safe fraction {:.4f}, c_max {!r}, max N(x) {}; {} coarse "
              "passes, {} refinement chunks, {} refined points; batch {!r} ms"
              ", certify {!r} ms wall, coarse passes {!r} ms, chunks {!r} ms "
              "by CUDA events [{}]".format(
                  label, float(lyap.safe_set.mean()), lyap.c_max,
                  int(lyap._refinement.max()), n_coarse,
                  counts["refinement_chunks"], counts["refined_points"],
                  info.get("batch_ms") if update else None,
                  info["certify_ms"], info["coarse_ms"], info["chunks_ms"],
                  card))
        if update == GROWN_UPDATES - 1:
            snapshot.update(safe=np.array(lyap.safe_set),
                            refinement=np.array(lyap._refinement))
        margins64 = None
        if update == GROWN_UPDATES:
            if not chunk_states:
                raise AssertionError("{}: no refinement chunk ran".format(
                    label))
            margins64 = grown_gate(lyap, label, chunk_states[-1])
            gate.update(states=chunk_states[-1], rows=new[steps - 1][1])
        if update in GROWN_RIGOR:
            grown_rigor(lyap, update, card, margins64, rigor_paths)
        mark.update(launches=read_launches(), calls=len(calls))

    reset_launches()
    mark["launches"] = read_launches()
    with kernel3_calls(calls), \
            patched(lyapunov_mod, "_negative_batch", coarse_t.wrap), \
            patched(lyapunov_mod, "_refined_negative_batch", chunk_t.wrap), \
            patched(lyapunov_mod, "_refined_negative_batch",
                    recorded(chunk_states, lambda args, out: args[6])), \
            patched(explore_mod, "_device_border_append", recorded(gps)), \
            patched(lyapunov_mod.Lyapunov, "update_safe_set",
                    lambda inner: timed_update), \
            patched(adaptive_safety_verification, "get_safe_sample_batch",
                    lambda inner: timed_batch):
        run = adaptive_safety_verification.run(
            full=True, updates=GROWN_UPDATES, data_per_update=GROWN_DATA,
            capacity=GROWN_CAPACITY, after_certify=after_certify)
    lyap = run.lyap
    print("adaptive grown: safe-set growth {}; kernel 3 launched by part "
          "and body: {} [{}]".format(
              " ".join("{:.4f}".format(h) for h in run.history),
              ", ".join("{} {}: {}".format(part, body, n)
                        for (part, body), n in sorted(parts.items())),
              card))
    if any(body == "streamed" for _, body in parts):
        raise AssertionError("a launch of the grown loop took the streamed "
                             "body")
    if dict(build_reports) != builds:
        raise AssertionError("the grown adaptive path built a library")

    # 5: the last certify again by the fan-out route, from the state the
    # stacked route's started from.
    final = (np.array(lyap.safe_set), lyap.c_max,
             np.array(lyap._refinement))
    stacked = lyap.dynamics
    lyap.dynamics = st.FunctionStack(stacked.unstack())
    lyap.safe_set = snapshot["safe"].copy()
    lyap._refinement = snapshot["refinement"].copy()
    reset_launches()
    fan_calls = []
    with kernel3_calls(fan_calls):
        lyap.update_safe_set(can_shrink=False, max_refinement=r,
                             safety_factor=1.0)
    fan = read_launches()
    fan_passes = (lyap.last_sweep_counts["coarse_batches"]
                  + lyap.last_sweep_counts["refinement_chunks"])
    if fan != dict(expected, gp_predict_general=2 * fan_passes):
        raise AssertionError("the fan-out certify launched {}, not kernel 2 "
                             "twice in each of {} passes".format(
                                 fan, fan_passes))
    for name, a, b in zip(("safe_set", "c_max", "_refinement"), final,
                          (np.array(lyap.safe_set), lyap.c_max,
                           np.array(lyap._refinement))):
        if not np.array_equal(a, b):
            raise AssertionError("the fan-out route's last certify gives "
                                 "another {}".format(name))
    print("adaptive grown: the fan-out route (kernel 2, {} launches in {} "
          "passes, {} body) certifies the same safe set, c_max and "
          "_refinement at count {}".format(
              fan["gp_predict_general"], fan_passes,
              gp_kernel.program_body(fan_calls[0][0], stacked.count,
                                     fan_calls[0][1].dtype), stacked.count))
    lyap.dynamics = stacked
    lyap.safe_set, lyap._refinement = final[0], final[2]
    return rigor_paths, types.SimpleNamespace(
        lyap=lyap, chunk_states=gate["states"], step_rows=gate["rows"],
        parts=parts, fan_calls=fan_calls,
        fan_launches=fan["gp_predict_general"])


def grown_gate(lyap, label, chunk_states):
    """Check 4 of ``phase_adaptive_grown`` at the last certify: the coarse
    decrease verdict of every grid state on the card (``_negative_batch``,
    through kernel 3) against the sign of its float64 oracle margin outside
    the band of ``calibrate_certificate_margin(refinement=16)``, then the
    refined verdicts of a seeded sample of the last refinement chunk's
    states (``refined_oracle_check``). Returns the oracle's margins at every
    state."""
    r = ADAPTIVE_REFINEMENT
    with uncounted():
        band = st.oracle.calibrate_certificate_margin(lyap, refinement=r,
                                                      set_margin=False)
        negative = _negative_batch(
            lyap.policy, lyap.dynamics, lyap.lyapunov_function,
            lyap._lipschitz_lyapunov, lyap._lipschitz_dynamics, lyap.tau,
            lyap._device_points())[0].cpu().numpy()
    start = time.perf_counter()
    margins64 = st.oracle.oracle_margins(lyap,
                                         lyap.discretization.all_points)
    oracle_s = time.perf_counter() - start
    differ = negative != (margins64 < 0)
    outside = int((differ & (np.abs(margins64) > band)).sum())
    rng = np.random.default_rng(0)
    take = rng.choice(chunk_states.shape[0], min(GROWN_REFINED_SAMPLE,
                                                 chunk_states.shape[0]),
                      replace=False)
    n_sub, differ_sub = refined_oracle_check(
        lyap, chunk_states[torch.as_tensor(np.sort(take),
                                           device=chunk_states.device)],
        band, r, label)
    print("{}: coarse decrease verdicts at all {} states: {} pass on the "
          "card, {} in the f64 oracle ({!r} s), {} differ, {} of them "
          "outside the band {!r}; refined verdicts at {} sub-points of {} "
          "seeded states of the last refinement chunk ({} states): {} "
          "differ, none outside the band".format(
              label, len(negative), int(negative.sum()),
              int((margins64 < 0).sum()), oracle_s, int(differ.sum()),
              outside, band, n_sub, len(take), chunk_states.shape[0],
              differ_sub))
    if outside:
        raise AssertionError("{}: {} coarse verdicts differ from the f64 "
                             "oracle outside the calibrated band".format(
                                 label, outside))
    return margins64


def grown_times(card, run):
    """Kernels 2 and 3 on the grown loop's inputs at its final GP (count
    1,021): a sampler step's rows, the last refinement chunk's sub-points
    and a coarse pass over the grid (kernel 3, ``panel_times``: the body
    each takes in turns with the streamed body), and the fan-out route's
    coarse pass (kernel 2, ``program_times``). Returns the paths for
    ``kernel_rows``."""
    lyap = run.lyap
    count = lyap.dynamics.count
    points = lyap._device_points()
    offsets = refinement_offsets(lyap.discretization.unit_maxes,
                                 ADAPTIVE_REFINEMENT, points)
    entries = []
    for path, part, label, make in (
            ("adaptive_grown_sampler_step", "sampler step", "grown sampler "
             "step", lambda: gp_inputs(lyap.dynamics, run.step_rows)),
            ("adaptive_grown_refinement_chunk", "refinement chunk",
             "grown refinement chunk", lambda: stacked_inputs(
                 lyap, sub_points(run.chunk_states, offsets))),
            ("adaptive_grown", "coarse pass", "grown coarse pass",
             lambda: stacked_inputs(lyap, points))):
        inputs, programs = make()
        entry = panel_times(card, label, inputs, programs, count)
        del inputs
        entry.update(launches=sum(n for (p, _), n in run.parts.items()
                                  if p == part))
        entries.append(("gp_predict_stacked", path, entry))
    fan_view = types.SimpleNamespace(
        policy=lyap.policy, dynamics=st.FunctionStack(
            lyap.dynamics.unstack()), _device_points=lambda: points)
    entries.append(("gp_predict_general", "adaptive_grown_fan_out",
                    (run.fan_launches,) + program_times(
                        card, "general", fan_view,
                        "grown fan-out coarse pass")))
    return entries


# ---------------------------------------------------------------------------
# The cart-pole at 51^4 and the 1-D region of attraction
# ---------------------------------------------------------------------------
def phase_cartpole_verification(card):
    """The reference's largest verification, the 51^4 cart-pole grid
    (``build_cartpole_instance``), through kernel 1 at d = 5, p = 4.

    One sweep, then ``oracle_gate`` (gate 1, every decrease verdict of the
    6,765,201 states against the float64 oracle outside the calibrated
    band, the margin-guarded set inside the oracle's with gate 2), then a
    sweep with the margin installed. Checks, each raising: each sweep
    launched kernel 1 exactly once and no other kernel, no library was
    built, the values are finite on ``cuda:0``. Prints the safe fraction,
    ``c_max``, the oracle's wall time and the sweep's time (CUDA events,
    median of 10 after warm-up) and checks/s. Returns ``(lyap,
    launches)``, kernel 1's launches over the two sweeps.
    """
    builds = dict(build_reports)
    start = time.perf_counter()
    lyap, inst = build_cartpole_instance()
    grid = lyap.discretization
    print("cartpole 51^4: {} states, GP capacity {} with {} points over "
          "(x, theta, v, omega, u), p = {}, tau {!r}, L_v {!r}, L_f {!r}, "
          "threshold {!r}; built in {:.3f} s".format(
              grid.nindex, lyap.dynamics.capacity, lyap.dynamics.count,
              lyap.dynamics.output_dim, inst["tau"], inst["lv"], inst["lf"],
              -inst["lv"] * (1 + inst["lf"]) * inst["tau"],
              time.perf_counter() - start))
    expected = {name: 0 for name in KERNELS}
    sweeps = []
    reset_launches()
    lyap.update_safe_set()
    sweeps.append(read_launches())
    check_values(lyap)
    print("cartpole 51^4: safe fraction {!r}, c_max {!r}".format(
        float(lyap.safe_set.mean()), lyap.c_max))
    initial = np.zeros(grid.nindex, dtype=bool)
    initial[inst["initial_set"]] = True
    with uncounted():
        oracle_gate(lyap, "cartpole 51^4", initial=initial)
    reset_launches()
    lyap.update_safe_set()
    sweeps.append(read_launches())
    check_values(lyap)
    for got in sweeps:
        if got != dict(expected, gp_predict=1):
            raise AssertionError("a cart-pole sweep launched {}, not kernel "
                                 "1 once".format(got))
    if dict(build_reports) != builds:
        raise AssertionError("the cart-pole path built a library")
    print("kernel launches of the cart-pole sweeps: {}; libraries built: 0"
          .format(sweeps))
    time_sweep("cartpole 51^4", lyap, card)
    return lyap, len(sweeps)


#: The JAX package's record of the cart-pole example at ``--full`` on the
#: TPU (``examples/README.md:105``): the learned and the LQR ROA fractions.
CARTPOLE_ROA_RECORD = {"learned": 0.991, "lqr": 0.974}

#: States of the float64 check of the LQR closed loop's ROA.
ROA_SUBSAMPLE = 65536

#: The cart-pole example's seed on the card. Its joint training (policy
#: step size 4) ends in a policy that balances or not depending on the
#: minibatch stream: over iterations 300 to 400 the closed loop's final
#: norm alternates between 1e-5 and 1 on the CPU, and on an H100 seeds 0
#: and 1 ended at 0.287 and 0.232 and seed 2 at 1.4e-5 (PERF.md).
CARTPOLE_SEED = 2

#: The cart-pole example's joint actor-critic iterations on the card: cut
#: from its 400 to 100, the depth that pays for the grown adaptive phase.
#: At 200 iterations seeds 0 to 3 all balanced on an H100; at 100 seed 2
#: balanced and its learned ROA covered 0.9941 of the grid (0.9999 at 200,
#: 0.924 at 400, 0.957 at 60; the JAX package's record: 0.991; PERF.md
#: section 4).
CARTPOLE_JOINT_ITERS = 100


def phase_cartpole_rl(card):
    """``examples/reinforcement_learning_cartpole.py --full`` on the card
    (``safe_learning_tpu_torch.examples.reinforcement_learning_cartpole.
    run(full=True, seed=CARTPOLE_SEED, joint_iters=CARTPOLE_JOINT_ITERS)``):
    ``CARTPOLE_JOINT_ITERS`` (its 400 cut to 100) joint iterations of 50 +
    10 eager SGD steps, the closed loops from ``(0.2, 0.2, 0, 0)``, both
    ROAs on the 51^4 grid over 2000 steps.

    Checks, each raising: the example's assertions (learned final norm
    below 0.1, learned ROA fraction above 0.005); no host wait inside the
    rollouts (``analysis._simulate`` under ``no_host_waits``); no GP
    kernel launched and no library built; the float32 LQR ROA against a
    float64 rollout on the card of a seeded ``ROA_SUBSAMPLE``-state
    subsample over the same horizon: at most 0.1 % disagree, and each one
    that does ends, in float64, within a factor of 2 of ``tol``. Reports
    both fractions beside the JAX package's record, the training's wall
    time and ms a step, each ROA's wall time and state-steps/s, and the
    peak device memory.
    """
    from safe_learning_tpu_torch import analysis
    from safe_learning_tpu_torch.examples import \
        reinforcement_learning_cartpole as example

    if (torch.backends.cuda.matmul.allow_tf32
            or torch.backends.cudnn.allow_tf32):
        raise AssertionError("TF32 is on")
    builds = dict(build_reports)
    reset_launches()
    with patched(analysis, "_simulate", no_host_waits):
        result = example.run(full=True, seed=CARTPOLE_SEED,
                             joint_iters=CARTPOLE_JOINT_ITERS)
    launches = read_launches()
    if any(launches.values()) or dict(build_reports) != builds:
        raise AssertionError("the cart-pole RL path launched {} or built a "
                             "library".format(launches))
    grid, tol = result.grid, result.tol
    print("cartpole RL: final state norm from (0.2, 0.2, 0, 0): learned "
          "{!r}, LQR {!r}".format(result.final_new, result.final_lqr))
    for name in ("learned", "lqr"):
        print("cartpole RL: {} ROA fraction {!r} on {} states over {} steps "
              "(the JAX package's record on the TPU: {}), {!r} s wall, "
              "{!r} state-steps/s [{}]".format(
                  name, result.fractions[name], grid.nindex, result.horizon,
                  CARTPOLE_ROA_RECORD[name], result.roa_s[name],
                  result.state_steps_per_s[name], card))
    print("cartpole RL: joint actor-critic {!r} s wall for {} SGD steps, "
          "{!r} ms a step; peak device memory {} bytes [{}]".format(
              result.train_s, result.steps, result.step_ms,
              result.peak_bytes, card))

    rng = np.random.default_rng(0)
    idx = np.sort(rng.choice(grid.nindex, ROA_SUBSAMPLE, replace=False))
    system64 = float64_copy(result.system)
    lqr64 = float64_copy(result.policy_lqr)
    points = torch.as_tensor(grid.all_points[idx], dtype=torch.float64,
                             device=st.config.device)
    start = time.perf_counter()
    end64, _ = analysis._simulate(lambda x: system64(x, lqr64(x)), points,
                                  result.horizon)
    dist64 = torch.linalg.norm(end64, dim=1).cpu().numpy()
    roa64, roa32 = dist64 <= tol, result.roa["lqr"][idx]
    differ = np.flatnonzero(roa32 != roa64)
    print("cartpole RL: LQR ROA of {} sampled states in float64 on the card "
          "({:.3f} s): fraction {!r} (float32 {!r}); {} verdicts differ"
          .format(ROA_SUBSAMPLE, time.perf_counter() - start,
                  float(roa64.mean()), float(roa32.mean()), len(differ)))
    far = 0
    for j in differ:
        near = tol / 2 <= dist64[j] <= 2 * tol
        far += not near
        print("  state {} x={} float32 verdict {}, float64 end distance {!r}"
              "{}".format(idx[j], grid.all_points[idx[j]].tolist(),
                          bool(roa32[j]), float(dist64[j]),
                          "" if near else " (NOT within a factor 2 of tol)"))
    if len(differ) > 0.001 * ROA_SUBSAMPLE or far:
        raise AssertionError("the float32 LQR ROA differs from the float64 "
                             "rollout at {} of {} states ({} far from tol)"
                             .format(len(differ), ROA_SUBSAMPLE, far))


def one_d_normals(generator, number, n):
    """``ONE_D_NORMALS`` in place of ``sample_gp_function``'s draw: the JAX
    package's normals for ``PRNGKey(0)``."""
    z = np.asarray(ONE_D_NORMALS, dtype=np.float32).astype(np.float64)
    if (number, n) != (1, z.size):
        raise ValueError("ONE_D_NORMALS holds (1, {}) normals, not {}"
                         .format(z.size, (number, n)))
    return z.reshape(1, -1)


def one_d_reference():
    """The 1-D example's loop on the CPU in the working dtype, on the same
    normals: the card's run with kernel 2's plain twin in its place (the
    grid's points and the initial set follow the working dtype, so a
    float64 loop is another instance)."""
    from safe_learning_tpu_torch.examples import \
        one_d_region_of_attraction_estimate as example

    device = st.config.device
    st.config.device = "cpu"
    try:
        with patched(st.functions.gp, "_standard_normals",
                     lambda fn: one_d_normals):
            return example.run(full=True, seed=0)
    finally:
        st.config.device = device


def phase_one_d_roa(card):
    """``examples/one_d_region_of_attraction_estimate.py --full`` on the
    card (``...examples.one_d_region_of_attraction_estimate.run(full=True,
    seed=0)``), its true system drawn from the JAX package's normals
    (``ONE_D_NORMALS``): 1001 states, 24 measurements, a data-free
    composite GP at capacity 32, kernel 2 at counts 0 to 24.

    Checks, each raising: kernel 2 carries every predict of the GP on the
    card, once a predict (each sweep, each ``evaluate``), and nothing else
    launches or is built; the initial safe fraction is between 0.198 and
    0.201; the history reaches 1.000 by the 3rd measurement with ``c_max``
    1.0000, the JAX package's record at this seed (``examples/README.md:
    101``); the last certify passes ``oracle_gate``; the example's
    assertion. The history and the measured states are held against the
    same loop on the CPU (``one_d_reference``); where they part, the
    first such update and the float64 GP's std at both choices are
    printed. Then
    ``fit_gp_hyperparameters`` of the final GP on the card, Adam for 150
    steps and L-BFGS-B for 100 (``min_noise`` 1e-6 for both), each final
    negative log likelihood within 1e-3 relative of the same fit on the
    CPU in float64. Returns ``(lyap, launches)``.
    """
    from safe_learning_tpu_torch.examples import \
        one_d_region_of_attraction_estimate as example

    gp_mod = st.functions.gp
    kernel = gp_kernel.gp_predict_general_cuda
    builds = dict(build_reports)
    predicts, sweeps, gps = [], [], []

    def count_predicts(fn):
        @functools.wraps(fn)
        def predict(self, points, full_cov=False):
            before = kernel.launches
            out = fn(self, points, full_cov)
            predicts.append((full_cov, out[0].device.type,
                             kernel.launches - before))
            return out
        return predict

    def count_sweeps(fn):
        @functools.wraps(fn)
        def sweep(self, *args, **kwargs):
            before = kernel.launches
            out = fn(self, *args, **kwargs)
            sweeps.append(kernel.launches - before)
            return out
        return sweep

    reset_launches()
    with patched(gp_mod, "_standard_normals", lambda fn: one_d_normals), \
            patched(st.GaussianProcess, "predict", count_predicts), \
            patched(st.GaussianProcess, "add_data_point", recorded(
                gps, lambda args, out: args[0])), \
            patched(st.Lyapunov, "update_safe_set", count_sweeps):
        result = example.run(full=True, seed=0)
    launches = read_launches()
    lyap = result.lyap
    card_type = st.config.device.type
    on_card = [n for full, dev, n in predicts
               if not full and dev == card_type]
    others = [n for full, dev, n in predicts if full or dev != card_type]
    print("1-D ROA: {} GP predicts on the card, {} on the host (the "
          "sampler's float64 island), {} sweeps; kernel launches {}".format(
              len(on_card), len(others), len(sweeps), launches))
    expected = {name: 0 for name in KERNELS}
    if (any(n != 1 for n in on_card) or any(others)
            or any(n != 1 for n in sweeps)
            or len(sweeps) != 1 + result.n_updates
            or launches != dict(expected, gp_predict_general=len(on_card))
            or len(on_card) != 2 * result.n_updates + 1):
        raise AssertionError("kernel 2 did not carry every predict once")
    if dict(build_reports) != builds:
        raise AssertionError("the 1-D path built a library")

    history = result.fractions
    print("1-D ROA: initial safe fraction {!r}; history {}; c_max {!r}; "
          "{} updates in {!r} s wall [{}]".format(
              result.initial_fraction, " ".join(
                  "{:.3f}".format(f) for f in history), lyap.c_max,
              result.n_updates, result.loop_s, card))
    ref = one_d_reference()
    parted = next((u for u in range(result.n_updates)
                   if history[u] != ref.fractions[u]
                   or not np.array_equal(result.measured[u],
                                         ref.measured[u])), None)
    if parted is None:
        print("1-D ROA: the card's measured states and history equal those "
              "of the same loop on the CPU")
    else:
        # The GP that chose update ``parted``'s measurement.
        gp64 = st.oracle.lift64(gps[parted])
        with st.oracle._oracle_env():
            _, err = gp64.evaluate(torch.as_tensor(np.stack(
                [result.measured[parted], ref.measured[parted]])))
        print("1-D ROA: the card parts from the same loop on the CPU at "
              "update {}: measured {} (fraction {!r}) against {} ({!r}); "
              "the float64 GP's beta std there {}".format(
                  parted + 1, result.measured[parted].tolist(),
                  history[parted], ref.measured[parted].tolist(),
                  ref.fractions[parted], err[:, 0].tolist()))
    if not (0.198 <= result.initial_fraction <= 0.201
            and 1.0 in history[:3]
            and "{:.4f}".format(lyap.c_max) == "1.0000"):
        raise AssertionError("the 1-D history parts from the record "
                             "(0.199 -> 1.000 within 3 measurements, c_max "
                             "1.0000)")
    initial = np.abs(lyap.discretization.all_points[:, 0]) < 0.2
    with uncounted():
        oracle_gate(lyap, "1-D ROA last certify", initial=initial)
        one_d_fits(card, lyap.dynamics)
    return lyap, launches["gp_predict_general"]


def one_d_fits(card, gp):
    """``fit_gp_hyperparameters`` of the 1-D example's final GP on the card
    in the working dtype and on the CPU in float64: Adam (150 steps) and
    L-BFGS-B (100 iterations), ``min_noise`` 1e-6; the final negative log
    likelihoods within 1e-3 relative."""
    for method, steps in (("adam", 150), ("lbfgs", 100)):
        torch.cuda.synchronize()
        start = time.perf_counter()
        fitted, history = st.fit_gp_hyperparameters(
            gp, steps=steps, method=method, min_noise=1e-6)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - start
        with st.oracle._oracle_env():
            start = time.perf_counter()
            fitted64, history64 = st.fit_gp_hyperparameters(
                st.oracle.lift64(gp), steps=steps, method=method,
                min_noise=1e-6)
            host_s = time.perf_counter() - start
        rel = abs(history[-1] - history64[-1]) / abs(history64[-1])
        print("1-D GP fit, {}: {} evaluations on the card ({!r} s), NLL "
              "{!r} -> {!r}; float64 on the CPU {} evaluations ({!r} s), "
              "{!r} -> {!r}; relative difference of the final NLL {!r} "
              "(tolerance 1e-3); noise {!r} (float64 {!r}) [{}]".format(
                  method, len(history), card_s, float(history[0]),
                  float(history[-1]), len(history64), host_s,
                  float(history64[0]), float(history64[-1]), rel,
                  float(fitted.noise_variance),
                  float(fitted64.noise_variance), card))
        if not rel <= 1e-3:
            raise AssertionError("the card's {} fit ends {} from the float64 "
                                 "fit".format(method, rel))


# ---------------------------------------------------------------------------
# The streamed sweep, the region tools and the remaining example scripts
# ---------------------------------------------------------------------------
#: ``config.fused_sweep_limit`` and ``gp_batch_size`` of the exactness run
#: at 10^6 points: 16 batches.
STREAM_LIMIT = 2 ** 16


def sorted_prefix(values, passed, level_margin=0.0):
    """The JAX package's rule for a streamed grid, on host arrays
    (``safe_learning_tpu/lyapunov.py:1046-1258``): the stable value sort's
    prefix before the first state that does not pass, trimmed below that
    state's value by ``level_margin``. Returns ``(safe, c_max, first)``,
    ``first`` the flat index of that state (``None`` when all pass)."""
    order = np.argsort(values, kind="stable")
    ok = passed[order]
    stop = len(values) if ok.all() else int(np.argmin(ok))
    max_index = stop - 1
    if level_margin > 0.0 and 0 <= max_index < len(values) - 1:
        max_index = min(max_index, int(np.searchsorted(
            values[order], values[order[stop]] - level_margin,
            side="left")) - 1)
    safe = np.zeros(len(values), dtype=bool)
    safe[order[:max_index + 1]] = True
    c_max = float(values[order[max_index]]) if max_index >= 0 else -np.inf
    return safe, c_max, (None if stop == len(values) else int(order[stop]))


def streamed_passed(lyap, batch):
    """Each state's verdict as the streamed sweep of ``lyap`` computes it
    (the same states, made on the card, in the same batches), OR the
    initial set: the host copy the rule reads."""
    grid = lyap.discretization
    margin = lyap.certificate_margin
    parts = []
    for start in range(0, grid.nindex, batch):
        stop = min(start + batch, grid.nindex)
        parts.append(_negative_batch(
            lyap.policy, lyap.dynamics, lyap.lyapunov_function,
            lyap._lipschitz_lyapunov, lyap._lipschitz_dynamics, lyap.tau,
            grid.states_in_range(start, stop),
            margin if np.ndim(margin) == 0 else margin[start:stop])[0]
            .cpu().numpy())
    passed = np.concatenate(parts)
    if lyap.initial_safe_set is not None:
        passed |= np.asarray(lyap.initial_safe_set)
    return passed


def host_waits(fn):
    """Where ``fn()`` makes the host wait for the device: a
    ``collections.Counter`` of the Python lines (``file:line``) that
    ``torch.cuda.set_sync_debug_mode("warn")`` reports."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return collections.Counter(
        "{}:{}".format(w.filename, w.lineno) for w in caught
        if "synchroniz" in str(w.message))


def check_streamed(lyap, batch, label):
    """The streamed sweep that just ran on ``lyap`` against the sorted-prefix
    rule over its own values and verdicts: safe set and ``c_max`` equal,
    exactly. Returns the rule's first failing state."""
    values = lyap.values.cpu().numpy()
    with uncounted():
        passed = streamed_passed(lyap, batch)
    safe, c_max, first = sorted_prefix(values, passed, lyap.level_margin)
    got = np.array(lyap.safe_set)
    if lyap.initial_safe_set is not None:
        safe |= np.asarray(lyap.initial_safe_set)
    print("{}: {} safe states, c_max {!r}; the sorted-prefix rule over the "
          "same values and verdicts: {} states, c_max {!r}, first failing "
          "state {} (value {!r}); {} states differ".format(
              label, int(got.sum()), lyap.c_max, int(safe.sum()), c_max,
              first, None if first is None else float(values[first]),
              int((got != safe).sum())))
    if not (np.array_equal(got, safe) and lyap.c_max == c_max):
        raise AssertionError("{}: the streamed sweep is not the sorted "
                             "prefix".format(label))
    return first


def phase_streamed_exactness(card):
    """The streamed sweep at 10^6 points, held exactly to the JAX
    package's sorted prefix.

    ``bench.py``'s instance at 1000x1000 with ``config.fused_sweep_limit``
    and ``gp_batch_size`` lowered to 2^16 for the phase, so each sweep
    streams in 16 batches: kernel 1 once a batch and no other kernel;
    the safe set and ``c_max`` equal to the rule over the sweep's own
    values and verdicts (``check_streamed``), before and after
    ``calibrate_certificate_margin`` installs its margins; no Python line
    makes the host wait for the device once a batch (``host_waits``).
    After the first sweep, the fused sweep (the limits restored) on the
    same instance: the two safe sets differ only at states tied in value
    with the first failing state at lower indices, which the fused sweep
    excludes; their number is printed."""
    inst = build_bench_instance(1000)
    old = st.config.fused_sweep_limit, st.config.gp_batch_size

    def limits(streamed):
        st.config.fused_sweep_limit, st.config.gp_batch_size = (
            (STREAM_LIMIT, STREAM_LIMIT) if streamed else old)

    limits(True)
    try:
        lyap = st.Lyapunov(inst["grid"], inst["v"], inst["gp"], inst["lf"],
                           inst["lv"], inst["tau"], inst["policy"],
                           initial_set=inst["initial_set"])
        batches = -(-lyap.discretization.nindex // STREAM_LIMIT)
        for label in ("10^6 streamed sweep", "10^6 streamed sweep, margins "
                      "installed"):
            if label.endswith("installed"):
                with uncounted():
                    margin = st.oracle.calibrate_certificate_margin(
                        lyap, num_samples=4096)
                print("margin {!r}, level_margin {!r}".format(
                    margin, lyap.level_margin))
            reset_launches()
            torch.cuda.synchronize()
            start = time.perf_counter()
            lyap.update_safe_set()
            torch.cuda.synchronize()
            seconds = time.perf_counter() - start
            launches = read_launches()
            print("{}: {} batches of {}, {!r} s wall, launches {} [{}]"
                  .format(label, lyap.last_sweep_counts["coarse_batches"],
                          STREAM_LIMIT, seconds, launches, card))
            if launches != dict({n: 0 for n in KERNELS},
                                gp_predict=batches):
                raise AssertionError("{}: kernel 1 not once a batch"
                                     .format(label))
            first = check_streamed(lyap, STREAM_LIMIT, label)
            if label.endswith("installed"):
                break
            # The fused sweep of the same instance, the limits restored.
            streamed = np.array(lyap.safe_set)
            limits(False)
            with uncounted():
                lyap.update_safe_set()
            limits(True)
            fused = np.array(lyap.safe_set)
            values = lyap.values.cpu().numpy()
            differ = np.flatnonzero(streamed != fused)
            v_bad = values[first] if first is not None else np.inf
            print("the fused sweep of the same instance: {} safe states "
                  "against the stream's {}; {} differ, tied with v_bad = {!r} "
                  "below its index {} ({} states hold that value)".format(
                      int(fused.sum()), int(streamed.sum()), len(differ),
                      float(v_bad), first, int((values == v_bad).sum())))
            if not (np.all(values[differ] == v_bad)
                    and not fused[differ].any()
                    and np.all(differ < (first or 0))):
                raise AssertionError("the fused and streamed sweeps differ "
                                     "beyond the ties at v_bad")
        with uncounted():
            waits = host_waits(lyap.update_safe_set)
        print("host waits in a streamed sweep of {} batches: {}".format(
            batches, dict(waits)))
        if any(n >= batches for n in waits.values()):
            raise AssertionError("the streamed sweep waits for the device "
                                 "once a batch")
    finally:
        limits(False)


def giant_batch_inputs(lyap, batch):
    """Kernel 1's inputs at the 10^8 sweep's first batch: its states made
    on the card, the policy's actions, the GP."""
    states = lyap.discretization.states_in_range(0, batch)
    gp = lyap.dynamics
    return pipelined_predict.kernel_inputs(
        gp, concatenate_inputs(states, lyap.policy(states))), gp


def phase_giant_sweep(card):
    """``safe_learning_tpu_torch.benchmarks.giant_sweep_1e8.run`` at its
    sizes: ``bench.py``'s instance on 10001x10001 = 100,020,001 points,
    streamed in batches of 2^21 (48 a sweep). Before the sweeps, kernel 1
    at the first batch's inputs within ``rounding_bounds`` of its plain
    version. Checks (the module's and these): kernel 1 launched once a
    batch in each sweep and no other kernel; the two sweeps equal; no
    certified state of the 400,000 sampled fails the float64 oracle and
    ``level_ok``. Prints each stage, checks/s, the sweeps' CUDA-event ms
    and the peak device memory. Returns ``(lyap, launches, out)``: kernel
    1's launches over the run (the margin's calibration included) and the
    module's results."""
    giant = giant_sweep_1e8
    builds = dict(build_reports)
    grid = st.GridWorld([[-1.0, 1.0], [-1.0, 1.0]], giant.POINTS)
    with uncounted():
        gp = giant.bench_gp()
        states = grid.states_in_range(0, giant.BATCH)
        inputs = pipelined_predict.kernel_inputs(
            gp, concatenate_inputs(states, torch.zeros_like(states[:, :1])))
        em, ev, ratio = compare(inputs, "rbf", count=gp.count)
    print("10^8 sweep, first batch (Q={}): kernel 1 max|dmean|={:.3e} "
          "max|dvar|={:.3e} err/bound={:.3f}".format(
              giant.BATCH, em, ev, ratio))
    if not ratio <= 1.0:
        raise AssertionError("kernel 1 disagrees at the 10^8 sweep's batch")
    del inputs, states
    reset_launches()
    start = time.perf_counter()
    out = giant.run(giant.POINTS, giant.BATCH, giant.ORACLE_SAMPLES)
    seconds = time.perf_counter() - start
    launches = read_launches()
    per_sweep = -(-giant.POINTS ** 2 // giant.BATCH)
    print("10^8 sweep: {!r} s for the phase; kernel launches {}; {} a sweep "
          "in each of the two sweeps ({} batches); peak device memory {!r} "
          "GB [{}]".format(seconds, launches,
                           [s["launches"] for s in out["sweeps"]], per_sweep,
                           out["peak_bytes"] / 1e9, card))
    if (any(s["launches"] != per_sweep for s in out["sweeps"])
            or set(n for n, c in launches.items() if c) != {"gp_predict"}):
        raise AssertionError("the 10^8 sweep did not launch kernel 1 once a "
                             "batch")
    if dict(build_reports) != builds:
        raise AssertionError("the 10^8 sweep built a library")
    return out["lyap"], launches["gp_predict"], out


# ---------------------------------------------------------------------------
# The sharded sweeps: the dryrun's ranks, full width over two ranks, and the
# single-process mesh
# ---------------------------------------------------------------------------
#: Ranks of the full-width sharded runs; they share the one card (gloo).
SHARDED_RANKS = 2

#: Seconds each child process of ``phase_sharded`` may take, start-up
#: included; also the collectives' timeout in the full-width ranks.
SHARDED_TIMEOUT_S = 300

#: Entries of the single-process meshes over ``cuda:0``.
MESH_ENTRIES = (1, 2, 4)


def sha1(arr):
    """A hash of an array's bytes (tensors through the host)."""
    if torch.is_tensor(arr):
        arr = arr.detach().cpu().numpy()
    return hashlib.sha1(np.ascontiguousarray(arr).tobytes()).hexdigest()


def sweep_record(lyap, sweep, warm=True):
    """Run ``sweep()`` (after one untimed run with ``warm``): its wall
    seconds, CUDA-event ms and kernel launches, and what every rank must
    hold after it (the safe set's hash and size, ``c_max``, and up to
    2^24 states the refinement levels' hash)."""
    if warm:
        sweep()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    reset_launches()
    torch.cuda.synchronize()
    start = time.perf_counter()
    events[0].record()
    sweep()
    events[1].record()
    torch.cuda.synchronize()
    return dict(seconds=time.perf_counter() - start,
                device_ms=events[0].elapsed_time(events[1]),
                launches=read_launches(), safe=sha1(np.asarray(
                    lyap.safe_set)), safe_sum=int(np.sum(lyap.safe_set)),
                c_max=float(lyap.c_max),
                refinement=(sha1(lyap._refinement)
                            if lyap.discretization.nindex <= 2 ** 24
                            else None))


def kernel_device_ms(sweep):
    """``(GP kernel ms, device busy ms)`` of one ``sweep()`` under
    ``profiling.trace``: the device time of the GP kernels' launches
    (``PROFILE_GROUPS``' first group) and of every device operation."""
    from torch.autograd import DeviceType

    with tempfile.TemporaryDirectory() as log_dir:
        with profiling.trace(log_dir) as prof:
            sweep()
            torch.cuda.synchronize()
    kernel = busy = 0.0
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        ms = (ev.self_cuda_time_total if us is None else us) / 1e3
        busy += ms
        if any(f in ev.key.lower() for f in PROFILE_GROUPS[0][1]):
            kernel += ms
    return kernel, busy


def restored_adaptive(path):
    """The adaptive example's instance with the state saved at ``path``
    (``checkpoints.lyapunov_state``: the GP at count 181 refactorized from
    its data, as every rank restores it)."""
    lyap, _ = build_adaptive_instance()
    target = st.checkpoints.lyapunov_state(lyap)
    state = st.checkpoints.restore_checkpoint(path, target)
    return st.checkpoints.restore_lyapunov_state(lyap, state)


def sharded_worker(argv):
    """One rank of ``phase_sharded``'s full-width runs
    (``chip_smoke.py --sharded-worker SPEC RANK WORLD ADDRESS``): join the
    gloo group on ``cuda:0`` and, over the global mesh, sweep the bench
    instance (the fused sweep, kernel 1), the 10^8 instance (the streamed
    sweep, kernel 1 once a batch of this rank's run of batches) and the
    adaptive instance restored from the checkpoint at count 181 (a
    certify at refinement 16, kernel 3's panel body), each with the
    margins the single-process path had (the bench and the certify timed
    at their second run), then one more under the profiler
    (``kernel_device_ms``); then the all-reduce latency. Prints one JSON
    line."""
    from safe_learning_tpu_torch.parallel import distributed

    spec_path, rank, world, address = argv
    with open(spec_path) as f:
        spec = json.load(f)
    if not torch.cuda.is_available():
        raise SystemExit("sharded worker: no CUDA device")
    distributed.initialize_distributed(address, int(world), int(rank),
                                       backend="gloo", device="cuda:0",
                                       timeout=SHARDED_TIMEOUT_S)
    try:
        mesh = distributed.make_global_mesh()
        out = dict(rank=int(rank), device=str(st.config.device),
                   mesh=[str(d) for d in mesh.devices.flat])
        inst = build_bench_instance(1000)
        lyap = st.Lyapunov(inst["grid"], inst["v"], inst["gp"], inst["lf"],
                           inst["lv"], inst["tau"], inst["policy"],
                           initial_set=inst["initial_set"])
        lyap.certificate_margin, lyap.level_margin = spec["bench_margins"]
        lyap.mesh = mesh
        out["bench"] = sweep_record(lyap, lyap.update_safe_set)
        out["bench"]["kernel_ms"], out["bench"]["busy_ms"] = \
            kernel_device_ms(lyap.update_safe_set)
        del lyap, inst

        giant = giant_sweep_1e8
        inst = giant.bench_instance(giant.POINTS, giant.BATCH)
        lyap = st.Lyapunov(inst["grid"], inst["v"], inst["gp"], inst["lf"],
                           inst["lv"], inst["tau"], inst["policy"],
                           initial_set=inst["initial_set"])
        lyap.certificate_margin, lyap.level_margin = spec["giant_margins"]
        lyap.mesh = mesh
        sweep = functools.partial(lyap.update_safe_set,
                                  batch_size=giant.BATCH)
        out["streamed"] = sweep_record(lyap, sweep, warm=False)
        out["streamed"]["bad"] = list(lyap.last_stream_bad)
        out["streamed"]["kernel_ms"], out["streamed"]["busy_ms"] = \
            kernel_device_ms(sweep)
        del lyap, inst

        lyap = restored_adaptive(spec["adaptive_checkpoint"])
        lyap.mesh = mesh
        sweep = functools.partial(lyap.update_safe_set,
                                  max_refinement=ADAPTIVE_REFINEMENT)
        out["adaptive"] = sweep_record(lyap, sweep)
        out["adaptive"]["count"] = int(lyap.dynamics.count)
        out["adaptive"]["kernel_ms"], out["adaptive"]["busy_ms"] = \
            kernel_device_ms(sweep)
        del lyap
        out["allreduce_s"] = distributed.allreduce_latency()
        out["peak_bytes"] = torch.cuda.max_memory_allocated()
        print(json.dumps(out), flush=True)
    finally:
        distributed.shutdown_distributed()


#: The dryrun module's runs on the card: ``(backend, ranks)``. NCCL refuses
#: two ranks on one card, so it runs one.
DRYRUNS = (("gloo", 2), ("nccl", 1))


def dryrun_commands():
    """The command of each ``DRYRUNS`` run, on ``cuda:0``."""
    return [[sys.executable, "-m", "safe_learning_tpu_torch.parallel.dryrun",
             "--nprocs", str(n), "--backend", backend, "--device", "cuda:0",
             "--timeout", str(SHARDED_TIMEOUT_S)] for backend, n in DRYRUNS]


def check_dryruns(card, results):
    """Each ``DRYRUNS`` run to its OK line (``results``: ``run_ranks``'
    output of ``dryrun_commands``), every rank on the card with kernels 1
    and 3 launched. Prints each rank's phase seconds, launches, all-reduce
    latency and peak memory; returns each run's rank records."""
    records = {}
    for (backend, n), (code, out, err) in zip(DRYRUNS, results):
        lines = out.strip().splitlines()
        if code != 0 or not lines or not lines[-1].startswith(
                "multiprocess dryrun OK: {} ranks".format(n)):
            print(out[-4000:])
            print(err[-4000:], file=sys.stderr)
            raise AssertionError("the dryrun over {} {} rank(s) failed (exit "
                                 "{})".format(n, backend, code))
        ranks = [json.loads(line) for line in lines[-1 - n:-1]]
        for rec in ranks:
            launched = collections.Counter()
            for counts in rec["launches"].values():
                launched.update(counts)
            print("dryrun, {} rank {} of {}: device {}, phase seconds {}, "
                  "kernel launches {}, all-reduce {!r} s, peak device "
                  "memory {!r} GB [{}]".format(
                      backend, rec["rank"], n, rec["device"], rec["seconds"],
                      rec["launches"], rec["allreduce_s"],
                      rec["peak_bytes"] / 1e9, card))
            if (rec["device"] != "cuda:0" or rec["backend"] != backend
                    or launched["gp_predict"] < 1
                    or launched["gp_predict_stacked"] < 1):
                raise AssertionError("dryrun rank {} ({}): not on the card "
                                     "or kernels 1 and 3 not launched"
                                     .format(rec["rank"], backend))
        print(lines[-1])
        records[backend] = ranks
    return records


def phase_sharded(card, bench_lyap, giant_lyap, adaptive):
    """The sharded sweeps on the card (``parallel``).

    1. ``python -m safe_learning_tpu_torch.parallel.dryrun`` over 2 gloo
       ranks and over 1 NCCL rank on ``cuda:0`` (``DRYRUNS``,
       ``check_dryruns``);
    2. at the same time, full width over ``SHARDED_RANKS`` gloo ranks
       sharing the card (``sharded_worker``): the bench sweep (kernel 1 on each rank's
       half), bit for bit ``bench_lyap``'s safe set and ``c_max``; the
       10^8 streamed sweep, 24 batches a rank, with ``(v_bad, i_bad)``,
       ``c_max``, the safe set and its size ``giant_lyap``'s; one certify
       of the adaptive instance at count 181 and refinement 16 (kernel 3's
       panel body), restored on every rank from a checkpoint of phase 10's
       state, equal to the same certify without a mesh in this process.
       Every rank on the card launches its kernel: kernel 1, or kernel 3
       for the certify;
    3. the bench sweep on ``make_mesh(devices=["cuda:0"] * k)`` for each
       ``MESH_ENTRIES``, each bit for bit the sweep without a mesh, and
       ``benchmarks/mesh_scaling.py``'s sweep over 1, 2 and 4 shards.

    Prints each path's wall time, each rank's CUDA-event ms, launches and
    peak memory, and the all-reduce latency, beside the card. Two ranks
    share one card: the times say nothing of scaling across cards.
    Returns a namespace: the per-rank launches by path, the restored
    adaptive instance and the dryruns' records.
    """
    from safe_learning_tpu_torch.benchmarks import mesh_scaling
    from safe_learning_tpu_torch.parallel import distributed, make_mesh

    bench_ref = dict(safe=sha1(np.asarray(bench_lyap.safe_set)),
                     c_max=float(bench_lyap.c_max))
    giant_ref = dict(safe=sha1(np.asarray(giant_lyap.safe_set)),
                     safe_sum=int(np.sum(giant_lyap.safe_set)),
                     c_max=float(giant_lyap.c_max),
                     bad=list(giant_lyap.last_stream_bad))
    for lyap in (bench_lyap, giant_lyap):
        if np.ndim(lyap.certificate_margin):
            raise AssertionError("phase_sharded passes scalar margins")
    with tempfile.TemporaryDirectory() as tmp:
        path = st.checkpoints.save_checkpoint(
            os.path.join(tmp, "adaptive"),
            st.checkpoints.lyapunov_state(adaptive.lyap))
        spec = os.path.join(tmp, "spec.json")
        with open(spec, "w") as f:
            json.dump(dict(
                bench_margins=[bench_lyap.certificate_margin,
                               bench_lyap.level_margin],
                giant_margins=[giant_lyap.certificate_margin,
                               giant_lyap.level_margin],
                adaptive_checkpoint=path), f)
        address = "localhost:{}".format(distributed.free_port())

        def reference():
            # The same certify without a mesh, restored as the ranks
            # restore it, while they run.
            restored = restored_adaptive(path)
            with uncounted():
                return restored, sweep_record(restored, lambda: (
                    restored.update_safe_set(
                        max_refinement=ADAPTIVE_REFINEMENT)), warm=False)

        # The dryruns and the full-width ranks at once: the ranks' times
        # are taken beside the dryruns' processes.
        start = time.perf_counter()
        runs, (restored, adaptive_ref) = distributed.run_ranks(
            dryrun_commands() + [
                [sys.executable, os.path.abspath(__file__),
                 "--sharded-worker", spec, str(r), str(SHARDED_RANKS),
                 address] for r in range(SHARDED_RANKS)],
            SHARDED_TIMEOUT_S, meanwhile=reference)
        wall = time.perf_counter() - start
    dryruns = check_dryruns(card, runs[:len(DRYRUNS)])
    ranks = []
    for rank, (code, out, err) in enumerate(runs[len(DRYRUNS):]):
        if code != 0:
            print(err[-4000:], file=sys.stderr)
            raise AssertionError("sharded rank {} failed (exit {})".format(
                rank, code))
        ranks.append(json.loads(out.strip().splitlines()[-1]))
    refs = {"bench": bench_ref, "streamed": giant_ref,
            "adaptive": adaptive_ref}
    kernel = {"bench": "gp_predict", "streamed": "gp_predict",
              "adaptive": "gp_predict_stacked"}
    print("sharded: {!r} s wall for the dryruns' and the {} full-width "
          "ranks' processes, all at once [{}]".format(wall, SHARDED_RANKS,
                                                      card))
    print("adaptive certify without a mesh (restored, count {}; beside the "
          "ranks' start-up): {!r} s, {!r} ms of CUDA events, {} safe, c_max "
          "{!r} [{}]".format(
              restored.dynamics.count, adaptive_ref["seconds"],
              adaptive_ref["device_ms"], adaptive_ref["safe_sum"],
              adaptive_ref["c_max"], card))
    for rec in ranks:
        if rec["device"] != "cuda:0" or rec["mesh"] != ["cuda:0"] * len(
                ranks):
            raise AssertionError("rank {} is not on the card: {}".format(
                rec["rank"], rec["device"]))
        for path, ref in refs.items():
            got = rec[path]
            print("sharded {} rank {}: {!r} s, {!r} ms of CUDA events, "
                  "its GP kernel's launches {!r} ms and every device "
                  "operation {!r} ms of device time (a profiled sweep), "
                  "launches {}, {} safe, c_max {!r}{} [{}]".format(
                      path, rec["rank"], got["seconds"], got["device_ms"],
                      got["kernel_ms"], got["busy_ms"],
                      {k: v for k, v in got["launches"].items() if v},
                      got["safe_sum"], got["c_max"],
                      ", (v_bad, i_bad) {}".format(got["bad"])
                      if "bad" in got else "", card))
            same = all(got[k] == ref[k] for k in ref
                       if k in ("safe", "c_max", "bad", "safe_sum",
                                "refinement"))
            if not same:
                raise AssertionError("sharded {} on rank {} differs from "
                                     "the single-process sweep: {} against "
                                     "{}".format(path, rec["rank"], got,
                                                 ref))
            if got["launches"][kernel[path]] < 1:
                raise AssertionError("sharded {} on rank {} never launched "
                                     "{}".format(path, rec["rank"],
                                                 kernel[path]))
        print("rank {}: all-reduce {!r} s (gloo), peak device memory {!r} "
              "GB [{}]".format(rec["rank"], rec["allreduce_s"],
                               rec["peak_bytes"] / 1e9, card))
    per_batch = [r["streamed"]["launches"]["gp_predict"] for r in ranks]
    if sum(per_batch) != -(-giant_sweep_1e8.POINTS ** 2
                           // giant_sweep_1e8.BATCH):
        raise AssertionError("the sharded 10^8 sweep did not launch kernel "
                             "1 once a batch: {}".format(per_batch))

    # 3. The single-process mesh over cuda:0, and the scaling benchmark.
    ref_safe, ref_c = np.array(bench_lyap.safe_set), bench_lyap.c_max
    with uncounted():
        rec = sweep_record(bench_lyap, bench_lyap.update_safe_set)
    print("bench without a mesh: update_safe_set {!r} s, {!r} ms of CUDA "
          "events [{}]".format(rec["seconds"], rec["device_ms"], card))
    for entries in MESH_ENTRIES:
        bench_lyap.mesh = make_mesh(devices=["cuda:0"] * entries)
        try:
            with uncounted():
                rec = sweep_record(bench_lyap, bench_lyap.update_safe_set)
        finally:
            bench_lyap.mesh = None
        print("bench on a mesh of {} x cuda:0: update_safe_set {!r} s, "
              "{!r} ms of CUDA events, kernel-1 launches {} [{}]".format(
                  entries, rec["seconds"], rec["device_ms"],
                  rec["launches"]["gp_predict"], card))
        if not (np.array_equal(bench_lyap.safe_set, ref_safe)
                and bench_lyap.c_max == ref_c
                and rec["launches"]["gp_predict"] == entries):
            raise AssertionError("the bench sweep over {} mesh entries "
                                 "differs".format(entries))
    with uncounted():
        mesh_scaling.run(max_shards=max(MESH_ENTRIES), iters=5)
    return types.SimpleNamespace(
        launches={path: [r[path]["launches"][kernel[path]] for r in ranks]
                  for path in refs},
        adaptive=restored, dryruns=dryruns)


def shard_rows(n, rank, ranks=SHARDED_RANKS):
    """The ``(start, stop)`` of ``rank``'s shard of ``n`` rows."""
    from safe_learning_tpu_torch.parallel.mesh import split_rows

    return split_rows(n, ranks)[rank]


def sharded_paths(card, bench_lyap, giant_lyap, sharded):
    """The sharded paths of the ``kernels`` line: each kernel against its
    plain version at one rank's inputs (the bench's first shard, the 10^8
    sweep's first batch of the second rank, the adaptive certify's coarse
    pass over its first shard), with the ranks' launches from
    ``phase_sharded`` (their sum, and per rank)."""
    keys = ("max_abs_err", "ms", "plain_ms", "eager_ms", "bound_ms",
            "bound_by", "bound_kind", "library_ms")
    grid = bench_lyap.discretization
    lo, hi = shard_rows(grid.nindex, 0)
    states = grid.states_in_range(lo, hi)
    bench_inputs = pipelined_predict.kernel_inputs(
        bench_lyap.dynamics, concatenate_inputs(states,
                                                bench_lyap.policy(states)))
    giant = giant_sweep_1e8
    batches = -(-giant.POINTS ** 2 // giant.BATCH)
    start = shard_rows(batches, 1)[0] * giant.BATCH
    states = giant_lyap.discretization.states_in_range(start,
                                                       start + giant.BATCH)
    giant_inputs = pipelined_predict.kernel_inputs(
        giant_lyap.dynamics, concatenate_inputs(states,
                                                giant_lyap.policy(states)))
    paths = []
    for path, label, inputs, gp in (
            ("bench_sharded_2", "bench, shard 1 of 2", bench_inputs,
             bench_lyap.dynamics),
            ("streamed_1e8_sharded_2", "10^8 sweep, rank 2's first batch",
             giant_inputs, giant_lyap.dynamics)):
        entry = dict(zip(keys, stationary_times(card, inputs, gp, label)))
        launches = sharded.launches["bench" if path.startswith("bench")
                                    else "streamed"]
        entry.update(launches=sum(launches), rank_launches=launches)
        paths.append(("gp_predict", path, entry))
    lyap = sharded.adaptive
    order = torch.sort(lyap.values, stable=True).indices
    lo, hi = shard_rows(lyap.discretization.nindex, 0)
    points = lyap.discretization.states_at(order[lo:hi])
    inputs, programs = stacked_inputs(lyap, points)
    entry = panel_times(card, "coarse pass, shard 1 of 2", inputs, programs,
                        lyap.dynamics.count)
    entry.update(launches=sum(sharded.launches["adaptive"]),
                 rank_launches=sharded.launches["adaptive"])
    paths.append(("gp_predict_stacked", "adaptive_certify_sharded_2", entry))
    return paths


def phase_region_tools(card, lyap):
    """``get_lyapunov_region`` and ``smallest_boundary_value`` on the
    1000x1000 bench candidate (``v = |x|^2`` of ``lyap``) from the node
    nearest the origin: the native flood fill (``use_native=True``, built
    with ``g++`` at first use) equal to the Python path; against the
    native fill over float64 values computed on the host, every differing
    state within 8 float32 ulps of the value at which the fill stops (the
    boundary's minimum), where float32 rounding reorders the heap; the
    boundary minimum equal to the float64 one to the working dtype's
    rounding."""
    from safe_learning_tpu_torch.lyapunov import (get_lyapunov_region,
                                                  smallest_boundary_value)

    grid = lyap.discretization
    v = lyap.lyapunov_function
    init = (grid.shape[0] // 2 - 1, grid.shape[1] // 2 - 1)
    regions, times = {}, {}
    for name, native in (("native", True), ("python", False)):
        start = time.perf_counter()
        regions[name] = get_lyapunov_region(v, grid, init,
                                            use_native=native)
        times[name] = time.perf_counter() - start
    with st.oracle._oracle_env():
        start = time.perf_counter()
        regions["float64"] = get_lyapunov_region(st.oracle.lift64(v), grid,
                                                 init, use_native=True)
        times["float64"] = time.perf_counter() - start
        low64 = smallest_boundary_value(st.oracle.lift64(v), grid)
    low = smallest_boundary_value(v, grid)
    print("region tools on {}: get_lyapunov_region from {}: {} states "
          "(native, {!r} s), {} (Python, {!r} s), {} (float64 on the host, "
          "native, {!r} s); smallest_boundary_value {!r} (float64 {!r}) "
          "[{}]".format(grid.shape, init, int(regions["native"].sum()),
                        times["native"], int(regions["python"].sum()),
                        times["python"], int(regions["float64"].sum()),
                        times["float64"], low, low64, card))
    if not np.array_equal(regions["native"], regions["python"]):
        raise AssertionError("the native and the Python regions differ")
    # The float64 values order the heap differently only where rounding
    # moves a state across the value at which the fill stops (the first
    # boundary node it pops, the boundary's minimum for this bowl).
    differ = np.flatnonzero(regions["native"] != regions["float64"])
    v64 = st.oracle._oracle_values(lyap, grid.points_at(differ))
    near = np.abs(v64 - low64) <= 8 * np.finfo(np.float32).eps * abs(low64)
    print("region tools: the float32 and float64 regions differ at {} "
          "states, {} of them within 8 float32 ulps of the stopping value "
          "{!r}".format(len(differ), int(near.sum()), low64))
    if not near.all():
        raise AssertionError("the float32 region differs from the float64 "
                             "one away from the stopping value")
    if not regions["native"].any() or regions["native"][0, :].any():
        raise AssertionError("the region is empty or reaches the boundary")
    if not abs(low - low64) <= 4 * np.finfo(np.float32).eps * abs(low64):
        raise AssertionError("smallest_boundary_value {} against float64 {}"
                             .format(low, low64))


def phase_one_d_example(card):
    """``examples/one_d_example.py --full`` through the port's script
    (``...examples.one_d_example.run(full=True)``): 1000 states, 101
    actions, 20 updates, the composite GP (``Matern32 x Linear`` over
    ``(x, u)``) at capacity 32 and counts 0 to 20: kernel 2.

    Checks, each raising: every GP predict on the card launched kernel 2
    exactly once and nothing else launched or was built; each of those
    predicts (its inputs rebuilt from the GP and the queries, recorded
    as it ran) within ``program_bounds`` of kernel 2's plain version; the
    JAX package's record (``examples/README.md:61``: 0.050 -> 1.000 over
    20 measurements, ``c_max`` 1.0000) and the example's assertions; a
    fresh last certify through ``oracle_gate``. Returns ``(lyap,
    launches)``."""
    from safe_learning_tpu_torch.examples import one_d_example as example

    kernel = gp_kernel.gp_predict_general_cuda
    builds = dict(build_reports)
    predicts = []

    def count_predicts(fn):
        @functools.wraps(fn)
        def predict(self, points, full_cov=False):
            before = kernel.launches
            out = fn(self, points, full_cov)
            predicts.append((self, torch.atleast_2d(
                st.functions.base.as_tensor(points)).detach(),
                             full_cov, out[0].device.type,
                             kernel.launches - before))
            return out
        return predict

    reset_launches()
    with patched(st.GaussianProcess, "predict", count_predicts):
        result = example.run(full=True, seed=0)
    launches = read_launches()
    on_card = [p for p in predicts if not p[2] and p[3] == "cuda"]
    print("1-D example: {} GP predicts on the card, {} elsewhere; kernel "
          "launches {}; initial fraction {!r}; history {}; c_max {!r}; "
          "closed loop from {!r} to |x| {!r}; policy optimization {!r} s, "
          "{} updates {!r} s [{}]".format(
              len(on_card), len(predicts) - len(on_card), launches,
              result.initial_fraction, " ".join(
                  "{:.3f}".format(f) for f in result.fractions),
              result.c_max, result.x0, result.final, result.policy_s,
              result.n_updates, result.loop_s, card))
    if (any(p[4] != 1 for p in on_card)
            or launches != dict({n: 0 for n in KERNELS},
                                gp_predict_general=len(on_card))):
        raise AssertionError("kernel 2 did not carry every predict once")
    if dict(build_reports) != builds:
        raise AssertionError("the 1-D example built a library")
    worst = 0.0
    with uncounted():
        for gp, points, _, _, _ in on_card:
            inputs, programs = general_inputs(gp, points.to(gp.X_buf))
            _, _, ratio = compare_program("general", inputs, programs,
                                          count=gp.count)
            worst = max(worst, ratio)
    print("1-D example: each of the {} predicts against kernel 2's plain "
          "version: worst err/bound {:.3f}".format(len(on_card), worst))
    if not worst <= 1.0:
        raise AssertionError("kernel 2 disagrees on a 1-D example predict")
    history = result.fractions
    if not ("{:.3f}".format(result.initial_fraction) == "0.050"
            and "{:.3f}".format(history[-1]) == "1.000"
            and "{:.4f}".format(result.c_max) == "1.0000"):
        raise AssertionError("the 1-D example parts from the record (0.050 "
                             "-> 1.000, c_max 1.0000)")
    lyap = result.lyap
    with uncounted():
        lyap.update_safe_set()
        initial = np.asarray(lyap.initial_safe_set)
        oracle_gate(lyap, "1-D example last certify", initial=initial)
    return lyap, launches["gp_predict_general"]


def general_inputs(gp, states):
    """Kernel 2's inputs for the GP ``gp`` at state-action rows ``states``
    (``s2`` on the device, for CUDA graphs), and its program as a
    1-tuple."""
    program, params = gp_kernel.compile_kernel_program(
        gp.kernel, input_dim=gp.input_dim)
    s2 = torch.tensor(gp.scale ** 2, dtype=states.dtype,
                      device=states.device)
    return (states, gp.X_buf, gp_kernel.program_params(params, states),
            gp.chol_inv, gp.alpha, gp._mask(), s2), (program,)


#: Joint actor-critic iterations of the pendulum example in this script
#: (the example's --full: 400); its seed: the quick run of the CPU tests
#: stabilizes at seed 1, not at 0.
PENDULUM_JOINT_ITERS = 100
PENDULUM_SEED = 1


def phase_examples(card):
    """Three example scripts at their ``--full`` widths, each with its own
    assertions: ``basic_dynamic_programming`` (30x30, reaches the goal),
    through its command line (with ``--plot`` into a temporary directory
    only where matplotlib is installed, and then its PNG must exist; the
    H100 machine's installation has none, so there it runs without
    ``--plot`` and the script says so), and
    ``lyapunov_function_learning`` (251^2, its checkpoint round trip
    restoring the network bit for bit, the network's safe set growing
    beyond the LQR quadratic's) at full depth, and
    ``reinforcement_learning_pendulum`` (101^2 ROAs, 600 steps) with its
    joint iterations cut from 400 to ``PENDULUM_JOINT_ITERS``. No kernel
    launches (none of them has a GP)."""
    from safe_learning_tpu_torch.examples import (
        basic_dynamic_programming, lyapunov_function_learning,
        reinforcement_learning_pendulum)

    reset_launches()
    start = time.perf_counter()
    plot = importlib.util.find_spec("matplotlib") is not None
    with tempfile.TemporaryDirectory() as plot_dir:
        dp = basic_dynamic_programming.main(
            ["--full"] + ["--plot", "--plot-dir", plot_dir] * plot)
        png = os.path.join(plot_dir, "basic_dynamic_programming.png")
        png_bytes = os.path.getsize(png) if os.path.exists(png) else 0
    dp_s = time.perf_counter() - start
    print("basic_dynamic_programming --full{}: {} outer iterations, value "
          "change {!r}, policy change {!r}; the goal in {} steps; policy "
          "iteration {!r} s, the script {!r} s; {} [{}]".format(
              " --plot" * plot, dp.info["iterations"],
              dp.info["value_change"], dp.info["policy_change"],
              len(dp.trajectory), dp.policy_s, dp_s,
              "its PNG {} bytes".format(png_bytes) if plot else
              "--plot not run: matplotlib is not installed", card))
    if plot and not png_bytes:
        raise AssertionError("basic_dynamic_programming --plot wrote no "
                             "PNG")
    start = time.perf_counter()
    lfl = lyapunov_function_learning.run(full=True)
    lfl_s = time.perf_counter() - start
    print("lyapunov_function_learning --full: NN {:.1%} of the true ROA "
          "against LQR {:.1%} and SOS {:.1%}; fractions {}; c_max {}; true "
          "ROA {!r} s, pre-training {!r} s, classification {!r} s, the "
          "script {!r} s [{}]".format(
              lfl.nn_vs_roa, lfl.lqr_vs_roa, lfl.sos_vs_roa, " ".join(
                  "{:.3f}".format(f) for f in lfl.frac_history),
              " ".join("{:.4g}".format(c) for c in lfl.c_history),
              lfl.roa_s, lfl.pretrain_s, lfl.train_s, lfl_s, card))
    print("reinforcement_learning_pendulum: --full widths, joint "
          "actor-critic iterations cut from 400 to {} ({} SGD steps of "
          "44,500), seed {}".format(
              PENDULUM_JOINT_ITERS, 500 + 110 * PENDULUM_JOINT_ITERS,
              PENDULUM_SEED))
    start = time.perf_counter()
    rl = reinforcement_learning_pendulum.run(
        full=True, seed=PENDULUM_SEED, joint_iters=PENDULUM_JOINT_ITERS)
    rl_s = time.perf_counter() - start
    print("reinforcement_learning_pendulum (cut): learned ROA {!r} against "
          "LQR {!r}; final norm {!r}; TD fit error {!r}; {} steps at {!r} "
          "ms; ROAs {!r} s; the script {!r} s [{}]".format(
              rl.fractions["learned"], rl.fractions["lqr"], rl.final_norm,
              rl.value_err, rl.steps, rl.step_ms, rl.roa_s, rl_s, card))
    if any(read_launches().values()):
        raise AssertionError("an example without a GP launched a kernel")


def stationary_product_ms(inputs, kind, count):
    """The yardstick ``library_ms`` of kernel 1: the solve's product alone,
    ``torch.matmul(chol_inv[:n, :n], K)``, ``K`` (``n x Q``, scaled and
    masked) computed beforehand, TF32 off, on the device alone
    (``graph_ms``), over column blocks where ``K`` would be large
    (``product_blocks``)."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on for matmul")
    q, x, chol_inv, _, mask, var_s2 = inputs
    blocks = product_blocks(q.shape[0], count)
    q = q[:blocks[0][1]]
    r2 = None
    for i in range(q.shape[1]):
        diff = x[:count, i][:, None] - q[:, i][None, :]
        r2 = diff * diff if r2 is None else r2 + diff * diff
    del diff
    k = (st.functions.gp.STATIONARY_COVARIANCES[kind](r2) * var_s2
         * mask[:count, None]).contiguous()
    del r2
    li = chol_inv[:count, :count].contiguous()
    return graph_ms(blocked_product([li], [k], blocks))


TRANSCENDENTAL_SAMPLES = 2 ** 24

#: Grid states per device pass of the derived margins' bound sweep.
DERIVE_BATCH = 2 ** 18
#: Refined sub-points of the adaptive instance held to the derived bound
#: against the float64 oracle (as the 10^8 phase samples its oracle).
DERIVED_SUBPOINT_SAMPLE = 400_000


#: The functions torch runs on each path, by dtype, each over the range it
#: is checked on. float32 (the policy's and the candidate's activations,
#: the ODE dynamics, the plain GP route's covariances): exp over its normal
#: outputs, sin and cos far beyond the first reduction steps, tanh and
#: sigmoid across their saturation. float64 (the extended pipeline): the
#: same, exp and sigmoid over float64's wider range.
TRANSCENDENTALS = {
    torch.float32: (("exp", torch.exp, -87.0, 88.0),
                    ("sin", torch.sin, -1.0e4, 1.0e4),
                    ("cos", torch.cos, -1.0e4, 1.0e4),
                    ("tanh", torch.tanh, -20.0, 20.0),
                    ("sigmoid", torch.sigmoid, -80.0, 80.0)),
    torch.float64: (("exp", torch.exp, -708.0, 709.0),
                    ("sin", torch.sin, -1.0e4, 1.0e4),
                    ("cos", torch.cos, -1.0e4, 1.0e4),
                    ("tanh", torch.tanh, -20.0, 20.0),
                    ("sigmoid", torch.sigmoid, -700.0, 700.0))}

#: ``numpy.longdouble`` twins of the float64 functions.
LONGDOUBLE = {"exp": np.exp, "sin": np.sin, "cos": np.cos, "tanh": np.tanh,
              "sigmoid": lambda x: 1.0 / (1.0 + np.exp(-x))}


def relative_error(name, fn, x, y):
    """The largest ``|y - f(x)| / |f(x)|`` over ``f(x) != 0``, with ``f``
    in float64 on the card (float32 ``x``)."""
    ref = fn(x.double())
    rel = (y.double() - ref).abs() / ref.abs()
    return float(rel[ref != 0].max())


def longdouble_error(task):
    """``relative_error`` of float64 arrays ``task = (name, x, y)`` against
    ``LONGDOUBLE[name]`` in ``numpy.longdouble`` on the host."""
    name, x, y = task
    ref = LONGDOUBLE[name](x.astype(np.longdouble))
    keep = ref != 0
    rel = np.abs(y.astype(np.longdouble) - ref)[keep] / np.abs(ref[keep])
    return float(rel.max())


def transcendental_ulps(card, dtype, chunk=2 ** 22):
    """The worst relative error of each of ``TRANSCENDENTALS[dtype]`` on the
    card, in units of the dtype's unit roundoff (2^-24, 2^-53), over
    ``TRANSCENDENTAL_SAMPLES`` evenly spaced arguments of its range and as
    many in ``[-4, 4]``, against ``relative_error``'s reference.

    The factor charges one unit per function and must be at least each
    measured worst error: ``config.fp_error_factor`` in float32 (a
    fast-math build, with ``__expf`` and ``__sinf``, would show tens of
    units at large arguments), ``ops.extended_verify.FP_ERROR_FACTOR64`` in
    float64, where the host's ``longdouble`` must keep at least 60 mantissa
    bits (exact far beyond float64). Returns ``{name: worst}``.
    """
    unit = torch.finfo(dtype).eps / 2.0
    if dtype == torch.float64:
        nmant = int(np.finfo(np.longdouble).nmant)
        if nmant < 60:
            raise AssertionError("numpy.longdouble keeps {} mantissa bits on "
                                 "this host; the float64 check needs 60"
                                 .format(nmant))
        reference = "numpy.longdouble ({} mantissa bits)".format(nmant)
        factor = ("FP_ERROR_FACTOR64", extended_verify.FP_ERROR_FACTOR64)
    else:
        reference = "float64"
        factor = ("config.fp_error_factor", st.config.fp_error_factor)
    worst, tasks = {}, []
    for name, fn, lo, hi in TRANSCENDENTALS[dtype]:
        x = torch.cat([
            torch.linspace(lo, hi, TRANSCENDENTAL_SAMPLES, device="cuda",
                           dtype=dtype),
            torch.linspace(-4.0, 4.0, TRANSCENDENTAL_SAMPLES, device="cuda",
                           dtype=dtype)])
        y = fn(x)
        if dtype == torch.float32:
            worst[name] = max(relative_error(name, fn, x[i:i + chunk],
                                             y[i:i + chunk])
                              for i in range(0, len(x), chunk)) / unit
        else:
            x, y = x.cpu().numpy(), y.cpu().numpy()
            tasks += [(name, x[i:i + chunk], y[i:i + chunk])
                      for i in range(0, len(x), chunk)]
    if tasks:
        # numpy's longdouble functions hold the GIL: worker processes,
        # forked (they run numpy alone, never CUDA).
        with concurrent.futures.ProcessPoolExecutor(
                min(8, os.cpu_count() or 1),
                mp_context=multiprocessing.get_context("fork")) as pool:
            for (name, _, _), err in zip(tasks, pool.map(longdouble_error,
                                                         tasks)):
                worst[name] = max(worst.get(name, 0.0), err / unit)
    print("{} transcendentals on the card, worst relative error in units of "
          "2^-{} against {} ({} + {} arguments each): {}; {} {!r} "
          "[{}]".format(str(dtype).split(".")[-1],
                        int(-np.log2(unit)), reference,
                        TRANSCENDENTAL_SAMPLES, TRANSCENDENTAL_SAMPLES,
                        ", ".join("{} {:.3f}".format(k, v)
                                  for k, v in worst.items()),
                        factor[0], factor[1], card))
    over = {k: v for k, v in worst.items() if v > factor[1]}
    if over:
        raise AssertionError("{} {} is below the measured error of {}".format(
            factor[0], factor[1], over))
    return worst


#: Seeded queries of ``longdouble_check`` at each input set.
LONGDOUBLE_QUERIES = 10_000

#: The covariances of ``STATIONARY_COVARIANCES`` in ``numpy.longdouble``.
_LD_COV = {
    "rbf": lambda r2: np.exp(-0.5 * r2),
    "matern12": lambda r2: np.exp(-np.sqrt(r2 + 1e-36)),
    "matern32": lambda r2: _ld_matern(np.sqrt(3 * r2 + 1e-36), 0.0),
    "matern52": lambda r2: _ld_matern(np.sqrt(5 * r2 + 1e-36), 1.0 / 3),
}


def _ld_matern(r, c2):
    return (1 + r + c2 * r * r) * np.exp(-r)


def _ld_program(program, params, x, q):
    """A covariance program's ``(cap, Q)`` k in ``numpy.longdouble`` (``x``
    ``(cap, d)``, ``q`` ``(Q, d)``), as ``gp_kernel._eval_program``."""
    op = program[0]
    if op == "stationary":
        _, fam, sel, ls_off, var_off = program
        r2 = 0
        for j, dim in enumerate(sel):
            diff = (x[:, dim][:, None] - q[:, dim][None, :]) * params[
                ls_off + j]
            r2 = r2 + diff * diff
        return params[var_off] * _LD_COV[fam](r2)
    if op == "linear":
        _, sel, v_off = program
        return sum(params[v_off + j]
                   * (x[:, dim][:, None] * q[:, dim][None, :])
                   for j, dim in enumerate(sel))
    left = _ld_program(program[1], params, x, q)
    right = _ld_program(program[2], params, x, q)
    return left + right if op == "sum" else left * right


def _ld_lower_product(li, k, block=32):
    """``li @ k`` for a lower-triangular ``li`` in ``numpy.longdouble``,
    by row blocks over the columns at or below the block's last row, on 8
    threads over 1024-column slices of ``k`` (numpy's matmul releases the
    GIL)."""
    out = np.empty((li.shape[0], k.shape[1]), dtype=np.longdouble)

    def columns(c0):
        c1 = min(k.shape[1], c0 + 1024)
        for r0 in range(0, li.shape[0], block):
            r1 = min(li.shape[0], r0 + block)
            out[r0:r1, c0:c1] = li[r0:r1, :r1] @ k[:r1, c0:c1]

    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        list(pool.map(columns, range(0, k.shape[1], 1024)))
    return out


def longdouble_queries(queries):
    """Row indices of ``longdouble_check``'s seeded queries."""
    rng = np.random.default_rng(LONGDOUBLE_QUERIES)
    return np.sort(rng.choice(queries.shape[0],
                              min(LONGDOUBLE_QUERIES, queries.shape[0]),
                              replace=False))


def longdouble_ratios(outs, inputs, count, kind=None, programs=None):
    """The errors of float64 predict outputs ``outs = (mean, var)`` against
    ``numpy.longdouble``, over the bound the float64 margins assume: every
    operation rounds by at most ``extended_verify.U_EFF`` (``u``), and the
    solve chain of ``errorbounds._gp_terms`` carries it, with ``n =
    count`` and ``g = n u / (1 - n u)``:

        r = |L| (|k| + 2 dk),  da = |L| dk + (g + u) r,
        a_tot = |a| + 2 da,
        |d mean| <= da^T |alpha| + (g + 2u) a_tot^T |alpha|,
        |d var|  <= sum(2 a_tot da + g a_tot^2) + u sum(a^2),

    where ``dk`` is k's own error at ``u``: ``(16 + 2 r^2) u |k|`` for
    kernel 1 (``kind``; ``rounding_bounds``' count), ``_eval_bounded``'s
    plus the scale and the mask for kernels 2 and 3 (``programs``: one
    ``chol_inv`` and ``alpha`` column per program). ``inputs`` are the
    kernel's, at the queries of ``outs``. ``longdouble`` keeps at least 60
    bits (``transcendental_ulps``), so its own rounding is 2^-7 of one
    unit at most. Returns ``[(max |d mean|, max |d var|, mean ratio, var
    ratio)]``, one per output."""
    u = extended_verify.U_EFF
    n = count
    g = n * u / (1 - n * u)

    def ld(t):
        return t.detach().cpu().numpy().astype(np.longdouble)

    def f64(t):
        return t.detach().double().cpu().numpy()

    q, x = inputs[0], inputs[1]
    xl, ql = ld(x[:n]), ld(q)
    mean_k, var_k = outs
    if kind is not None:
        _, _, li, alpha, mask, s2 = inputs
        mean_k, var_k = f64(mean_k)[:, None, :], f64(var_k)[:, None]
        r2 = sum((xl[:, c][:, None] - ql[:, c][None, :]) ** 2
                 for c in range(x.shape[1]))
        k = _LD_COV[kind](r2) * ld(mask[:n])[:, None] * np.longdouble(
            float(s2))
        ks = [k]
        dks = [(16 + 2 * r2.astype(np.float64)) * u
               * np.abs(k.astype(np.float64))]
        lis, alphas = [li], [alpha]
    else:
        _, _, params, li, alpha, mask, s2 = inputs
        lis = [li] if li.dim() == 2 else list(li)
        alphas = ([alpha] if li.dim() == 2
                  else [alpha[s][:, None] for s in range(len(programs))])
        mean_k = f64(mean_k).reshape(q.shape[0], len(lis), -1)
        var_k = f64(var_k).reshape(q.shape[0], len(lis))
        scale = ld(mask[:n])[:, None] * np.longdouble(float(s2))
        ks, dks = [], []
        for program in programs:
            ks.append(_ld_program(program, ld(params), xl, ql) * scale)
            _, kabs, err = _eval_bounded(program, params.double().cpu(),
                                         x[:n].double().cpu().T,
                                         q.double().cpu().T, u)
            dks.append(u * (err + 2 * kabs).numpy() * float(s2)
                       * f64(mask[:n])[:, None])
    tiny = np.finfo(np.float64).tiny
    result = []
    for s, (li, alpha, k, dk) in enumerate(zip(lis, alphas, ks, dks)):
        a = _ld_lower_product(ld(li[:n, :n]), k)
        mean_ld = (a.T @ ld(alpha[:n])).astype(np.float64)
        var_ld = (a * a).sum(axis=0).astype(np.float64)
        l_abs, al_abs = np.abs(f64(li[:n, :n])), np.abs(f64(alpha[:n]))
        a64 = np.abs(a.astype(np.float64))
        da = l_abs @ dk + (g + u) * (l_abs @ (np.abs(k.astype(np.float64))
                                              + 2 * dk))
        a_tot = a64 + 2 * da
        b_mean = da.T @ al_abs + (g + 2 * u) * (a_tot.T @ al_abs)
        b_var = ((2 * a_tot * da + g * a_tot ** 2).sum(0)
                 + u * (a64 ** 2).sum(0))
        e_mean = np.abs(mean_k[:, s, :] - mean_ld)
        e_var = np.abs(var_k[:, s] - var_ld)
        result.append((float(e_mean.max()), float(e_var.max()),
                       float((e_mean / np.maximum(b_mean, tiny)).max()),
                       float((e_var / np.maximum(b_var, tiny)).max())))
    return result


def longdouble_check(card, label, inputs, count, kind=None, programs=None):
    """``longdouble_ratios`` of the float64 kernel on the card (kernel 1
    with ``kind``, kernel 2 or 3 with ``programs``) at
    ``LONGDOUBLE_QUERIES`` seeded queries of one path's inputs; prints
    each output's errors and shares and fails if one exceeds 1."""
    idx = longdouble_queries(inputs[0])
    q = inputs[0][torch.as_tensor(idx, device=inputs[0].device)]
    inputs = (q.contiguous(),) + tuple(inputs[1:])
    if kind is not None:
        outs = gp_kernel.gp_predict_cuda(*inputs, kind=kind, count=count)
    elif inputs[3].dim() == 2:
        outs = gp_kernel.gp_predict_general_cuda(*inputs, programs[0],
                                                 count=count)
    else:
        outs = gp_kernel.gp_predict_stacked_cuda(*inputs, programs,
                                                 count=count)
    torch.cuda.synchronize()
    results = longdouble_ratios(outs, inputs, count, kind, programs)
    for s, (em, ev, rm, rv) in enumerate(results):
        print("float64 kernel against numpy.longdouble, {} output {} ({} "
              "queries, count {}): max |d mean| {!r}, max |d var| {!r}; "
              "share of the U_EFF bound: mean {!r}, var {!r} [{}]".format(
                  label, s, len(idx), count, em, ev, rm, rv, card))
    worst = max(max(rm, rv) for _, _, rm, rv in results)
    print("float64 kernel against numpy.longdouble, {}: largest error over "
          "the U_EFF bound {!r} (must be <= 1) [{}]".format(label, worst,
                                                            card))
    if not worst <= 1.0:
        raise AssertionError("the float64 kernel's error at the {} inputs "
                             "exceeds the bound the float64 margins assume "
                             "(ratio {!r})".format(label, worst))
    return worst


def synchronised_s(fn):
    """``(fn(), seconds)``, the wall time between two synchronisations."""
    torch.cuda.synchronize()
    start = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - start


def float32_margins(lyap, states, tau):
    """``decrease - threshold`` of the working-dtype sweep at the device
    ``states`` against ``tau`` (the dynamics through the kernels), as a
    float64 host array."""
    decrease = _decrease_bound(
        lyap.lyapunov_function, lyap._lipschitz_lyapunov, states,
        lyap.dynamics(states, lyap.policy(states)))
    threshold = _threshold(lyap._lipschitz_lyapunov,
                           lyap._lipschitz_dynamics, states, tau)
    return (decrease - threshold).double().reshape(-1).cpu().numpy()


def contained(lyap, oracle_safe, label):
    """The certified set lies inside the float64 oracle's."""
    outside = int((np.asarray(lyap.safe_set) & ~oracle_safe).sum())
    if outside:
        raise AssertionError("{}: {} certified states lie outside the f64 "
                             "oracle's safe set".format(label, outside))


def exploration_check(lyap, card, unit):
    """``get_safe_sample`` with a per-point margin installed takes the
    per-candidate path; every candidate's float32 future value is within
    its derived margin of the float64 one, and the chosen row's float32
    and float64 future values both lie below ``c_max`` minus its
    margin."""
    rows = []
    with patched(explore_mod, "_per_candidate_margin",
                 recorded(rows, lambda args, out: (args[1], out))):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            (pair, bound), seconds = synchronised_s(
                lambda: st.get_safe_sample(
                    lyap, perturbations=np.linspace(-0.1, 0.1, 5)[:, None],
                    limits=[[-1.0, 1.0]], num_samples=1000,
                    rng=np.random.default_rng(0)))
    fallbacks = [str(w.message) for w in caught]
    if len(rows) != 1 or rows[0][1] is None or fallbacks:
        raise AssertionError("get_safe_sample did not take the per-candidate "
                             "path ({} derivations, {})".format(
                                 len(rows), fallbacks))
    candidates, margins = rows[0]
    with uncounted():
        _, _, f32 = explore_mod._future_values(
            lyap.dynamics, lyap.lyapunov_function, lyap._lipschitz_lyapunov,
            st.functions.base.as_tensor(candidates))
        f32 = f32.double().cpu().numpy()
    lifted = [st.oracle.lift64(f) for f in (
        lyap.dynamics, lyap.lyapunov_function, lyap._lipschitz_lyapunov)]
    with st.oracle._oracle_env():
        _, _, f64 = explore_mod._future_values(
            *lifted, torch.as_tensor(candidates, dtype=torch.float64))
        f64 = f64.numpy()
    err = np.abs(f32 - f64)
    best = int(np.flatnonzero((candidates == pair).all(axis=1))[0])
    print("exploration on bench: get_safe_sample {!r} s with the per-point "
          "margin installed (unit {!r}), per-candidate margins over {} rows "
          "({!r} to {!r}), |f32 - f64| future values up to {!r}, largest "
          "share of its margin {!r}; chosen row {} (summed error {!r}): "
          "float32 future {!r}, float64 future {!r}, c_max {!r}, its margin "
          "{!r}, c_max - margin {!r} [{}]".format(
              seconds, unit, len(candidates), float(margins.min()),
              float(margins.max()), float(err.max()),
              float((err / margins).max()), pair[0].tolist(), bound,
              float(f32[best]), float(f64[best]), lyap.c_max,
              float(margins[best]), lyap.c_max - float(margins[best]),
              card))
    if not (err <= margins).all():
        raise AssertionError("a candidate's float32 future value is farther "
                             "than its derived margin from the float64 one")
    # The model gives f64 < f32 + margin < c_max; the chosen row here also
    # keeps its float64 value below c_max - margin.
    if not (f32[best] < lyap.c_max - margins[best]
            and f64[best] < lyap.c_max - margins[best]):
        raise AssertionError("the chosen row fails the exact level test")


def phase_derived_margins(card, adaptive):
    """``errorbounds`` on the card at full width (``DERIVE_BATCH`` states a
    device pass), after ``transcendental_ulps``.

    bench (``build_bench_instance(1000)``, kernel 1): the per-point and
    the scalar derived margin; at all 10^6 states the float32 margin
    through kernel 1 lies within the per-point bound of the float64
    oracle's (the largest share printed); the sweeps with the derived
    scalar and per-point margins installed certify inside the oracle's set
    at a level at or below its; the derived margin beside
    ``calibrate_certificate_margin``'s. Exploration (``exploration_check``)
    at the level the measured margin certifies, with the per-point derived
    margin installed.

    adaptive (``phase_adaptive``'s instance at count 181, kernel 3's panel
    body): ``analytic_certificate_margin(refinement=16, per_point=True)``
    and ``update_safe_set(max_refinement=16)``; ``DERIVED_SUBPOINT_SAMPLE``
    seeded refined sub-points within their state's bound of the float64
    oracle at the bound sweep's own coordinates; ``check_certify`` with no
    band. Kernel 1 and kernel 3 must each launch on their part of the path
    (counts set to 0 before, read after; the checks' launches uncounted).
    """
    start = time.perf_counter()
    transcendental_ulps(card, torch.float32)
    eb = st.errorbounds
    unit = eb._unit_roundoff()

    inst = build_bench_instance(1000)
    lyap = st.Lyapunov(inst["grid"], inst["v"], inst["gp"], inst["lf"],
                       inst["lv"], inst["tau"], inst["policy"],
                       initial_set=inst["initial_set"])
    grid = lyap.discretization
    reset_launches()
    bound, per_point_s = synchronised_s(
        lambda: eb.analytic_certificate_margin(
            lyap, batch_size=DERIVE_BATCH, per_point=True, set_margin=False))
    margin, scalar_s = synchronised_s(
        lambda: eb.analytic_certificate_margin(lyap,
                                               batch_size=DERIVE_BATCH))
    lyap.update_safe_set()
    derived = (float(lyap.safe_set.mean()), lyap.c_max)
    with uncounted():
        m64 = st.oracle.oracle_margins(lyap, grid.all_points)
        oracle_safe, c_ref = st.oracle.oracle_safe_set(lyap, margins=m64)
        contained(lyap, oracle_safe, "bench, derived scalar margin")
        gate_2(lyap.c_max, c_ref)
        m32 = float32_margins(lyap, lyap._device_points(), lyap.tau)
    lyap.certificate_margin = bound
    lyap._certificate_margin_unit = unit
    lyap.update_safe_set()
    launches = read_launches()
    per_point = (float(lyap.safe_set.mean()), lyap.c_max)
    contained(lyap, oracle_safe, "bench, derived per-point margin")
    gate_2(lyap.c_max, c_ref)
    if launches["gp_predict"] < 1:
        raise AssertionError("the derived-margin sweeps never launched "
                             "kernel 1")
    err = np.abs(m32 - m64)
    share = err / bound
    with uncounted():
        measured = st.oracle.calibrate_certificate_margin(lyap)
        lyap.update_safe_set()
    measured_safe = (float(lyap.safe_set.mean()), lyap.c_max)
    contained(lyap, oracle_safe, "bench, measured margin")
    print("derived margins on bench (10^6 states, kernel 1): per-point "
          "bound {!r} s, scalar {!r} s (batches of {}); scalar margin {!r} "
          "(per-point {!r} to {!r}, median {!r}) against the measured "
          "{!r}: {!r}x; |f32 - f64| margins up to {!r}, largest share of "
          "the per-point bound {!r} (state {}), {} states over it; safe "
          "fraction: derived scalar {!r} (c_max {!r}), derived per-point "
          "{!r} (c_max {!r}), measured {!r} (c_max {!r}), f64 oracle {!r} "
          "(c_max {!r}); kernel launches {} [{}]".format(
              per_point_s, scalar_s, DERIVE_BATCH, margin,
              float(bound.min()), float(bound.max()),
              float(np.median(bound)), measured, margin / measured,
              float(err.max()), float(share.max()), int(share.argmax()),
              int((err > bound).sum()), derived[0], derived[1],
              per_point[0], per_point[1], float(lyap.safe_set.mean()),
              lyap.c_max, float(oracle_safe.mean()), c_ref, launches, card))
    if not (err <= bound).all():
        raise AssertionError("kernel 1's float32 error exceeds the derived "
                             "per-point bound at {} states".format(
                                 int((err > bound).sum())))
    # The derived margin certifies about the exempt set alone here, where
    # every candidate's derived margin exceeds c_max: the exploration runs
    # at the measured margin's level, the per-point margin installed.
    lyap.certificate_margin = bound
    lyap._certificate_margin_unit = unit
    exploration_check(lyap, card, unit)
    # The float64 oracle and the float32 margins' results, for phase_rigor.
    bench = types.SimpleNamespace(
        margins=m64, safe=oracle_safe, c_max=c_ref, measured=measured,
        measured_safe=measured_safe, derived=margin, derived_safe=derived)
    del lyap, m32, err, share

    r = ADAPTIVE_REFINEMENT
    base = adaptive.lyap
    lyap = st.Lyapunov(base.discretization, base.lyapunov_function,
                       base.dynamics, base._lipschitz_dynamics,
                       base._lipschitz_lyapunov, base.tau, base.policy,
                       initial_set=np.flatnonzero(adaptive.inst["initial"]),
                       adaptive=True)
    grid = lyap.discretization
    reset_launches()
    bound, derive_s = synchronised_s(
        lambda: eb.analytic_certificate_margin(
            lyap, batch_size=DERIVE_BATCH, refinement=r, per_point=True))
    _, certify_s = synchronised_s(
        lambda: lyap.update_safe_set(max_refinement=r))
    launches = read_launches()
    if launches["gp_predict_stacked"] < 1:
        raise AssertionError("the adaptive certify never launched kernel 3")
    with uncounted():
        band = st.oracle.calibrate_certificate_margin(lyap, refinement=r,
                                                      set_margin=False)
        rng = np.random.default_rng(0)
        idx = rng.integers(0, grid.nindex, DERIVED_SUBPOINT_SAMPLE)
        sub = rng.integers(0, r ** grid.ndim, DERIVED_SUBPOINT_SAMPLE)
        points = lyap._device_points()
        offsets = refinement_offsets(grid.unit_maxes, r, points)
        states = (points[torch.as_tensor(idx, device=points.device)]
                  + offsets[torch.as_tensor(sub, device=points.device)])
        m32 = np.concatenate([
            float32_margins(lyap, states[i:i + 2 ** 18], lyap.tau / r)
            for i in range(0, len(idx), 2 ** 18)])
        # The bound sweep's own sub-point: the float32 sum of the state and
        # its float64 offset rounded to float32.
        steps = (np.arange(r) + 0.5) / r - 0.5
        unit64 = np.asarray(grid.unit_maxes, np.float64)
        off64 = np.stack(np.meshgrid(*[steps] * grid.ndim, indexing="ij"),
                         axis=-1).reshape(-1, grid.ndim) * unit64
        model = (grid.points_at(idx).astype(np.float32)
                 + off64[sub].astype(np.float32))
        moved = int((model != states.cpu().numpy()).any(axis=1).sum())
        oracle_start = time.perf_counter()
        m64 = st.oracle.oracle_margins(lyap, model, tau=lyap.tau / r)
        oracle_s = time.perf_counter() - oracle_start
        err = np.abs(m32 - m64)
        share = err / bound[idx]
        check_certify(lyap, adaptive.inst["initial"], 0.0, r,
                      "adaptive, derived per-point margin")
    print("derived margins on adaptive ({} states, refinement {}, count "
          "{}, kernel 3's panel body): per-point bound {!r} s (batches of "
          "{}, {} passes), certify {!r} s; margin {!r} to {!r} "
          "(median {!r}) against the measured {!r}: {!r}x; {} sampled "
          "refined sub-points ({} where the sweep's coordinate differs "
          "from the bound sweep's), |f32 - f64| up to {!r}, largest share "
          "of the bound {!r}, {} over it; f64 oracle {!r} s; safe fraction "
          "{!r} (c_max {!r}, max N(x) {}) against the example's {!r}; "
          "kernel launches {} [{}]".format(
              grid.nindex, r, lyap.dynamics.count, derive_s, DERIVE_BATCH,
              r ** grid.ndim + 1, certify_s, float(bound.min()),
              float(bound.max()),
              float(np.median(bound)), band, float(bound.max()) / band,
              len(idx), moved, float(err.max()), float(share.max()),
              int((err > bound[idx]).sum()), oracle_s,
              float(lyap.safe_set.mean()), lyap.c_max,
              int(lyap._refinement.max()), float(base.safe_set.mean()),
              launches, card))
    if not (err <= bound[idx]).all():
        raise AssertionError("kernel 3's float32 error exceeds the derived "
                             "bound at {} refined sub-points".format(
                                 int((err > bound[idx]).sum())))
    print("derived margins phase: {:.3f} s".format(
        time.perf_counter() - start))
    adaptive_result = types.SimpleNamespace(
        derived_max=float(bound.max()), measured=band,
        fraction=float(lyap.safe_set.mean()), c_max=lyap.c_max)
    return bench, adaptive_result


# ---------------------------------------------------------------------------
# The rigor ladder: float64 decrease checks on the card
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def launch_dtypes(log, tag=None):
    """Every launch of kernels 1 to 3 in the block appended to ``log`` as
    the dtype of its queries, or as ``(dtype, tag())`` when ``tag`` is
    given, below the wrappers (their counters untouched)."""
    def note(dtype):
        log.append(dtype if tag is None else (dtype, tag()))

    def stationary(fn):
        @functools.wraps(fn)
        def record(*args, **kwargs):
            out = fn(*args, **kwargs)
            if out[2]:
                note(args[3].dtype)
            return out
        return record

    def program(fn):
        @functools.wraps(fn)
        def record(*args):
            launched = fn(*args)
            if launched:
                note(args[1].dtype)
            return launched
        return record

    with patched(gp_kernel, "launch_stationary", stationary), \
            patched(gp_kernel, "_launch_program", program):
        yield


def counted_calls(log, keep):
    """A wrapper that appends ``(keep(args), launches)`` of each call to
    ``log``: ``launches`` the kernel launches made inside it, over every
    counter."""
    def wrap(fn):
        @functools.wraps(fn)
        def record(*args, **kwargs):
            before = sum(read_launches().values())
            out = fn(*args, **kwargs)
            log.append((keep(args), sum(read_launches().values()) - before))
            return out
        return record
    return wrap


def rigor_sweeps(lyap, label, card, oracle_safe, r=1, reps=3):
    """``update_safe_set(extended=True)`` and ``extended="hybrid"`` of
    ``lyap`` (its extended margin installed) from the same state, ``reps``
    times each in turns, each synchronised: the wall times, the sets, the
    hybrid's band fraction, each one's launches by kernel and dtype, and
    its refinement chunks (``ExtendedSweep.refined_negative_batch``) as
    ``(states, kernel launches in the call)``. Both sets must lie inside
    ``oracle_safe`` (when given) and equal each other bit for bit, with
    ``c_max`` and the refinement levels."""
    kwargs = dict(max_refinement=r) if r > 1 else {}
    initial = np.array(lyap.initial_safe_set)
    runs = {True: [], "hybrid": []}
    out = {}
    # The hybrid's band margin is derived once, keyed like the sweep.
    lyap._get_extended_sweep()
    _, band_s = synchronised_s(lyap._get_hybrid_band_margin)
    for mode in ([True, "hybrid", "hybrid", True] * reps)[:2 * reps]:
        lyap.safe_set = initial.copy()
        dtypes, chunks = [], []
        reset_launches()
        with launch_dtypes(dtypes), patched(
                extended_verify.ExtendedSweep, "refined_negative_batch",
                counted_calls(chunks, lambda args: args[1])):
            _, seconds = synchronised_s(
                lambda: lyap.update_safe_set(extended=mode, **kwargs))
        runs[mode].append(seconds)
        out[mode] = dict(
            safe=np.array(lyap.safe_set), c_max=lyap.c_max,
            refinement=np.array(lyap._refinement), launches=read_launches(),
            f64=sum(t == torch.float64 for t in dtypes),
            f32=sum(t == torch.float32 for t in dtypes),
            band=lyap.last_band_fraction, chunks=chunks)
    ext, hyb = out[True], out["hybrid"]
    print("{} rigor sweeps: extended=True {!r} s (runs {!r}), safe fraction "
          "{!r}, c_max {!r}, kernel launches {} float64 / {} float32; "
          "extended='hybrid' {!r} s (runs {!r}; band margin derived in {!r} "
          "s), safe fraction {!r}, c_max {!r}, band fraction {!r}, kernel "
          "launches {} float64 / {} float32 [{}]".format(
              label, statistics.median(runs[True]), runs[True],
              float(ext["safe"].mean()), ext["c_max"], ext["f64"],
              ext["f32"], statistics.median(runs["hybrid"]), runs["hybrid"],
              band_s, float(hyb["safe"].mean()), hyb["c_max"], hyb["band"],
              hyb["f64"], hyb["f32"], card))
    if ext["f64"] < 1 or ext["f32"] or hyb["f32"] < 1:
        raise AssertionError("{}: the extended sweep must launch the "
                             "kernels in float64 only, the hybrid's first "
                             "pass in float32".format(label))
    if not (np.array_equal(ext["safe"], hyb["safe"])
            and ext["c_max"] == hyb["c_max"]
            and np.array_equal(ext["refinement"], hyb["refinement"])):
        raise AssertionError("{}: the hybrid set differs from the extended "
                             "one ({} states)".format(
                                 label, int((ext["safe"] != hyb["safe"])
                                            .sum())))
    if oracle_safe is not None:
        for mode, res in out.items():
            outside = int((res["safe"] & ~oracle_safe).sum())
            if outside:
                raise AssertionError("{} ({}): {} certified states lie "
                                     "outside the f64 oracle's set".format(
                                         label, mode, outside))
    return ext, hyb, statistics.median(runs[True]), statistics.median(
        runs["hybrid"])


def rigor_certify_times():
    """``chip_smoke.py --rigor-certify``: phase 21's adaptive certify
    alone, to time two trees' kernels in turns (``python -P chip_smoke.py
    --rigor-certify`` with ``PYTHONPATH`` naming the tree whose package
    runs): the adaptive example at ``--full`` (count 181), a fresh
    ``Lyapunov`` as ``phase_rigor`` builds it, its per-state extended
    margin, then ``rigor_sweeps`` (3 of each mode, in turns, hybrid =
    extended checked). Prints one JSON line: the package's directory,
    the card, each mode's median and runs in wall seconds, the safe
    states and ``c_max``."""
    card = phase_device()
    r = ADAPTIVE_REFINEMENT
    base = adaptive_safety_verification.run(full=True).lyap
    lyap = st.Lyapunov(base.discretization, base.lyapunov_function,
                       base.dynamics, base._lipschitz_dynamics,
                       base._lipschitz_lyapunov, base.tau, base.policy,
                       initial_set=np.flatnonzero(base.initial_safe_set),
                       adaptive=True)
    extended_verify.extended_certificate_margin(
        lyap, refinement=r, per_point=True, batch_size=DERIVE_BATCH)
    ext, _, ext_s, hyb_s = rigor_sweeps(lyap, "adaptive", card, None, r=r,
                                        reps=3)
    print(json.dumps({"package": os.path.dirname(st.__file__),
                      "card": card, "count": int(lyap.dynamics.count),
                      "extended_s": ext_s, "hybrid_s": hyb_s,
                      "safe": int(ext["safe"].sum()),
                      "c_max": float(ext["c_max"])}))


def extended_sample_check(lyap, card):
    """``get_safe_sample(extended=True)`` on the certified bench: the
    margin derived at ``U_EFF`` over exactly its candidate rows, float64
    scoring on the card, and the chosen row's float64 future value on the
    host below ``c_max`` minus that margin."""
    ev = extended_verify
    rows, margins = [], []
    with patched(explore_mod, "_host_candidates", recorded(rows)), \
            patched(ev, "extended_exploration_margin", recorded(margins)):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            (pair, bound), seconds = synchronised_s(
                lambda: st.get_safe_sample(
                    lyap, perturbations=np.linspace(-0.1, 0.1, 5)[:, None],
                    limits=[[-1.0, 1.0]], num_samples=1000,
                    rng=np.random.default_rng(0), extended=True))
    if caught or len(rows) != 1 or len(margins) != 1:
        raise AssertionError("get_safe_sample(extended=True) fell back or "
                             "derived no margin ({})".format(
                                 [str(w.message) for w in caught]))
    margin = float(margins[0])
    lifted = [st.oracle.lift64(f) for f in (
        lyap.dynamics, lyap.lyapunov_function, lyap._lipschitz_lyapunov)]
    with st.oracle._oracle_env():
        _, _, f64 = explore_mod._future_values(
            *lifted, torch.as_tensor(pair, dtype=torch.float64))
    f64 = float(f64[0])
    print("exploration on bench, extended: get_safe_sample {!r} s over {} "
          "candidate rows, margin derived at U_EFF {!r}; chosen row {} "
          "(summed error {!r}), float64 future value {!r} < c_max - margin "
          "= {!r} [{}]".format(seconds, len(rows[0]), margin,
                               pair[0].tolist(), bound, f64,
                               lyap.c_max - margin, card))
    if not f64 < lyap.c_max - margin:
        raise AssertionError("the extended exploration row fails the exact "
                             "level test")


def float64_view(sweep, points):
    """The float64 copy of an extended sweep as a Lyapunov-like object for
    the kernel timings (``sweep_inputs``, ``program_times``,
    ``stacked_inputs``): its policy and dynamics at ``points`` widened."""
    points64 = points.double()
    return types.SimpleNamespace(policy=sweep._policy,
                                 dynamics=sweep._dynamics,
                                 _device_points=lambda: points64)


def in_float64(fn):
    """``fn`` run with the working dtype float64 on the card (the float64
    copies make their inputs there), and its numbers tagged ``float64``
    for ``kernel_rows``."""
    def run():
        with st.oracle._oracle_env(st.config.device):
            numbers = fn()
        keys = ("max_abs_err", "ms", "plain_ms", "eager_ms", "bound_ms",
                "bound_by", "bound_kind", "library_ms")
        entry = (dict(numbers) if isinstance(numbers, dict)
                 else dict(zip(keys, numbers)))
        entry["dtype"] = "float64"
        # Kernels 1-3 in float64 run the product on DMMA (tiled and panel
        # bodies, gp_predict_common.cuh); ``sass_check`` shows it.
        entry["design"] = "dmma"
        return entry
    return run


#: The seed of ``lyapunov_function_learning --full --extended``, one at
#: which its assertion (the network certifies more of the true ROA than
#: the LQR quadratic's 70.3 %) holds on the card and on the CPU. Not every
#: seed passes: the extended mode's 1 % hinge slack holds the network
#: within a few points of LQR, and the port's float32 unit
#: (``config.fp_error_factor`` 6, the JAX package's 4) makes each
#: certify's level margin 1.5 times the JAX package's. At the JAX
#: package's unit the port certifies the JAX package's networks to the
#: same sets (``scripts/lyapunov_learning_certify.py``). The pass rates
#: over seeds (``scripts/lyapunov_learning_seeds.py``) are in ROADMAP's
#: queue 3.
RIGOR_LEARNING_SEED = 2


def phase_rigor(card, bench, adaptive, adaptive_derived):
    """The rigor ladder on the card (``ops.extended_verify``): float64
    decrease checks through kernels 1 to 3 in float64.

    First ``transcendental_ulps`` in float64. bench
    (``build_bench_instance(1000)``, kernel 1 in float64 at count 128):
    ``extended_certificate_margin`` (its time), the float64 check's margin
    within it of the float64 oracle's at all 10^6 states (``bench``, phase
    19's oracle), then ``rigor_sweeps`` (extended and hybrid in turns, both
    inside the oracle's set, equal bit for bit, the band fraction) beside
    the float32 sweep's time and the measured margin's, the float32 derived
    margin's and the oracle's safe fractions; ``extended_sample_check``.
    adaptive (phase 10's instance at count 181, kernel 3's float64 panel
    body): the per-state margin at refinement 16,
    ``DERIVED_SUBPOINT_SAMPLE`` seeded refined sub-points within it of the
    float64 oracle, ``rigor_sweeps`` at refinement 16 and ``check_certify``
    with no band, kernel 3's float64 launches split between the coarse
    passes and the refinement chunks (the last chunk's sub-points kept for
    its timing). Then the drivers ``one_d_region_of_attraction_estimate
    --full`` with ``--extended`` and ``--hybrid`` (kernel 2 in float64) and
    ``lyapunov_function_learning --full --extended`` at
    ``RIGOR_LEARNING_SEED``, their own assertions.
    Counts are set to 0 before each part and read after; each part must
    launch its kernel. Returns the float64 paths for ``kernel_rows``:
    ``(name, path, launches, time)``, ``time()`` giving the numbers after
    the count cases.
    """
    from safe_learning_tpu_torch.examples import (
        lyapunov_function_learning, one_d_region_of_attraction_estimate)

    start = time.perf_counter()
    ev = extended_verify
    transcendental_ulps(card, torch.float64)
    paths = []

    inst = build_bench_instance(1000)
    lyap = st.Lyapunov(inst["grid"], inst["v"], inst["gp"], inst["lf"],
                       inst["lv"], inst["tau"], inst["policy"],
                       initial_set=inst["initial_set"])
    f32_runs = []
    for _ in range(3):
        f32_runs.append(synchronised_s(lyap.update_safe_set)[1])
    m_ext, derive_s = synchronised_s(
        lambda: ev.extended_certificate_margin(lyap,
                                               batch_size=DERIVE_BATCH))
    sweep = lyap._get_extended_sweep()
    points = lyap._device_points()
    gap = np.abs(sweep.margins(points) - bench.margins)
    print("rigor on bench (10^6 states, kernel 1 in float64, count {}): "
          "extended margin {!r} derived in {!r} s (the float32 derived "
          "margin {!r}: {!r}x; the measured {!r}), level margin {!r}; "
          "|float64 check - f64 oracle| up to {!r}, {!r} of the margin, {} "
          "states over it [{}]".format(lyap.dynamics.count, m_ext, derive_s,
                           bench.derived, bench.derived / m_ext,
                           bench.measured, lyap.level_margin,
                           float(gap.max()), float(gap.max() / m_ext),
                           int((gap > m_ext).sum()), card))
    if not (gap <= m_ext).all():
        raise AssertionError("the float64 check departs from the f64 oracle "
                             "by more than the extended margin at {} states"
                             .format(int((gap > m_ext).sum())))
    ext, hyb, ext_s, hyb_s = rigor_sweeps(lyap, "bench", card, bench.safe)
    gate_2(ext["c_max"], bench.c_max)
    print("rigor on bench: safe fraction extended {!r} (c_max {!r}), hybrid "
          "{!r}, band fraction {!r}; the float32 sweep {!r} s (runs {!r}) "
          "against the extended {!r} s ({!r}x) and the hybrid {!r} s; "
          "measured margin {!r} (c_max {!r}), float32 derived {!r} (c_max "
          "{!r}), f64 oracle {!r} (c_max {!r}) [{}]".format(
              float(ext["safe"].mean()), ext["c_max"],
              float(hyb["safe"].mean()), hyb["band"],
              statistics.median(f32_runs), f32_runs, ext_s,
              ext_s / statistics.median(f32_runs), hyb_s,
              bench.measured_safe[0], bench.measured_safe[1],
              bench.derived_safe[0], bench.derived_safe[1],
              float(bench.safe.mean()), bench.c_max, card))
    lyap.update_safe_set(extended=True)
    extended_sample_check(lyap, card)
    bench_view = float64_view(sweep, points)
    with st.oracle._oracle_env(st.config.device):
        inputs, gp = sweep_inputs(bench_view)
        longdouble_check(card, "bench (kernel 1)", inputs, gp.count,
                         kind="rbf")
        del inputs, gp
    paths.append(("gp_predict", "bench_extended_float64",
                  ext["launches"]["gp_predict"],
                  in_float64(lambda: phase_times(card, bench_view,
                                                 "bench float64"))))
    del gap, lyap

    r = ADAPTIVE_REFINEMENT
    base = adaptive.lyap
    lyap = st.Lyapunov(base.discretization, base.lyapunov_function,
                       base.dynamics, base._lipschitz_dynamics,
                       base._lipschitz_lyapunov, base.tau, base.policy,
                       initial_set=np.flatnonzero(adaptive.inst["initial"]),
                       adaptive=True)
    grid = lyap.discretization
    m_ext, derive_s = synchronised_s(
        lambda: ev.extended_certificate_margin(
            lyap, refinement=r, per_point=True, batch_size=DERIVE_BATCH))
    sweep = lyap._get_extended_sweep()
    rng = np.random.default_rng(0)
    idx = rng.integers(0, grid.nindex, DERIVED_SUBPOINT_SAMPLE)
    sub = rng.integers(0, r ** grid.ndim, DERIVED_SUBPOINT_SAMPLE)
    points = lyap._device_points()
    offsets = refinement_offsets(grid.unit_maxes, r, points)
    states = (points[torch.as_tensor(idx, device=points.device)]
              + offsets[torch.as_tensor(sub, device=points.device)])
    ext64 = np.concatenate([
        sweep.margins(states[i:i + 2 ** 18], tau=lyap.tau / r)
        for i in range(0, len(idx), 2 ** 18)])
    oracle_start = time.perf_counter()
    m64 = st.oracle.oracle_margins(lyap, states.cpu().numpy(),
                                   tau=lyap.tau / r)
    oracle_s = time.perf_counter() - oracle_start
    gap = np.abs(ext64 - m64)
    share = gap / m_ext[idx]
    print("rigor on adaptive ({} states, refinement {}, count {}, kernel 3's "
          "float64 panel body): per-state extended margin {!r} to {!r} "
          "(median {!r}) derived in {!r} s, against the float32 derived "
          "{!r} and the measured {!r}; {} seeded refined sub-points, |float64 "
          "check - f64 oracle| up to {!r}, largest share of the margin {!r}, "
          "{} over it; f64 oracle {!r} s [{}]".format(
              grid.nindex, r, lyap.dynamics.count, float(m_ext.min()),
              float(m_ext.max()), float(np.median(m_ext)), derive_s,
              adaptive_derived.derived_max, adaptive_derived.measured,
              len(idx), float(gap.max()), float(share.max()),
              int((share > 1).sum()), oracle_s, card))
    if not (share <= 1.0).all():
        raise AssertionError("the float64 check departs from the f64 oracle "
                             "by more than the extended margin at {} refined "
                             "sub-points".format(int((share > 1).sum())))
    del states, ext64, m64, gap, share
    ext, hyb, ext_s, hyb_s = rigor_sweeps(lyap, "adaptive", card, None, r=r,
                                          reps=1)
    lyap.safe_set = ext["safe"]
    lyap._refinement = ext["refinement"]
    check_certify(lyap, adaptive.inst["initial"], 0.0, r,
                  "adaptive, extended margin")
    print("rigor on adaptive: safe fraction extended {!r} (c_max {!r}, max "
          "N(x) {}), hybrid equal, band fraction {!r}; extended {!r} s, "
          "hybrid {!r} s; float32 derived margin {!r} (c_max {!r}), the "
          "example's {!r} [{}]".format(
              float(ext["safe"].mean()), ext["c_max"],
              int(ext["refinement"].max()), hyb["band"], ext_s, hyb_s,
              adaptive_derived.fraction, adaptive_derived.c_max,
              float(base.safe_set.mean()), card))
    # Kernel 3's float64 launches by pass, as the float32 rows split them:
    # the refinement chunks' (the last one's sub-points timed) and the
    # coarse passes'.
    adaptive_view = float64_view(sweep, points)
    count = lyap.dynamics.count
    chunk_launches = sum(n for _, n in ext["chunks"])
    chunk_states = ext["chunks"][-1][0]
    chunk_points = sub_points(chunk_states, refinement_offsets(
        grid.unit_maxes, r, chunk_states)).double()
    print("rigor on adaptive, extended: kernel 3 launched {} times in float64"
          ", {} in {} refinement chunks (the last over {} states, {} "
          "sub-points) and {} in the coarse passes [{}]".format(
              ext["launches"]["gp_predict_stacked"], chunk_launches,
              len(ext["chunks"]), chunk_states.shape[0],
              chunk_points.shape[0],
              ext["launches"]["gp_predict_stacked"] - chunk_launches, card))
    if not ext["chunks"] or any(n < 1 for _, n in ext["chunks"]):
        raise AssertionError("every float64 refinement chunk must launch "
                             "kernel 3")
    with st.oracle._oracle_env(st.config.device):
        inputs, programs = stacked_inputs(adaptive_view, chunk_points)
        longdouble_check(card, "adaptive refinement chunk (kernel 3)",
                         inputs, count, programs=programs)
        del inputs
    paths.append(("gp_predict_stacked", "adaptive_extended_float64",
                  ext["launches"]["gp_predict_stacked"] - chunk_launches,
                  in_float64(lambda: panel_times(
                      card, "coarse pass, float64",
                      *stacked_inputs(adaptive_view), count))))
    paths.append(("gp_predict_stacked",
                  "adaptive_refinement_chunk_extended_float64",
                  chunk_launches,
                  in_float64(lambda: panel_times(
                      card, "refinement chunk, float64",
                      *stacked_inputs(adaptive_view, chunk_points), count))))
    del lyap

    one_d = {}
    for mode in (True, "hybrid"):
        dtypes = []
        reset_launches()
        with launch_dtypes(dtypes):
            run, seconds = synchronised_s(
                lambda: one_d_region_of_attraction_estimate.run(
                    full=True, extended=mode))
        launches = read_launches()["gp_predict_general"]
        f64 = sum(t == torch.float64 for t in dtypes)
        print("one_d_region_of_attraction_estimate --full --{}: history {}; "
              "c_max {!r}; extended margin {!r}; band fraction {!r}; kernel 2 "
              "{} launches ({} in float64); {!r} s [{}]".format(
                  "extended" if mode is True else "hybrid", " ".join(
                      "{:.3f}".format(f) for f in run.fractions),
                  run.lyap.c_max, run.lyap.certificate_margin,
                  run.lyap.last_band_fraction, launches, f64, seconds, card))
        if f64 < 1:
            raise AssertionError("the 1-D rigor run never launched kernel 2 "
                                 "in float64")
        one_d[mode] = (run, f64)
    # The float64 path's launches: the sweeps'; the loop's uncertainty
    # scans run kernel 2 in float32.
    run, launches = one_d[True]
    one_d_view = float64_view(run.lyap._get_extended_sweep(),
                              run.lyap._device_points())
    paths.append(("gp_predict_general", "one_d_roa_extended_float64",
                  launches, in_float64(lambda: program_times(
                      card, "general", one_d_view, "1-D ROA float64"))))
    lfl, seconds = synchronised_s(
        lambda: lyapunov_function_learning.run(
            full=True, seed=RIGOR_LEARNING_SEED, extended=True))
    print("lyapunov_function_learning --full --extended at seed {}: NN "
          "{:.1%} of the true ROA against LQR {:.1%}; fractions {}; c_max "
          "{}; the script {!r} s [{}]".format(
              RIGOR_LEARNING_SEED, lfl.nn_vs_roa, lfl.lqr_vs_roa, " ".join(
                  "{:.3f}".format(f) for f in lfl.frac_history),
              " ".join("{:.4g}".format(c) for c in lfl.c_history), seconds,
              card))
    print("rigor phase: {:.3f} s".format(time.perf_counter() - start))
    return paths


# ---------------------------------------------------------------------------
# The two drivers' rigor and fan-out paths
# ---------------------------------------------------------------------------
#: ``pendulum_rigor``'s depth: the example's ``--full`` widths, with its 5
#: outer iterations cut to 1 (2 rigor certifies, GP count up to 10; each
#: certify's checks take about 20 s of float64 host oracle over the
#: 3,003,501 states), its 3000 pretraining steps to 1000 and its 200
#: penalised steps a round to 100.
PENDULUM_RIGOR_OUTER, PENDULUM_RIGOR_PRETRAIN = 1, 1000
PENDULUM_RIGOR_STEPS = 100

#: ``adaptive_sequential``'s depth: the fewest of the example's 12 updates
#: of 15 measurements that take the GP past count 128 (1 + 9 * 15 = 136),
#: at its capacity 181.
ADAPTIVE_SEQUENTIAL_UPDATES = 9

#: The ``ExtendedSweep`` methods that check in float64 on the card.
RIGOR_CHECKS = ("negative_batch", "margins", "score_candidates",
                "refined_negative_batch")


@contextlib.contextmanager
def rigor_launches(log):
    """Every launch of kernels 1 to 3 in the block appended to ``log`` as
    ``(dtype, inside)``: ``inside`` whether one of the extended sweep's
    float64 checks (``RIGOR_CHECKS``) was running."""
    depth = [0]

    def inside(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            depth[0] += 1
            try:
                return fn(*args, **kwargs)
            finally:
                depth[0] -= 1
        return wrapped

    with contextlib.ExitStack() as stack:
        for name in RIGOR_CHECKS:
            stack.enter_context(patched(extended_verify.ExtendedSweep, name,
                                        inside))
        stack.enter_context(launch_dtypes(log, tag=lambda: depth[0] > 0))
        yield


def phase_pendulum_rigor(card, sweep_peak):
    """``examples/inverted_pendulum.py --full --hybrid`` on the card:
    ``inverted_pendulum.run(full=True, extended="hybrid")`` at the
    example's widths (2001x1501 safety grid, 55x55 policy grid, the
    ``[2, 32, 32, 1]`` network, the stacked GP at capacity 64), its depth
    cut (``PENDULUM_RIGOR_OUTER``, ``PENDULUM_RIGOR_PRETRAIN``,
    ``PENDULUM_RIGOR_STEPS``).

    After each certify (``SafeTraining.after_certify``; launches and time
    of the checks excluded): the extended sweep on the same state, whose
    set, ``c_max`` and refinement must equal the hybrid's bit for bit (the
    first one's peak device memory beside ``sweep_peak``, the float32
    sweep's of phase 8), and the set inside the float64 oracle's at every
    grid state (``oracle_gate``'s comparison, one-sided; ``c_max``, a
    float32 value, is printed beside the oracle's); each certify's margin
    and band tier printed.
    Over the run, kernel 3 is the only kernel launched, in float64 exactly
    inside the extended sweep's checks and in float32 everywhere else
    (``rigor_launches``), at least once in float64 a certify; no library
    is built. Returns the float64 path for ``kernel_rows``: ``(name,
    path, launches, time)``.
    """
    start = time.perf_counter()
    builds = dict(build_reports)
    log, checks = [], []
    in_checks = [0.0]

    def after_certify(trainer):
        lyap = trainer.lyap
        torch.cuda.synchronize()
        begin = time.perf_counter()
        n_log = len(log)
        hybrid = (np.array(lyap.safe_set), lyap.c_max,
                  np.array(lyap._refinement))
        band = lyap.last_band_fraction
        with uncounted():
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            _, ext_s = synchronised_s(
                lambda: lyap.update_safe_set(extended=True))
            peak = torch.cuda.max_memory_allocated() - base
            extended = (np.array(lyap.safe_set), lyap.c_max,
                        np.array(lyap._refinement))
            oracle_start = time.perf_counter()
            oracle_safe, c_ref = st.oracle.oracle_safe_set(lyap)
            oracle_s = time.perf_counter() - oracle_start
        del log[n_log:]
        label = "pendulum rigor certify {}".format(len(checks) + 1)
        outside = int((hybrid[0] & ~oracle_safe).sum())
        print("{}: tier {}; hybrid safe fraction {!r}, c_max {!r}, band "
              "fraction {!r}; the extended sweep on the same state {!r} s "
              "(peak {} bytes, {!r}x the float32 sweep's), equal: {}; "
              "f64 oracle ({} states, {!r} s) {} safe, c_max {!r}; {} "
              "certified states outside it; GP count {} [{}]".format(
                  label, trainer.tiers[-1], float(hybrid[0].mean()),
                  hybrid[1], band, ext_s, peak, peak / sweep_peak,
                  all(np.array_equal(a, b) for a, b in zip(hybrid,
                                                           extended)),
                  lyap.discretization.nindex, oracle_s,
                  int(oracle_safe.sum()), c_ref,
                  outside, lyap.dynamics.count, card))
        if not all(np.array_equal(a, b) for a, b in zip(hybrid, extended)):
            raise AssertionError("{}: the hybrid set differs from the "
                                 "extended one ({} states)".format(
                                     label, int((hybrid[0] != extended[0])
                                                .sum())))
        if outside:
            raise AssertionError("{}: {} certified states lie outside the "
                                 "f64 oracle's set".format(label, outside))
        checks.append(dict(tier=trainer.tiers[-1], band=band, peak=peak,
                           ext_s=ext_s, oracle_s=oracle_s))
        torch.cuda.synchronize()
        in_checks[0] += time.perf_counter() - begin

    def prepare(trainer):
        trainer.after_certify = after_certify

    reset_launches()
    with rigor_launches(log):
        run, seconds = synchronised_s(lambda: inverted_pendulum.run(
            full=True, extended="hybrid", outer_iters=PENDULUM_RIGOR_OUTER,
            pretrain_iters=PENDULUM_RIGOR_PRETRAIN,
            policy_iters=PENDULUM_RIGOR_STEPS, prepare=prepare))
    launches = read_launches()
    f64_in = sum(t == torch.float64 and inside for t, inside in log)
    f64_out = sum(t == torch.float64 and not inside for t, inside in log)
    f32_in = sum(t == torch.float32 and inside for t, inside in log)
    f32_out = sum(t == torch.float32 and not inside for t, inside in log)
    print("inverted_pendulum --full --hybrid ({} outer iterations of 5, {} "
          "pretraining steps of 3000, {} penalised steps a round of 200): "
          "safe fractions {}, c_max {}; tiers {}; rewards old {!r} new "
          "{!r}; final norm {!r}; stages {}; {!r} s, {!r} s of it in the "
          "checks; kernel launches {}: kernel 3 {} in float64 inside the "
          "extended checks, {} in float32 outside them ({} float64 outside, "
          "{} float32 inside) [{}]".format(
              PENDULUM_RIGOR_OUTER, PENDULUM_RIGOR_PRETRAIN,
              PENDULUM_RIGOR_STEPS, " ".join("{:.4f}".format(h)
                                             for h in run.history),
              " ".join("{:.4f}".format(c) for c in run.c_max), run.tiers,
              run.reward_old, run.reward_new, run.final_norm,
              {k: round(v, 3) for k, v in run.stage_s.items()}, seconds,
              in_checks[0], launches, f64_in, f32_out, f64_out, f32_in,
              card))
    if launches != dict({name: 0 for name in KERNELS},
                        gp_predict_stacked=f64_in + f32_out):
        raise AssertionError("the pendulum's rigor run launched {}, not "
                             "kernel 3 alone".format(launches))
    if f64_out or f32_in or f64_in < len(checks) or not f32_out:
        raise AssertionError("kernel 3 must launch in float64 inside the "
                             "extended checks only (at least once a "
                             "certify) and in float32 elsewhere")
    if len(checks) != 1 + PENDULUM_RIGOR_OUTER:
        raise AssertionError("{} certifies were checked".format(len(checks)))
    if dict(build_reports) != builds:
        raise AssertionError("the pendulum's rigor run built a library")
    print("pendulum rigor phase: {:.3f} s".format(
        time.perf_counter() - start))
    lyap = run.lyap
    view = float64_view(lyap._get_extended_sweep(), lyap._device_points())
    return ("gp_predict_stacked", "pendulum_rigor_float64", f64_in,
            in_float64(lambda: program_times(card, "stacked", view,
                                             "pendulum rigor float64")))


def phase_adaptive_sequential(card, stacked_first):
    """``examples/adaptive_safety_verification.py --full --sequential`` on
    the card: ``adaptive_safety_verification.run(full=True,
    sequential=True)``, the ``FunctionStack`` of two GPs (kernel 2, twice
    a predict) and one ``get_safe_sample`` a measurement, at capacity 181,
    its updates cut to ``ADAPTIVE_SEQUENTIAL_UPDATES``.

    Checks, each raising, after each certify (launches of the checks
    excluded): the first certify's safe set, ``c_max`` and
    ``_refinement`` equal ``stacked_first``, the stacked route's (phase
    10); every certify above count 128 against the float64 oracle outside
    the band of ``calibrate_certificate_margin(refinement=16)``
    (``check_certify``). Over the run: kernel 2 is the only kernel
    launched, some of its launches above count 128 on the panel body; the
    example's assertion; no library built. Returns kernel 2's path for
    ``kernel_rows``: ``(name, path, launches, time)``, timed on the
    coarse pass's inputs at the final GP.
    """
    r = ADAPTIVE_REFINEMENT
    start = time.perf_counter()
    builds = dict(build_reports)
    calls, held = [], []
    previous = {}

    def after_certify(lyap, update):
        n_calls = len(calls)
        count = lyap.dynamics.functions[0].count
        if update == 0:
            previous["safe"] = np.array(lyap.initial_safe_set)
            for name, a, b in zip(("safe_set", "c_max", "_refinement"),
                                  (np.array(lyap.safe_set), lyap.c_max,
                                   lyap._refinement), stacked_first):
                if not np.array_equal(a, b):
                    raise AssertionError("the sequential route's first "
                                         "certify gives another {}".format(
                                             name))
            print("adaptive sequential: the first certify equals the "
                  "stacked route's (safe set, c_max {!r}, _refinement)"
                  .format(lyap.c_max))
        if count > 128:
            exempt = np.array(lyap.initial_safe_set) | previous["safe"]
            with uncounted():
                band = st.oracle.calibrate_certificate_margin(
                    lyap, refinement=r, set_margin=False)
                check_certify(lyap, exempt, band, r,
                              "adaptive sequential certify {} (count {})"
                              .format(update, count))
            held.append(update)
        previous["safe"] = np.array(lyap.safe_set)
        del calls[n_calls:]

    reset_launches()
    with kernel3_calls(calls):
        run, seconds = synchronised_s(
            lambda: adaptive_safety_verification.run(
                full=True, sequential=True,
                updates=ADAPTIVE_SEQUENTIAL_UPDATES,
                capacity=ADAPTIVE_CAPACITY, after_certify=after_certify))
    launches = read_launches()
    if not calls:
        raise AssertionError("the sequential route launched no kernel")
    counts = [a[8] for a in calls]
    above = [c for c in counts if c > 128]
    gp = run.lyap.dynamics.functions[0]
    body = gp_kernel.program_body(calls[-1][0], gp.count,
                                  calls[-1][1].dtype)
    print("adaptive_safety_verification --full --sequential ({} of 12 "
          "updates): safe fractions {}, c_max {}, max N(x) {}; updates {} "
          "s; {!r} s; kernel launches {}, kernel 2 {} above count 128 (the "
          "{} body at count {}); certifies {} held to the f64 oracle "
          "[{}]".format(
              ADAPTIVE_SEQUENTIAL_UPDATES, " ".join(
                  "{:.4f}".format(h) for h in run.history),
              " ".join("{:.4f}".format(c) for c in run.c_max),
              run.max_refinement, [round(t, 3) for t in run.update_s],
              seconds, launches, len(above), body, gp.count, held, card))
    if launches != dict({name: 0 for name in KERNELS},
                        gp_predict_general=len(counts)):
        raise AssertionError("the sequential route launched {}, not kernel "
                             "2 alone".format(launches))
    if not above or body != "panel" or not held:
        raise AssertionError("kernel 2's panel body did not run above count "
                             "128, or no certify above it was held")
    if dict(build_reports) != builds:
        raise AssertionError("the sequential route built a library")
    print("adaptive sequential phase: {:.3f} s".format(
        time.perf_counter() - start))

    def timed():
        numbers = program_times(card, "general", run.lyap,
                                "adaptive sequential coarse pass")
        entry = dict(zip(("max_abs_err", "ms", "plain_ms", "eager_ms",
                          "bound_ms", "bound_by", "bound_kind",
                          "library_ms"), numbers))
        entry.update(body=body, count=gp.count,
                     launches_above_128=len(above))
        return entry
    return ("gp_predict_general", "adaptive_sequential", len(counts), timed)


@contextlib.contextmanager
def phase_clock(seconds, name):
    """Record the wall seconds of the block under ``name`` and print
    them."""
    start = time.perf_counter()
    yield
    seconds[name] = time.perf_counter() - start
    print("phase {}: {!r} s".format(name, seconds[name]), flush=True)


def main():
    seconds = {}

    def clocked(name, fn, *args):
        with phase_clock(seconds, name):
            return fn(*args)

    card = phase_device()
    clocked("build", phase_build)
    clocked("kernel cases", phase_kernel_cases)
    clocked("program cases", phase_program_cases)
    bench_lyap, bench_launches = clocked("bench", phase_bench_path)
    stacked_lyap, stacked_launches, flagship_margins = clocked(
        "flagship stacked", phase_flagship_path, "stacked")
    fan_lyap, fan_launches, _ = clocked("flagship fan_out",
                                        phase_flagship_path, "fan_out",
                                        flagship_margins)
    del flagship_margins
    # The host-bound end-to-end times come first: the sweeps and the
    # loop's steps, before the count cases and before any CUDA graph is
    # captured for the kernel timings.
    with phase_clock(seconds, "sweep times"):
        time_sweep("bench", bench_lyap, card)
        time_sweep("flagship stacked", stacked_lyap, card)
        time_sweep("flagship fan_out", fan_lyap, card)
    safe_lyap, safe_inst, safe_launches, safe_err, safe_peak = clocked(
        "safe learning", phase_safe_learning, card)
    trainer, train_launches, minibatch = clocked(
        "training", phase_training, card, safe_peak)
    adaptive = clocked("adaptive", phase_adaptive, card)
    cart_lyap, cart_launches = clocked(
        "cart-pole verification", phase_cartpole_verification, card)
    clocked("cart-pole RL", phase_cartpole_rl, card)
    one_d_lyap, one_d_launches = clocked("1-D ROA", phase_one_d_roa, card)
    clocked("streamed exactness", phase_streamed_exactness, card)
    giant_lyap, giant_launches, _ = clocked("10^8 sweep", phase_giant_sweep,
                                            card)
    sharded = clocked("sharded", phase_sharded, card, bench_lyap,
                      giant_lyap, adaptive)
    clocked("region tools", phase_region_tools, card, bench_lyap)
    one_d_ex_lyap, one_d_ex_launches = clocked(
        "1-D example", phase_one_d_example, card)
    clocked("examples", phase_examples, card)
    bench_oracle, adaptive_derived = clocked(
        "derived margins", phase_derived_margins, card, adaptive)
    rigor_paths = clocked("rigor", phase_rigor, card, bench_oracle,
                          adaptive, adaptive_derived)
    del bench_oracle
    rigor_paths.append(clocked("pendulum rigor", phase_pendulum_rigor, card,
                               safe_peak))
    sequential = clocked("adaptive sequential", phase_adaptive_sequential,
                         card, adaptive.first)
    bench_grown = clocked("bench grown", phase_bench_grown, card)
    grown_rigor_paths, grown = clocked("adaptive grown",
                                       phase_adaptive_grown, card)
    rigor_paths += grown_rigor_paths
    with phase_clock(seconds, "count cases"):
        phase_kernel_count_cases()
        phase_program_count_cases()
        phase_dmma_cases()
    kernel_start = time.perf_counter()
    # Per kernel and path: (launches, max_abs_err, ms, plain_ms, eager_ms,
    # bound_ms, bound_by, bound_kind). A kernel's headline numbers are its
    # last path's: the cart-pole and 1-D rows ride along under "paths".
    paths = [
        ("gp_predict", "cartpole_51x4", (cart_launches,)
         + phase_times(card, cart_lyap, "cart-pole 51^4")),
        ("gp_predict", "streamed_sweep_1e8", (giant_launches,)
         + stationary_times(card, *giant_batch_inputs(
             giant_lyap, giant_sweep_1e8.BATCH),
             "10^8 streamed sweep batch")),
    ]
    # The sharded paths ride under "paths" before each kernel's headline
    # path (the bench's, the adaptive coarse pass's).
    sharded_rows = sharded_paths(card, bench_lyap, giant_lyap, sharded)
    paths += [row for row in sharded_rows if row[0] == "gp_predict"]
    for lyap, launches in bench_grown:
        paths += grown_bench_times(card, lyap, launches)
    del bench_grown
    paths += [
        ("gp_predict", "bench", (bench_launches["gp_predict"],)
         + phase_times(card, bench_lyap)),
        ("gp_predict_stacked", "flagship_stacked",
         (stacked_launches["gp_predict_stacked"],)
         + program_times(card, "stacked", stacked_lyap,
                         "flagship stacked")),
        ("gp_predict_general", "one_d_roa", (one_d_launches,)
         + program_times(card, "general", one_d_lyap, "1-D ROA")),
        ("gp_predict_general", "one_d_example", (one_d_ex_launches,)
         + program_times(card, "general", one_d_ex_lyap, "1-D example")),
        timed_path(*sequential),
    ]
    grown_paths = grown_times(card, grown)
    paths += [p for p in grown_paths if p[0] == "gp_predict_general"]
    paths += [
        ("gp_predict_general", "flagship_fan_out",
         (fan_launches["gp_predict_general"],)
         + program_times(card, "general", fan_lyap, "flagship fan_out")),
    ]
    paths += phase_kernel_variants(card, bench_lyap, cart_lyap)
    del cart_lyap, giant_lyap
    del stacked_lyap, fan_lyap
    train = (train_launches,) + training_times(card, trainer, minibatch)
    print("kernel 3 on the training path: {} launches, max abs err {!r}, "
          "{!r} ms against plain {!r} ms (eager {!r} ms), bound {!r} ms "
          "({}, {})".format(*train))
    paths.append(("gp_predict_stacked", "training", train))
    safe = (safe_launches, safe_err) + safe_learning_times(card, safe_lyap)
    print("kernel 3 on the safe-learning path: {} launches, max abs err "
          "{!r}, {!r} ms against plain {!r} ms (eager {!r} ms), bound {!r} "
          "ms ({}, {})".format(*safe))
    paths.append(("gp_predict_stacked", "safe_learning", safe))
    paths += [row for row in sharded_rows if row[0] != "gp_predict"]
    # The grown loop's kernel-3 paths (count 1,021) ride under "paths";
    # kernel 3's headline numbers are the adaptive coarse pass's (listed
    # last); the sampler step's and the chunk's ride along.
    for name, path, entry in grown_paths:
        if name != "gp_predict_stacked":
            continue
        print("kernel 3 on the grown adaptive path ({}): {} launches, max "
              "abs err {!r}, {} body {!r} ms against the streamed body {!r} "
              "ms and plain {!r} ms (eager {!r} ms), the product alone {!r} "
              "ms, bound {!r} ms ({}, {})".format(
                  path, entry["launches"], entry["max_abs_err"],
                  entry["body"], entry["ms"], entry["streamed_ms"],
                  entry["plain_ms"], entry["eager_ms"], entry["library_ms"],
                  entry["bound_ms"], entry["bound_by"],
                  entry["bound_kind"]))
        paths.append((name, path, entry))
    del grown, grown_paths
    for path, entry in adaptive_times(card, adaptive):
        print("kernel 3 on the adaptive path ({}): {} launches ({} above "
              "count 128), max abs err {!r}, {} body {!r} ms against the "
              "streamed body {!r} ms and plain {!r} ms (eager {!r} ms), the "
              "product alone {!r} ms, bound {!r} ms ({}, {})".format(
                  path, entry["launches"], entry["launches_above_128"],
                  entry["max_abs_err"], entry["body"], entry["ms"],
                  entry["streamed_ms"], entry["plain_ms"], entry["eager_ms"],
                  entry["library_ms"], entry["bound_ms"], entry["bound_by"],
                  entry["bound_kind"]))
        paths.append(("gp_predict_stacked", path, entry))
    # Kernels 1 to 3 in float64 on the rigor paths: under "paths" only, the
    # rows' headline numbers stay their float32 paths'.
    for name, path, entry in (timed_path(*p) for p in rigor_paths):
        print("{} on the {} path: {} launches, max abs err {!r}, {!r} ms "
              "against plain {!r} ms (eager {!r} ms), the product alone {!r} "
              "ms, bound {!r} ms ({}, {})".format(
                  name, path, entry["launches"], entry["max_abs_err"],
                  entry["ms"],
                  entry["plain_ms"], entry["eager_ms"], entry["library_ms"],
                  entry["bound_ms"], entry["bound_by"], entry["bound_kind"]))
        paths.append((name, path, entry))
    loop_step_times(card, safe_lyap, safe_inst, "after the count cases and "
                    "the CUDA graphs")
    plain_method_check(card, bench_lyap)
    seconds["kernel times"] = time.perf_counter() - kernel_start
    print("phase kernel times: {!r} s".format(seconds["kernel times"]))
    # Profiles come after every time: the profiler's tracing may slow the
    # host's dispatch of what runs after it.
    with phase_clock(seconds, "profiles"):
        profile_sweep("safe-learning", safe_lyap, card)
        profile_sweep("bench", bench_lyap, card)
        profile_training(card, trainer, penalised=False)
        profile_training(card, trainer, penalised=True)
        profile_adaptive(card, adaptive)
    print(json.dumps({"phase_seconds": seconds}))
    print(card)
    print(json.dumps({"kernels": kernel_rows(paths)}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def timed_path(name, path, launches, timed):
    """A path of ``kernel_rows`` from a phase's ``(name, path, launches,
    time)``: ``time()``'s numbers (a dict) with the launches."""
    entry = timed()
    entry["launches"] = launches
    return name, path, entry


def kernel_rows(paths):
    """The ``kernels`` JSON rows: one per kernel, its numbers from the
    last float32 path listed for it (kernel 3: the adaptive path's coarse
    pass; a path tagged ``"dtype": "float64"``, the rigor paths, only under
    ``paths``),
    and every path's numbers under ``paths`` (a path's numbers are a
    tuple in ``keys``' order, or a dict that holds them and more: kernel
    3's paths above count 128 add the body, the streamed body's times and
    the product alone). No single PyTorch call computes a GP posterior
    numerator, so the row's ``library_ms`` is null; every path's
    ``library_ms`` is the product alone, as its ``library_call`` says
    (kernels 4 to 7 compute kernel 1's function at kernel 1's inputs)."""
    keys = ("launches", "max_abs_err", "ms", "plain_ms", "eager_ms",
            "bound_ms", "bound_by", "bound_kind")
    rows = {}
    for name, path, numbers in paths:
        entry = (dict(numbers) if isinstance(numbers, dict)
                 else dict(zip(keys + ("library_ms",), numbers)))
        entry["path"] = path
        entry["share_of_bound"] = entry["bound_ms"] / entry["ms"]
        entry.setdefault("library_ms", None)
        if entry["library_ms"] is not None:
            entry.setdefault("library_call", PRODUCT_CALL)
        row = rows.setdefault(name, {
            "name": name, "route": "cuda", "source": KERNELS[name][1],
            "replaces": KERNELS[name][2], "library_ms": None, "paths": []})
        if entry.get("dtype") != "float64":
            row.update({k: entry[k] for k in keys + ("path", "body",
                                                      "streamed_ms",
                                                      "streamed_eager_ms")
                        if k in entry})
        row["paths"].append(entry)
    return list(rows.values())


if __name__ == "__main__":
    if sys.argv[1:2] == ["--sharded-worker"]:
        sharded_worker(sys.argv[2:])
    elif sys.argv[1:2] == ["--rigor-certify"]:
        rigor_certify_times()
    else:
        sys.exit(main())
