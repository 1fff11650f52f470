"""The parts and the alternatives of the strip body of kernels 1-3, timed.

The strip body (``csrc/gp_predict_common.cuh``: ``Strip``,
``solve_strips``) serves kernels 1-3 above the panel body's largest count
(512 rows in float32, 256 in float64) up to the 2,048 rows the GPs route
to a kernel; the source keeps one design. This module builds copies of
``csrc/`` with one change each (``ALTERNATIVES``): a part of the body
switched off, so that the other part's time shows alone, another choice
the design could have made, or the strip body in place of the panel body
(the panel body's largest count lowered to 128). It times each copy's
kernel in turns with the source's, on the card, as the device time of
one call in a CUDA graph, at two shapes of the port's paths, float32 and
float64:

- kernel 3 at the adaptive example's refinement chunk (``chunk``: the
  flagship's two programs, S = 2, Q = 2^20 queries) at counts 181, 256
  and 512 (the panel body's range) and 1,021 (the adaptive loop grown to
  1,024 points);
- kernel 1 at ``bench.py``'s shape (``bench``: Q = 10^6, d = 3, p = 2,
  RBF) at 2,048 rows.

A copy whose part is switched off computes a wrong answer: only its time
means anything. On a machine with the card::

    python -m safe_learning_tpu_torch.benchmarks.strip_parts [NAME ...]

prints the card's name and power limit, then one JSON line a kernel,
shape, count and dtype. Each copy is one or two more ``nvcc`` builds
(kernel 1's library, a program library; about a minute, all at once).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics

import numpy as np
import torch

from ..ops import build as build_mod
from ..ops import gp_kernel
from .pipelined_predict import card_line
from .variant_parts import graph_ms, patch_text

__all__ = ["ALTERNATIVES", "CHUNK_COUNTS", "alternative_header",
           "alternative_dir", "build", "chunk_inputs", "bench_inputs", "run",
           "main"]

_COMMON = "gp_predict_common.cuh"

#: Per name: the kernels it changes (1: kernel 1's library, 3: the
#: program library), the counts it is timed at ("panel": the panel body's
#: range in the source, "strip": above it), what it measures, and the
#: changes to ``gp_predict_common.cuh`` ``(text, replacement)``, each text
#: found exactly once.
ALTERNATIVES = {
    "strip_everywhere": (
        (3,), "panel", "the strip body in place of the panel body (the "
        "panel body's largest count lowered to 128 in both dtypes)",
        [("  static constexpr int N_MAX = 512;",
          "  static constexpr int N_MAX = 128;"),
         ("  static constexpr int N_MAX = 256;",
          "  static constexpr int N_MAX = 128;")]),
    "fill_only": (
        (1, 3), "strip", "the strip body without its product (the K fill, "
        "the copies and the epilogue)",
        [("      if (jn > 0) {\n        strip_chunk(",
          "      if (false) {\n        strip_chunk("),
         ("      if (wr0 < n && cur.jc0() < wr0 + S::WROWS) {",
          "      if (false) {")]),
    "solve_only": (
        (1, 3), "strip", "the strip body without its covariances (K set to "
        "a constant)",
        [("    kb[jj * S::TQP + ql] = j < n ? kfn(j) : T(0);",
          "    kb[jj * S::TQP + ql] = j < n ? T(0.5) : T(0);")]),
    "one_block": (
        (1, 3), "strip", "float32 at one block an SM (255 registers a "
        "thread; two in the source, 128)",
        [("  static constexpr int BLOCKS = F32 ? 2 : 1;  // blocks an SM",
          "  static constexpr int BLOCKS = 1;  // blocks an SM")]),
}

#: Kernel 3's counts at the chunk shape and the capacity of each.
CHUNK_COUNTS = ((181, 181), (256, 256), (512, 512), (1021, 1024))


def alternative_header(name):
    """``gp_predict_common.cuh`` with alternative ``name``'s changes."""
    return patch_text(os.path.join(build_mod.CSRC_DIR, _COMMON),
                      ALTERNATIVES[name][3], name)


def alternative_dir(name):
    """A copy of ``csrc/`` with alternative ``name``'s changes, under the
    build directory."""
    text = alternative_header(name)
    dst = os.path.join(build_mod.BUILD_DIR, "strip_parts", name)
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(build_mod.CSRC_DIR, dst)
    with open(os.path.join(dst, _COMMON), "w") as f:
        f.write(text)
    return dst


def _programs():
    """The flagship's two programs (the adaptive example's stacked GP)."""
    from ..examples.inverted_pendulum import pendulum_kernel

    params, programs = [], []
    for ls in ([0.3, 0.1, 0.5],) * 2:
        program, params = gp_kernel.compile_kernel_program(
            pendulum_kernel(np.array(ls)), input_dim=3, params=params)
        programs.append(program)
    return tuple(programs), params


def build(names):
    """Build the source's libraries and the alternatives ``names`` (one
    ``nvcc`` each, all at once). Returns ``{(name, kernel): library}``,
    ``name`` ``"source"`` for the source's."""
    programs, _ = _programs()
    stationary = gp_kernel._STATIONARY_JOB
    program_job = gp_kernel._program_job(programs)
    jobs, keys = [stationary, program_job], [("source", 1), ("source", 3)]
    for name in names:
        path = alternative_dir(name)
        for kernel in ALTERNATIVES[name][0]:
            job = stationary if kernel == 1 else program_job
            jobs.append(("strip_{}_{}".format(name, job[0]),) + job[1:3]
                        + (path,))
            keys.append((name, kernel))
    libs = build_mod.load_libraries(jobs)
    return {key: (gp_kernel.bind_kernel1(lib) if key[1] == 1
                  else gp_kernel.bind_program(lib))
            for key, lib in zip(keys, libs)}


def chunk_inputs(count, cap, dtype, n_q=2 ** 20, seed=0):
    """Kernel 3's inputs at the chunk shape: the flagship's two programs
    on ``count`` points uniform in ``[-1, 1]^3`` at capacity ``cap``, and
    ``n_q`` queries in the same box, on the card."""
    from .. import StackedGaussianProcess
    from ..config import config
    from ..examples.inverted_pendulum import pendulum_kernel

    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (count, 3))
    y = 0.1 * np.column_stack([np.sin(x.sum(1)), np.cos(x[:, 0])])
    old = config.dtype
    config.dtype = dtype
    try:
        gp = StackedGaussianProcess(
            [pendulum_kernel(np.array([0.3, 0.1, 0.5]))] * 2, x, y, 1e-4,
            capacity=cap)
    finally:
        config.dtype = old
    programs, params = gp._programs()
    q = torch.as_tensor(rng.uniform(-1, 1, (n_q, 3)), dtype=dtype,
                        device=gp.X_buf.device)
    return programs, (q, gp.X_buf, gp_kernel.program_params(params, q),
                      gp.chol_inv, gp.alpha[:, :, 0].contiguous(),
                      gp._mask(), gp.scale ** 2), gp.count


def bench_inputs(dtype, count=2048, n_q=10 ** 6, seed=0):
    """Kernel 1's inputs at ``bench.py``'s shape at ``count`` rows: an RBF
    GP (variance 1, lengthscales 0.4) with two outputs, on the card."""
    from .. import GaussianProcess, RBF
    from ..config import config
    from .pipelined_predict import kernel_inputs

    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (count, 3))
    y = np.column_stack([np.sin((o + 1) * x.sum(axis=1)) for o in range(2)])
    old = config.dtype
    config.dtype = dtype
    try:
        gp = GaussianProcess(RBF(1.0, [0.4] * 3, input_dim=3), x, y,
                             noise_variance=1e-4)
    finally:
        config.dtype = old
    return kernel_inputs(gp, rng.uniform(-1, 1, (n_q, 3))), gp.count


def _calls(libs, kernel, inputs, count, programs=None):
    """``[(name, call)]`` of every library of ``kernel`` on ``inputs``."""
    out = []
    for (name, k), lib in libs.items():
        if k != kernel:
            continue
        if kernel == 1:
            def call(lib=lib):
                return gp_kernel.launch_stationary(
                    gp_kernel._kernel1_entry, lambda: lib, "gp_predict",
                    *inputs, "rbf", count)
        else:
            n_q, n_out = inputs[0].shape[0], len(programs)
            mean = torch.empty((n_q, n_out), dtype=inputs[0].dtype,
                               device=inputs[0].device)
            var = torch.empty_like(mean)
            alpha = inputs[4].reshape(n_out, -1, 1)

            def call(lib=lib, mean=mean, var=var, alpha=alpha):
                return gp_kernel._launch_entry(
                    "gp_program", programs, *inputs[:4], alpha, *inputs[5:],
                    count, mean, var, lib=lib)
        out.append((name, call))
    return out


def run(libs, rounds=2):
    """Every library's kernel at every shape it is timed at, in turns,
    ``rounds`` rounds; yields one dict a kernel, shape, count and dtype."""
    card = card_line()
    for dtype in (torch.float32, torch.float64):
        panel_max = gp_kernel.program_panel_max(_programs()[0], dtype)
        shapes = [("chunk", 3, count, cap) for count, cap in CHUNK_COUNTS]
        shapes.append(("bench", 1, 2048, 2048))
        for label, kernel, count, cap in shapes:
            where = "panel" if count <= panel_max else "strip"
            if kernel == 3:
                programs, inputs, count = chunk_inputs(count, cap, dtype)
            else:
                programs = None
                inputs, count = bench_inputs(dtype, count)
            calls = [(name, fn) for name, fn in
                     _calls(libs, kernel, inputs, count, programs)
                     if name == "source" or ALTERNATIVES[name][1] == where]
            if len(calls) == 1:
                continue
            runs = {name: [] for name, _ in calls}
            with torch.no_grad():
                for _ in range(rounds):
                    for name, fn in calls:
                        runs[name].append(graph_ms(fn))
            base = statistics.mean(runs["source"])
            for name, times in runs.items():
                ms = statistics.mean(times)
                yield {"shape": label, "kernel": kernel, "count": count,
                       "dtype": str(dtype).split(".")[-1],
                       "body": "panel" if where == "panel" and name ==
                       "source" else "strip",
                       "alternative": name, "ms": ms, "runs": times,
                       "of_source": ms / base, "card": card,
                       "what": ALTERNATIVES[name][2] if name != "source"
                       else "the source's body"}
            del inputs


def main(argv=None):
    """Build the alternatives named (all by default) and time them."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("names", nargs="*", metavar="NAME",
                    help="of ALTERNATIVES (default: all)")
    args = ap.parse_args(argv)
    unknown = sorted(set(args.names) - set(ALTERNATIVES))
    if unknown:
        ap.error("unknown alternatives {}; choose from {}".format(
            unknown, sorted(ALTERNATIVES)))
    if not torch.cuda.is_available():
        raise SystemExit("strip_parts: needs an NVIDIA GPU")
    from ..config import config

    config.device = "cuda:0"
    print(card_line(), flush=True)
    libs = build(args.names or sorted(ALTERNATIVES))
    results = []
    for entry in run(libs):
        print(json.dumps(entry), flush=True)
        results.append(entry)
    return results


if __name__ == "__main__":
    main()
