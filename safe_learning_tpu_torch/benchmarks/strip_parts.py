"""The parts and the alternatives of the strip body of kernels 1-3, timed.

The strip body (``csrc/gp_predict_common.cuh``: ``Strip``,
``solve_strips``) serves kernels 1-3 above the panel body's largest
count (512 rows in float32, 256 in float64) up to the 2,048 rows the GPs
route to a kernel: a thread-block cluster of ``strip_cluster(n)`` = 2
blocks an item, each chunk's K evaluated once a 512-row round across the
cluster's blocks and exchanged through distributed shared memory. The
source keeps one design. This module builds copies of ``csrc/`` with one
change each (``ALTERNATIVES``): a part of the body switched off, so that
the other parts' time shows alone (the fill, the solve, the cluster
exchange), clusters of another size (1, 4 or 8 blocks at every count; 1
is the one-block design's redundancy, K evaluated again every 256-row
round; 4 and 8 evaluate it once an item up to 1,024 and 2,048 rows), the
fill after the solve, one block an SM, or the strip body in place of the
panel body (the panel body's largest count lowered to 128). With
``--earlier NAME=DIR`` (repeatable) it also builds the ``csrc/``
directory ``DIR`` of another commit (for example one unpacked with ``git
archive``) as the alternative ``NAME``. It times each copy's kernel in
turns with the source's, on the card, as the device time of one call in
a CUDA graph, at the port's shapes, float32 and float64:

- kernel 3 at the adaptive example's refinement chunk (``chunk``: the
  flagship's two programs, S = 2, Q = 2^20 queries) at counts 181, 256
  and 512 (the panel body's range) and 1,021 (the adaptive loop grown to
  1,024 points), and at its sampler step (``sampler``: Q = 2,000) at
  1,021;
- kernel 1 at ``bench.py``'s shape (``bench``: Q = 10^6, d = 3, p = 2,
  RBF) at 2,048 rows.

A copy whose part is switched off computes a wrong answer: only its time
means anything. On a machine with the card::

    python -m safe_learning_tpu_torch.benchmarks.strip_parts [NAME ...]
    python -m safe_learning_tpu_torch.benchmarks.strip_parts [NAME ...] \\
        --earlier NAME=DIR [--earlier NAME=DIR ...]

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
_CLUSTER = "  return n > 0 ? 2 : 1;"
_SOLVE = "      if (t * S::JC < wend) {"
_SOLVE_END = ("          strip_chunk_dmma(acc, slot + lrow, kb + kq);\n"
              "        }\n      }\n")
_FILL = ("      if (t + 1 < nch) fill(kbuf + (t + 1) % S::NKB * KB, jn);\n"
         "      cluster_arrive();\n")
_CONSTANT_K = ("    const T v = j < n ? kfn(j) : T(0);",
               "    const T v = j < n ? T(0.5) : T(0);")
_FETCHES = (("    if (wend > 0) strip_fetch(", "    if (false) strip_fetch("),
            ("      if (jn < wend) {\n        strip_fetch(",
             "      if (false) {\n        strip_fetch("))
ALTERNATIVES = {
    "strip_everywhere": (
        (3,), "panel", "the strip body in place of the panel body (the "
        "panel body's largest count lowered to 128 in both dtypes)",
        [("  static constexpr int N_MAX = 512;",
          "  static constexpr int N_MAX = 128;"),
         ("  static constexpr int N_MAX = 256;",
          "  static constexpr int N_MAX = 128;")]),
    "fill_only": (
        (1, 3), "strip", "the strip body without its product (the K fill "
        "and exchange, the copies and the epilogue)",
        [(_SOLVE, "      if (false) {")]),
    "solve_only": (
        (1, 3), "strip", "the strip body without its covariances (K set to "
        "a constant, still exchanged)",
        [_CONSTANT_K]),
    "exchange_only": (
        (1, 3), "strip", "the cluster exchange alone: a constant K stored "
        "into every block, the cluster barriers and the epilogue, no "
        "covariances, no chol_inv copies, no product",
        [_CONSTANT_K, (_SOLVE, "      if (false) {")] + list(_FETCHES)),
    "one_block": (
        (1, 3), "strip", "float32 at one block an SM (255 registers a "
        "thread; two in the source, 128)",
        [("  static constexpr int BLOCKS = F32 ? 2 : 1;  // blocks an SM",
          "  static constexpr int BLOCKS = 1;  // blocks an SM")]),
    "fill_after": (
        (1, 3), "strip", "the next chunk's K fill and the cluster "
        "barrier's arrival after this chunk's solve (in the source, before "
        "it: a block waits for the others' fills, not their solves)",
        [(_FILL, ""), (_SOLVE_END, _SOLVE_END + _FILL)]),
}
for _c in (1, 4, 8):
    ALTERNATIVES["cluster_{}".format(_c)] = (
        (1, 3), "strip", "clusters of {} block{} at every count{}".format(
            _c, "s" if _c > 1 else "", " (the one-block design: K "
            "evaluated again for every 256-row round)"
            if _c == 1 else " (rounds of {} rows where n is larger)".format(
                256 * _c)),
        [(_CLUSTER, "  return n > 0 ? {} : 1;".format(_c))])

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


def build(names, earlier=()):
    """Build the source's libraries, the alternatives ``names`` and the
    ``earlier`` ``(name, csrc directory)`` of other commits (one ``nvcc``
    each, all at once). Returns ``{(name, kernel): library}``, ``name``
    ``"source"`` for the source's."""
    programs, _ = _programs()
    stationary = gp_kernel._STATIONARY_JOB
    program_job = gp_kernel._program_job(programs)
    jobs, keys = [stationary, program_job], [("source", 1), ("source", 3)]
    dirs = [(name, alternative_dir(name)) for name in names]
    dirs += [(name, os.path.abspath(path)) for name, path in earlier]
    for name, path in dirs:
        for kernel in _kernels(name):
            job = stationary if kernel == 1 else program_job
            jobs.append(("strip_{}_{}".format(name, job[0]),) + job[1:3]
                        + (path,))
            keys.append((name, kernel))
    libs = build_mod.load_libraries(jobs)
    bound = {}
    for key, lib in zip(keys, libs):
        bind = (gp_kernel.bind_kernel1 if key[1] == 1
                else gp_kernel.bind_program)
        bound[key] = bind(lib, launch_only=key[0] not in ALTERNATIVES
                          and key[0] != "source")
    return bound


def _kernels(name):
    return ALTERNATIVES[name][0] if name in ALTERNATIVES else (1, 3)


def _where(name):
    return ALTERNATIVES[name][1] if name in ALTERNATIVES else "strip"


def _what(name):
    if name == "source":
        return "the source's body"
    if name not in ALTERNATIVES:
        return "the csrc/ of another commit (--earlier)"
    return ALTERNATIVES[name][2]


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
        shapes = [("chunk", 3, count, cap, 2 ** 20)
                  for count, cap in CHUNK_COUNTS]
        shapes.append(("sampler", 3, 1021, 1024, 2000))
        shapes.append(("bench", 1, 2048, 2048, 10 ** 6))
        for label, kernel, count, cap, n_q in shapes:
            where = "panel" if count <= panel_max else "strip"
            if kernel == 3:
                programs, inputs, count = chunk_inputs(count, cap, dtype,
                                                       n_q=n_q)
            else:
                programs = None
                inputs, count = bench_inputs(dtype, count, n_q=n_q)
            calls = [(name, fn) for name, fn in
                     _calls(libs, kernel, inputs, count, programs)
                     if name == "source" or _where(name) == where]
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
                       "queries": n_q, "dtype": str(dtype).split(".")[-1],
                       "body": "panel" if where == "panel" and name ==
                       "source" else "strip",
                       "alternative": name, "ms": ms, "runs": times,
                       "of_source": ms / base, "card": card,
                       "what": _what(name)}
            del inputs


def main(argv=None):
    """Build the alternatives named (all by default) and time them."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("names", nargs="*", metavar="NAME",
                    help="of ALTERNATIVES (default: all)")
    ap.add_argument("--earlier", metavar="NAME=DIR", action="append",
                    default=[], help="a csrc/ directory of another commit, "
                    "timed as the alternative NAME")
    args = ap.parse_args(argv)
    unknown = sorted(set(args.names) - set(ALTERNATIVES))
    if unknown:
        ap.error("unknown alternatives {}; choose from {}".format(
            unknown, sorted(ALTERNATIVES)))
    earlier = []
    for spec in args.earlier:
        name, _, path = spec.partition("=")
        if (not name or name in ALTERNATIVES or name == "source"
                or not os.path.isfile(os.path.join(path, _COMMON))):
            ap.error("--earlier {}: a new name and a directory holding {}"
                     .format(spec, _COMMON))
        earlier.append((name, path))
    if not torch.cuda.is_available():
        raise SystemExit("strip_parts: needs an NVIDIA GPU")
    from ..config import config

    config.device = "cuda:0"
    print(card_line(), flush=True)
    names = args.names or ([] if earlier else sorted(ALTERNATIVES))
    libs = build(names, earlier)
    results = []
    for entry in run(libs):
        print(json.dumps(entry), flush=True)
        results.append(entry)
    return results


if __name__ == "__main__":
    main()
