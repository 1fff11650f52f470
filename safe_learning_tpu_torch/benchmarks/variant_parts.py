"""The parts and the alternatives of kernels 4 and 7's float32 bodies, timed.

Kernel 4's float32 tiled body (``gp_pipelined``, warp-specialised FP32)
and kernel 7's (``gp_expanded``, the expanded form in three TF32 passes
on the tensor cores) live in ``csrc/gp_predict_variants.cu``, which keeps
one design of each. This module builds copies of that source with one
change each (``ALTERNATIVES``): a part of a body switched off, so that the
other part's time shows alone, or another choice the design could have
made. It times every copy's kernel in turns with kernel 1 and the
source's own two bodies, on the card, at the shapes of the bench's and
the cart-pole's kernel-1 inputs (Q = 10^6, d = 3, p = 2 and Q =
6,765,201, d = 5, p = 4; count 128, RBF), each as the device time of one
call in a CUDA graph. A copy whose part is switched off computes a wrong
answer: only its time means anything. On a machine with the card::

    python -m safe_learning_tpu_torch.benchmarks.variant_parts [NAME ...]

prints the card's name and power limit, then one JSON line a kernel and
shape. Each copy is one more ``nvcc`` of the variants' library (about 40
s, all at once).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics

import numpy as np
import torch

from ..ops import gp_kernel
from .pipelined_predict import card_line, kernel_inputs

__all__ = ["ALTERNATIVES", "SHAPES", "alternative_source", "build",
           "shape_inputs", "graph_ms", "run", "main"]

#: The expanded body's per-element branch on the count, in the source and
#: as it was before the fill went branch-free.
_BRANCH_FREE = (
    """            // Past n, vm is 0 and so is k: no branch in the loop.
            float r2 = (e ? xx2.y : xx2.x) - 2.f * cr[4 * c + 2 * h + e] +
                       qq[h];
            r2 = r2 > 0.f ? r2 : 0.f;
            const float k =
                cov_of<float, KIND>(r2, a.kind) * (e ? vm2.y : vm2.x);""",
    """            float k = 0.f;
            if (j + e < n) {
              float r2 = (e ? xx2.y : xx2.x) - 2.f * cr[4 * c + 2 * h + e] +
                         qq[h];
              r2 = r2 > 0.f ? r2 : 0.f;
              k = cov_of<float, KIND>(r2, a.kind) * (e ? vm2.y : vm2.x);
            }""")

#: Per name: the C entry it changes, what it measures, and the changes
#: ``(text in the source, replacement)``, each text found exactly once.
ALTERNATIVES = {
    "expanded_fill_only": (
        "gp_expanded", "kernel 7 without the solve's wgmma (the fill alone)",
        [("  const int steps = (lim + 7) / 8;", "  const int steps = 0;")]),
    "expanded_no_covariance": (
        "gp_expanded", "kernel 7 with k = 0: r2 formed, no covariance or "
        "scale",
        [("            const float k =\n                cov_of<float, KIND>"
          "(r2, a.kind) * (e ? vm2.y : vm2.x);",
          "            const float k = 0.f * r2;")]),
    "expanded_no_cross_term": (
        "gp_expanded", "kernel 7 without the fill's cross-term wgmma",
        [("      if (active) {\n        wgmma_fence();",
          "      if (false) {\n        wgmma_fence();")]),
    "expanded_count_branch": (
        "gp_expanded", "kernel 7 with a branch on j < n for each element",
        [_BRANCH_FREE]),
    "expanded_fill_regs_104": (
        "gp_expanded", "kernel 7 with 104 registers a fill and rows-0-63 "
        "thread, 200 a rows-64-127 thread (88, 128, 208 in the source)",
        [("    regs_dec<88>();\n    tf32_fill",
          "    regs_dec<104>();\n    tf32_fill"),
         ("    regs_inc<208>();", "    regs_inc<200>();"),
         ("  } else {\n    tf32_solve<0>(sm, a, items);",
          "  } else {\n    regs_dec<104>();\n    tf32_solve<0>(sm, a, items);")]),
    "pipelined_fill_only": (
        "gp_pipelined", "kernel 4 without the solve's FMAs (the fill alone)",
        [("      const int jend = r0 < n ? min(n, r0 + 16) : 0;",
          "      const int jend = 0;")]),
    "pipelined_solve_only": (
        "gp_pipelined", "kernel 4 without the fill's covariances (the solve "
        "alone)",
        [("    for (int j = j0; j < a.n; j += JS) {",
          "    for (int j = j0; j < 0; j += JS) {")]),
    "pipelined_unroll_2": (
        "gp_pipelined", "kernel 4 with the solve's j loop unrolled by 2 "
        "(4 in the source)",
        [("#pragma unroll 4\n      for (int j = 0; j < jend; ++j) {",
          "#pragma unroll 2\n      for (int j = 0; j < jend; ++j) {")]),
}

#: ``(label, Q, d, p)``: the bench's and the cart-pole's kernel-1 shapes.
SHAPES = (("bench", 10 ** 6, 3, 2), ("cartpole_51x4", 6_765_201, 5, 4))

_SOURCE = "gp_predict_variants.cu"


def alternative_source(name):
    """The variants' source with alternative ``name``'s changes."""
    from ..ops.build import CSRC_DIR

    with open(os.path.join(CSRC_DIR, _SOURCE)) as f:
        text = f.read()
    for old, new in ALTERNATIVES[name][2]:
        if text.count(old) != 1:
            raise ValueError("alternative {}: the text to change is not in "
                             "{} exactly once: {!r}".format(name, _SOURCE,
                                                            old))
        text = text.replace(old, new)
    return text


def build(names):
    """Build the alternatives ``names`` (one ``nvcc`` each, all at once)
    and bind each library as :func:`~..ops.gp_kernel.variants_library`
    binds the source's: ``{name: library}``."""
    from ..ops.build import load_libraries

    headers = ["gp_predict_stationary.cuh", "gp_predict_common.cuh"]
    libs = load_libraries([("variant_" + name, headers,
                            alternative_source(name)) for name in names])
    tail = [ctypes.c_int64] + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 3
    for lib in libs:
        for fn in (lib.gp_pipelined, lib.gp_expanded):
            fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 6 + tail
            fn.restype = ctypes.c_int
        lib.gp_variant_error_string.argtypes = [ctypes.c_int]
        lib.gp_variant_error_string.restype = ctypes.c_char_p
        lib.error_string = lib.gp_variant_error_string
        gp_kernel._limits(lib, lib.gp_variant_limits)
    return dict(zip(names, libs))


def shape_inputs(n_q, d, p, seed=0, count=128):
    """Kernel 1's inputs at a shape: an RBF GP (variance 1, lengthscales
    0.4) on ``count`` points uniform in ``[-1, 1]^d`` with ``p`` outputs,
    and ``n_q`` queries uniform in the same box, in float32 on the card."""
    from .. import GaussianProcess, RBF

    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (count, d))
    y = np.column_stack([np.sin((o + 1) * x.sum(axis=1)) for o in range(p)])
    gp = GaussianProcess(RBF(1.0, [0.4] * d, input_dim=d), x, y,
                         noise_variance=1e-4)
    return kernel_inputs(gp, rng.uniform(-1, 1, (n_q, d))), gp.count


def graph_ms(fn, reps=5, batch=5):
    """Median milliseconds of one call of ``fn`` on the device: ``batch``
    calls captured in a CUDA graph, replayed ``reps`` times between CUDA
    events."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(batch):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / batch)
    return statistics.median(times)


def run(libs, inputs, count, rounds=2):
    """Kernel 1, the source's two bodies and each alternative in ``libs``
    timed in turns, ``rounds`` rounds: ``{name: [ms of each round]}``."""
    def launcher(lib, entry):
        def c_function(bound, dtype):
            return getattr(bound, entry), (torch.finfo(dtype).bits // 8,)
        return lambda: gp_kernel.launch_stationary(
            c_function, lambda: lib, entry, *inputs, "rbf", count)

    source = gp_kernel.variants_library()
    calls = [("kernel1", lambda: gp_kernel.gp_predict_cuda(
        *inputs, kind="rbf", count=count)),
             ("pipelined", launcher(source, "gp_pipelined")),
             ("expanded", launcher(source, "gp_expanded"))]
    calls += [(name, launcher(lib, ALTERNATIVES[name][0]))
              for name, lib in libs.items()]
    runs = {name: [] for name, _ in calls}
    with torch.no_grad():
        for _ in range(rounds):
            for name, fn in calls:
                runs[name].append(graph_ms(fn))
    return runs


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
        raise SystemExit("variant_parts: needs an NVIDIA GPU")
    from ..config import config

    config.device = "cuda:0"
    card = card_line()
    print(card, flush=True)
    libs = build(args.names or sorted(ALTERNATIVES))
    results = {}
    for label, n_q, d, p in SHAPES:
        inputs, count = shape_inputs(n_q, d, p)
        runs = run(libs, inputs, count)
        base = statistics.mean(runs["kernel1"])
        for name, times in runs.items():
            ms = statistics.mean(times)
            entry = {"shape": label, "kernel": name, "ms": ms, "runs": times,
                     "of_kernel1": ms / base, "card": card,
                     "what": ALTERNATIVES[name][1] if name in ALTERNATIVES
                     else "the source's body" if name != "kernel1"
                     else "kernel 1"}
            print(json.dumps(entry), flush=True)
            results[label, name] = entry
        del inputs
    return results


if __name__ == "__main__":
    main()
