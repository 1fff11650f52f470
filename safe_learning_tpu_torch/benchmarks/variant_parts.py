"""The parts and the alternatives of kernels 4-7's float32 bodies, timed.

Kernel 4's float32 tiled body (``gp_pipelined``, warp-specialised FP32),
kernel 5's (``gp_interleaved``, independent warpgroup chains), kernel 6's
(``gp_folded``, the folded product in three TF32 passes on the tensor
cores) and kernel 7's (``gp_expanded``, the expanded form in three TF32
passes) live in ``csrc/gp_predict_variants.cu``, which keeps one design
of each. This module builds copies of that source with one change each
(``ALTERNATIVES``): a part of a body switched off, so that the other
part's time shows alone, or another choice the design could have made.
It times every copy's kernel in turns with kernel 1 and the source's own
bodies (kernel 5 at halves 2 and 4), on the card, at the shapes of the
bench's and the cart-pole's kernel-1 inputs (Q = 10^6, d = 3, p = 2 and
Q = 6,765,201, d = 5, p = 4) and at eight outputs (Q = 10^6, d = 2,
p = 8); count 128, RBF; each as the device time of one call in a CUDA
graph. A copy whose part is switched off computes a wrong answer: only
its time means anything. On a machine with the card::

    python -m safe_learning_tpu_torch.benchmarks.variant_parts [NAME ...]

prints the card's name and power limit, then one JSON line a kernel and
shape. Each copy is one more ``nvcc`` of the variants' library (about 40
s, all at once).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics

import numpy as np
import torch

from ..ops import gp_kernel
from .pipelined_predict import HALVES, card_line, fold_chol_inv, kernel_inputs

__all__ = ["ALTERNATIVES", "ENTRIES", "SHAPES", "alternative_source",
           "build", "shape_inputs", "graph_ms", "entry_calls", "run", "main"]

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

#: The C entries of the variants' library, in the order ``run`` times the
#: source's bodies.
ENTRIES = ("gp_pipelined", "gp_interleaved", "gp_folded", "gp_expanded")

#: The solve's j loop of kernels 4 and 5 (``ws_rows``) and the fill loop
#: they share (``fill_column``), and kernels 6 and 7's solve steps
#: (``tf32_solve``).
_WS_SOLVE = ("  const int jend = r0 < n ? min(n, r0 + 16) : 0;",
             "  const int jend = 0;")
_WS_FILL = ("  for (int j = j0; j < a.n; j += JS) {",
            "  for (int j = j0; j < 0; j += JS) {")
_TF32_SOLVE = ("  const int steps = (lim + 7) / 8;", "  const int steps = 0;")

#: Per name: the C entry it changes, what it measures, and the changes
#: ``(text in the source, replacement)``, each text found exactly once.
ALTERNATIVES = {
    "expanded_fill_only": (
        "gp_expanded", "kernel 7 without the solve's wgmma (the fill alone)",
        [_TF32_SOLVE]),
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
    "pipelined_fill_only": (
        "gp_pipelined", "kernel 4 without the solve's FMAs (the fill alone)",
        [_WS_SOLVE]),
    "pipelined_solve_only": (
        "gp_pipelined", "kernel 4 without the fill's covariances (the solve "
        "alone)",
        [_WS_FILL]),
    "interleaved_fill_only": (
        "gp_interleaved", "kernel 5 without the solve's FMAs (the chains' "
        "fills alone)",
        [_WS_SOLVE]),
    "interleaved_solve_only": (
        "gp_interleaved", "kernel 5 without the fill's covariances (the "
        "chains' solves alone)",
        [_WS_FILL]),
    "interleaved_tile_8x4": (
        "gp_interleaved", "kernel 5 with 8 x 4 register tiles and 64-query "
        "tiles at both halves (8 x 8 and 128 at halves 2 in the source)",
        [("  static constexpr int TN = HS == 2 ? 8 : 4;",
          "  static constexpr int TN = 4;")]),
    "folded_fill_only": (
        "gp_folded", "kernel 6 without the solve's wgmma (the fill alone)",
        [_TF32_SOLVE]),
    "folded_solve_only": (
        "gp_folded", "kernel 6 without the fill (the solve alone, on the "
        "zeroed K slots)",
        [("      if (j >= n) break;\n      float r2[4]",
          "      if (true) break;\n      float r2[4]")]),
    "folded_unfolded": (
        "gp_folded", "kernel 6 with var_s2 mask_j multiplied into each k in "
        "the fill, as kernels 1 and 7 do (one 16-byte load and 4 multiplies "
        "a 4-row group; gp_folded takes no scale or mask, so the factor is "
        "1 below the count and 0 past it)",
        [("      for (int e = 0; e < 4; ++e) k[e] = cov_of<float, KIND>"
          "(r2[e], a.kind);",
          "      for (int e = 0; e < 4; ++e) k[e] = cov_of<float, KIND>"
          "(r2[e], a.kind) * vm[e];"),
         ("      float k[4];\n#pragma unroll\n",
          "      float k[4];\n      const float4 vm4 = *reinterpret_cast<"
          "const float4*>(sm.vm + j);\n      const float vm[4] = {vm4.x, "
          "vm4.y, vm4.z, vm4.w};\n#pragma unroll\n"),
         ("  }, [&](int64_t items) { folded_fill<KIND>(sm, a, items); });",
          "    for (int j = threadIdx.x; j < NBV; j += Tf32::NTH) {\n"
          "      sm.vm[j] = j < a.n ? 1.f : 0.f;\n    }\n"
          "  }, [&](int64_t items) { folded_fill<KIND>(sm, a, items); });")]),
}

#: ``(label, Q, d, p)``: the bench's and the cart-pole's kernel-1 shapes,
#: and the most outputs one GP may have (``P_MAX``), where kernel 5's
#: chains write their partial sums over their K tiles.
SHAPES = (("bench", 10 ** 6, 3, 2), ("cartpole_51x4", 6_765_201, 5, 4),
          ("outputs_8", 10 ** 6, 2, 8))

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
    return {name: gp_kernel.bind_variants(lib)
            for name, lib in zip(names, libs)}


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


def entry_calls(lib, entry, inputs, count):
    """``[(suffix, call)]`` of C entry ``entry`` of a bound variants
    library on kernel 1's ``inputs``: ``gp_interleaved`` at each of
    ``HALVES`` (suffixes ``_halves2``, ``_halves4``), ``gp_folded`` on the
    folded ``chol_inv`` (made here), the others once."""
    def launcher(lead, args):
        def c_function(bound, dtype):
            return getattr(bound, entry), (torch.finfo(dtype).bits // 8,) \
                + lead
        return lambda: gp_kernel.launch_stationary(
            c_function, lambda: lib, entry, *args, "rbf", count)

    if entry == "gp_interleaved":
        return [("_halves{}".format(h), launcher((h,), inputs))
                for h in HALVES]
    if entry == "gp_folded":
        q, x, li, alpha, mask, var_s2 = inputs
        return [("", launcher((), (q, x, fold_chol_inv(li, mask, var_s2),
                                   alpha, None, None)))]
    return [("", launcher((), inputs))]


def run(libs, inputs, count, rounds=2):
    """Kernel 1, the source's bodies and each alternative in ``libs``
    timed in turns, ``rounds`` rounds: ``{name: [ms of each round]}``
    (kernel 5's names end in its halves, ``entry_calls``)."""
    source = gp_kernel.variants_library()
    calls = [("kernel1", lambda: gp_kernel.gp_predict_cuda(
        *inputs, kind="rbf", count=count))]
    for entry in ENTRIES:
        calls += [(entry[3:] + suffix, fn) for suffix, fn in
                  entry_calls(source, entry, inputs, count)]
    for name, lib in libs.items():
        calls += [(name + suffix, fn) for suffix, fn in
                  entry_calls(lib, ALTERNATIVES[name][0], inputs, count)]
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
            alt = name.split("_halves")[0]
            entry = {"shape": label, "kernel": name, "ms": ms, "runs": times,
                     "of_kernel1": ms / base, "card": card,
                     "what": ALTERNATIVES[alt][1] if alt in ALTERNATIVES
                     else "the source's body" if name != "kernel1"
                     else "kernel 1"}
            print(json.dumps(entry), flush=True)
            results[label, name] = entry
        del inputs
    return results


if __name__ == "__main__":
    main()
