"""Benchmarks of the port's kernels on the card.

Counterparts of three scripts of the JAX package's ``benchmarks/`` folder,
which stays the JAX reference's and is not ported as a folder:

- :mod:`.pipelined_predict` (``benchmarks/pipelined_predict.py``): kernel
  1's pipelined, interleaved and folded variants, and ``run``, which times
  kernel 1 and every variant on one set of kernel inputs;
- :mod:`.distance_mxu_experiment` (``benchmarks/
  distance_mxu_experiment.py``): kernel 1 with the squared distance in the
  expanded form, timed beside kernel 1 with its error against a float64
  oracle;
- :mod:`.giant_sweep_1e8` (``benchmarks/giant_sweep_1e8.py``): the
  streamed sweep of ``bench.py``'s instance at 10001 x 10001 points
  through kernel 1, checked against a float64 oracle subsample.

The variants are hand-written CUDA kernels (``csrc/gp_predict_variants.
cu``). No path of the package routes through them.
"""
