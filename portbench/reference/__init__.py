"""The plain reference: float64 NumPy and PyTorch, independent of the port.

Nothing here imports ``jax``, the JAX package or the PyTorch port. It works
out the dynamics, the LQR policy, the candidate, the GP posterior, the
decrease verdicts (coarse and refined), the refinement walk and the level
cut again from the inputs the harness made, and judges the port's outputs
against them (``judge``).
"""
