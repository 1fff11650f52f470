"""The example scripts of the port: counterparts of the JAX package's
``examples/`` scripts, run as modules, for example
``python -m safe_learning_tpu_torch.examples.reinforcement_learning_cartpole
--full``."""
