"""Request kinds: one module each, named by a workload's ``request``."""
