"""Deterministic synthetic data of the port (the LM batcher, the read and
genotyping-site simulators)."""
from .synthetic import LMBatcher  # noqa: F401
