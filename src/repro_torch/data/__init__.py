"""Deterministic synthetic data of the port (the LM batcher, the read and
genotyping-site simulators, the alignment launcher's read pairs)."""
from .synthetic import LMBatcher, genomics_pairs  # noqa: F401
