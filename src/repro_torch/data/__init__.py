"""Deterministic synthetic data of the port (the read simulator)."""
