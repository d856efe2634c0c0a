"""Atomic checkpoints in the JAX package's layout (port of
``repro/checkpoint``)."""
from .manager import latest_step, restore, restore_latest, save  # noqa: F401
