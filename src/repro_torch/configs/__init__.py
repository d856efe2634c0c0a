"""Architecture registry: importing this package registers the ported
architectures (with their reduced variants) into ``REGISTRY``."""
from __future__ import annotations

from .base import REGISTRY, ModelConfig, get
from . import olmo_1b, rwkv6_3b  # noqa: F401

ARCH_NAMES = ["olmo-1b", "rwkv6-3b"]

__all__ = ["REGISTRY", "ModelConfig", "ARCH_NAMES", "get"]
