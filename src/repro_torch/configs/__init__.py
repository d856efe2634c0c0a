"""Architecture registry: importing this package registers every
architecture of the JAX package (with its reduced variant) into
``REGISTRY``."""
from __future__ import annotations

from .base import (REGISTRY, SHAPES, ModelConfig, ShapeSpec, cell_supported,
                   get)
from . import (stablelm_12b, phi3_medium_14b, command_r_plus_104b, olmo_1b,
               whisper_medium, llava_next_mistral_7b, qwen3_moe_30b_a3b,
               rwkv6_3b, recurrentgemma_9b, deepseek_v3_671b)  # noqa: F401

ARCH_NAMES = ["stablelm-12b", "phi3-medium-14b", "command-r-plus-104b",
              "olmo-1b", "whisper-medium", "llava-next-mistral-7b",
              "qwen3-moe-30b-a3b", "rwkv6-3b", "recurrentgemma-9b",
              "deepseek-v3-671b"]

__all__ = ["REGISTRY", "SHAPES", "ModelConfig", "ShapeSpec", "ARCH_NAMES",
           "cell_supported", "get"]
