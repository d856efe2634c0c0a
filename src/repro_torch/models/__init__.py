"""Model zoo of the port: the generic decoder-only LM (``lm``, over the GQA,
MLA, RG-LRU and RWKV-6 mixers, the dense, MoE and RWKV channel-mix FFNs,
multi-token prediction and the multimodal prefix) and the whisper
encoder-decoder (``whisper``), dispatched by config: ``get_model(cfg)``
returns the module for every architecture the JAX package registers."""
from __future__ import annotations

from . import layers, lm, mixers, moe, params, whisper  # noqa: F401


def get_model(cfg):
    return whisper if cfg.enc_dec else lm
