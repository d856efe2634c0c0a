"""llava-next-mistral-7b: VLM on a mistral-7b backbone, 32L d=4096 32H
(GQA kv=8) d_ff=14336 v=32000.  [hf:llava-hf/llava-v1.6-mistral-7b-hf]

The anyres vision tower is a stub, as in the JAX package: precomputed
patch embeddings (``prefix_embeds``) are prepended to the token
embeddings, so only the transformer backbone is modeled.
"""
import torch

from .base import ModelConfig, register

LLAVA_PATCHES = 2880            # anyres: 5 tiles x 576 patches

CONFIG = ModelConfig(
    name="llava-next-mistral-7b", family="vlm",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=32000,
    norm="rmsnorm", act="swiglu", positional="rope",
    frontend="vlm",
)

REDUCED = ModelConfig(
    name="llava-next-mistral-7b-reduced", family="vlm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256,
    norm="rmsnorm", act="swiglu", positional="rope",
    frontend="vlm",
    param_dtype=torch.float32, compute_dtype=torch.float32, remat=False,
)

register(CONFIG, REDUCED)
