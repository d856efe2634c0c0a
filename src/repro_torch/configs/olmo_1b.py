"""olmo-1b: dense LM, 16L d=2048 16H (MHA kv=16) d_ff=8192 v=50304.

[arXiv:2402.00838; non-parametric LayerNorm, SwiGLU, RoPE, tied embeddings]
"""
import torch

from .base import ModelConfig, register

CONFIG = ModelConfig(
    name="olmo-1b", family="dense",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=8192, vocab_size=50304,
    norm="layernorm_np", act="swiglu", positional="rope",
    tie_embeddings=True,
)

REDUCED = ModelConfig(
    name="olmo-1b-reduced", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=256,
    norm="layernorm_np", act="swiglu", positional="rope",
    tie_embeddings=True,
    param_dtype=torch.float32, compute_dtype=torch.float32,
)

register(CONFIG, REDUCED)
