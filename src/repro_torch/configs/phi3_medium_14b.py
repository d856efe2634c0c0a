"""phi3-medium-14b: dense LM, 40L d=5120 40H (GQA kv=10) d_ff=17920
v=100352.

[arXiv:2404.14219; RoPE + SwiGLU + GQA + RMSNorm]
Heads padded to 48/16 as in the JAX package (its 16-way model axis), so
parameters carry across shape for shape; the GQA ratio stays 3:1.
"""
import torch

from .base import ModelConfig, register

CONFIG = ModelConfig(
    name="phi3-medium-14b", family="dense",
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=10, head_dim=128,
    d_ff=17920, vocab_size=100352,
    norm="rmsnorm", act="swiglu", positional="rope",
    pad_heads_to=48, pad_kv_to=16,
    accum_steps=2,
)

REDUCED = ModelConfig(
    name="phi3-medium-14b-reduced", family="dense",
    n_layers=2, d_model=80, n_heads=5, n_kv_heads=1, head_dim=16,
    d_ff=160, vocab_size=256,
    norm="rmsnorm", act="swiglu", positional="rope",
    param_dtype=torch.float32, compute_dtype=torch.float32, remat=False,
)

register(CONFIG, REDUCED)
