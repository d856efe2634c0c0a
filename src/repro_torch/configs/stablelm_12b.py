"""stablelm-12b: dense LM, 40L d=5120 32H (GQA kv=8) d_ff=13824 v=100352.

[hf:stabilityai/stablelm-2-1_6b family; LayerNorm + SwiGLU + RoPE + GQA]
Head width 160: on the card its attention runs K3 at hd 160.
"""
import torch

from .base import ModelConfig, register

CONFIG = ModelConfig(
    name="stablelm-12b", family="dense",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, head_dim=160,
    d_ff=13824, vocab_size=100352,
    norm="layernorm", act="swiglu", positional="rope",
    accum_steps=2,
)

REDUCED = ModelConfig(
    name="stablelm-12b-reduced", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256,
    norm="layernorm", act="swiglu", positional="rope",
    param_dtype=torch.float32, compute_dtype=torch.float32, remat=False,
)

register(CONFIG, REDUCED)
