"""rwkv6-3b (Finch): attention-free, 32L d=2560 d_ff=8960 v=65536.

[arXiv:2404.05892] Data-dependent decay WKV6 recurrence, head_dim=64
(40 heads, padded to 48 as in the JAX package so parameters carry across
shape for shape), squared-ReLU channel mix, LayerNorm.
"""
import torch

from .base import ModelConfig, register

CONFIG = ModelConfig(
    name="rwkv6-3b", family="ssm",
    n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40, head_dim=64,
    d_ff=8960, vocab_size=65536,
    norm="layernorm", act="relu2", positional="none",
    pattern=("rwkv6",),
    pad_heads_to=48,
)

REDUCED = ModelConfig(
    name="rwkv6-3b-reduced", family="ssm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=256,
    norm="layernorm", act="relu2", positional="none",
    pattern=("rwkv6",),
    param_dtype=torch.float32, compute_dtype=torch.float32,
)

register(CONFIG, REDUCED)
