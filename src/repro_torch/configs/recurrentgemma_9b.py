"""recurrentgemma-9b: hybrid (Griffin), 38L d=4096 16H (MQA kv=1)
d_ff=12288 v=256000.  [arXiv:2402.19427]

Temporal pattern 2x RG-LRU : 1x local attention (window 2048); 38 layers =
12 full (rglru, rglru, attn_local) periods + 2 trailing rglru layers.  Its
local attention runs K3 at head width 256 with 16 query heads over one
key/value head.  The JAX config's ``attn_chunk=1024`` (the TPU kernel's
block) has no field here: K3 works in its own 64-row tiles for every
config.
"""
import torch

from .base import ModelConfig, register

CONFIG = ModelConfig(
    name="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1, head_dim=256,
    d_ff=12288, vocab_size=256000,
    norm="rmsnorm", act="geglu", positional="rope",
    pattern=("rglru", "rglru", "attn_local"), window=2048,
    lru_width=4096, conv_width=4,
    accum_steps=2,
)

REDUCED = ModelConfig(
    name="recurrentgemma-9b-reduced", family="hybrid",
    n_layers=5, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
    d_ff=128, vocab_size=256,
    norm="rmsnorm", act="geglu", positional="rope",
    pattern=("rglru", "rglru", "attn_local"), window=16,
    lru_width=64, conv_width=4,
    param_dtype=torch.float32, compute_dtype=torch.float32, remat=False,
)

register(CONFIG, REDUCED)
