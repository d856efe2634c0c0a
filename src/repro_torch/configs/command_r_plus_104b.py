"""command-r-plus-104b: dense LM, 64L d=12288 96H (GQA kv=8) d_ff=33792
v=256000.  [hf:CohereForAI/c4ai-command-r-v01 family]

Cohere-style block: parallel attention + FFN off a single LayerNorm, no
biases, per-head q/k norm.
"""
import torch

from .base import ModelConfig, register

CONFIG = ModelConfig(
    name="command-r-plus-104b", family="dense",
    n_layers=64, d_model=12288, n_heads=96, n_kv_heads=8, head_dim=128,
    d_ff=33792, vocab_size=256000,
    norm="layernorm", act="swiglu", positional="rope",
    parallel_block=True, qk_norm=True,
    infer_fsdp=True,
    accum_steps=4,
)

REDUCED = ModelConfig(
    name="command-r-plus-104b-reduced", family="dense",
    n_layers=2, d_model=96, n_heads=6, n_kv_heads=2, head_dim=16,
    d_ff=192, vocab_size=256,
    norm="layernorm", act="swiglu", positional="rope",
    parallel_block=True, qk_norm=True,
    param_dtype=torch.float32, compute_dtype=torch.float32, remat=False,
)

register(CONFIG, REDUCED)
