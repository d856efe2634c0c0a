"""whisper-medium: audio encoder-decoder, 24+24L d=1024 16H (MHA)
d_ff=4096 v=51865.  [arXiv:2212.04356]

The conv frontend is a stub, as in the JAX package: inputs arrive as
precomputed frame embeddings (batch, frames, d).  Learned positional
embeddings, GELU MLP, pre-LayerNorm; the decoder caches its self k/v and
the cross k/v projected once from the encoder states.  Vocabulary padded
51865 -> 51872 (the JAX package's 16-way tensor-parallel padding, kept so
parameters carry across shape for shape).
"""
import torch

from .base import ModelConfig, register

CONFIG = ModelConfig(
    name="whisper-medium", family="audio",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
    d_ff=4096, vocab_size=51865,
    norm="layernorm", act="gelu", positional="learned",
    enc_dec=True, n_enc_layers=24, frontend="audio",
    pad_vocab_to=51_872,
    max_seq=32_768,
)

REDUCED = ModelConfig(
    name="whisper-medium-reduced", family="audio",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=256,
    norm="layernorm", act="gelu", positional="learned",
    enc_dec=True, n_enc_layers=2, frontend="audio",
    max_seq=128,
    param_dtype=torch.float32, compute_dtype=torch.float32, remat=False,
)

register(CONFIG, REDUCED)
