"""qwen3-moe-30b-a3b: MoE LM, 48L d=2048 32H (GQA kv=4) v=151936,
128 experts top-8, expert d_ff=768.  [hf:Qwen/Qwen3-30B-A3B]

head_dim=128 (q projection 4096 > d_model, as in the HF config); per-head
q/k RMSNorm; softmax router with renormalized top-8; no shared expert.
``infer_fsdp=True``, as in the JAX config: keep FSDP-sharded parameters
at inference on a mesh.  On one card its 30.5 B bf16 parameters (61 GB)
fit whole.
"""
import torch

from .base import ModelConfig, register

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, head_dim=128,
    d_ff=768, vocab_size=151936,
    norm="rmsnorm", act="swiglu", positional="rope", rope_theta=1e6,
    qk_norm=True,
    n_experts=128, top_k=8, d_ff_expert=768, router="softmax",
    infer_fsdp=True,
    accum_steps=2,
)

REDUCED = ModelConfig(
    name="qwen3-moe-30b-a3b-reduced", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=32, vocab_size=256,
    norm="rmsnorm", act="swiglu", positional="rope",
    qk_norm=True,
    n_experts=8, top_k=2, d_ff_expert=32, router="softmax", moe_group=16,
    capacity_factor=8.0,    # no-drop at smoke scale -> exact consistency
    param_dtype=torch.float32, compute_dtype=torch.float32, remat=False,
)

register(CONFIG, REDUCED)
