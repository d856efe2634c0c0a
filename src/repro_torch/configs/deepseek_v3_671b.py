"""deepseek-v3-671b: MoE LM, 61L d=7168 128H d_ff(expert)=2048 v=129280,
MLA + 1 shared + 256 routed experts top-8 + MTP.  [arXiv:2412.19437]

MLA: q_lora=1536, kv_lora=512, decoupled rope_dim=64, head_dim=128; train
and prefill run K3 with q/k of 128 + 64 and v of 128, and decode uses the
absorbed-projection form, so the cache stores only the 576-wide latent a
token.  The first 3 layers use a dense FFN (d_ff=18432, as in the HF
config; 2048 is the routed expert width).  Sigmoid router with top-8.
``infer_fsdp=True``, as in the JAX config: its 1.26 TB of experts cannot
be held whole by one device.
"""
import torch

from .base import ModelConfig, register

CONFIG = ModelConfig(
    name="deepseek-v3-671b", family="moe",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128, head_dim=128,
    d_ff=18432, vocab_size=129280,
    norm="rmsnorm", act="swiglu", positional="rope",
    pattern=("mla",),
    n_experts=256, top_k=8, n_shared_experts=1, d_ff_expert=2048,
    first_dense=3, router="sigmoid",
    q_lora=1536, kv_lora=512, rope_dim=64,
    mtp=True,
    infer_fsdp=True,
    accum_steps=4,
)

REDUCED = ModelConfig(
    name="deepseek-v3-671b-reduced", family="moe",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=256,
    norm="rmsnorm", act="swiglu", positional="rope",
    pattern=("mla",),
    n_experts=8, top_k=2, n_shared_experts=1, d_ff_expert=32,
    first_dense=1, router="sigmoid",
    q_lora=32, kv_lora=16, rope_dim=8,
    mtp=True, moe_group=16,
    capacity_factor=8.0,    # no-drop at smoke scale -> exact consistency
    param_dtype=torch.float32, compute_dtype=torch.float32, remat=False,
)

register(CONFIG, REDUCED)
