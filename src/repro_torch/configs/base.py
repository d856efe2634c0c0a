"""Model configuration (port of ``repro/configs/base.py``).

Every architecture is a frozen ``ModelConfig``; ``layer_plan`` splits the
layer stack into groups of identical periods, each stored as one
layer-stacked parameter tree.  The fields are the JAX package's, so a
configuration carries across field for field; only the dtypes are torch's.
``SHAPES`` are the dry run's cells (``launch/dryrun.py``) and
``cell_supported`` says which of them an architecture runs.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # block structure -------------------------------------------------------
    norm: str = "rmsnorm"            # rmsnorm | layernorm | layernorm_np
    act: str = "swiglu"              # swiglu | geglu | gelu | relu2
    parallel_block: bool = False     # attn + mlp off one norm
    qk_norm: bool = False            # per-head q/k RMSNorm
    tie_embeddings: bool = False
    positional: str = "rope"         # rope | learned | none
    rope_theta: float = 10_000.0
    window: Optional[int] = None     # sliding-window width for 'attn_local'
    # temporal-mixer pattern: one period, tiled over the layer stack.
    # kinds: attn | attn_local | mla | rglru | rwkv6
    pattern: Tuple[str, ...] = ("attn",)
    # MoE --------------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    d_ff_expert: int = 0
    first_dense: int = 0
    router: str = "softmax"
    capacity_factor: float = 1.25
    moe_group: int = 256
    # MLA --------------------------------------------------------------------
    q_lora: int = 0
    kv_lora: int = 0
    rope_dim: int = 0
    # RG-LRU -----------------------------------------------------------------
    lru_width: int = 0
    conv_width: int = 4
    # encoder-decoder ----------------------------------------------------------
    enc_dec: bool = False
    n_enc_layers: int = 0
    # multi-token prediction ---------------------------------------------------
    mtp: bool = False
    mtp_weight: float = 0.3
    # modality frontend: None | audio | vlm
    frontend: Optional[str] = None
    # head / vocabulary padding (kept so parameters carry across shape for
    # shape) ------------------------------------------------------------------
    pad_heads_to: Optional[int] = None
    pad_kv_to: Optional[int] = None
    pad_vocab_to: Optional[int] = None
    # inference under INFER_RULES_V2: keep the FSDP split of the parameters
    # where the TP-only layout would not fit a card's memory
    infer_fsdp: bool = False
    # numerics ----------------------------------------------------------------
    param_dtype: Any = torch.bfloat16
    compute_dtype: Any = torch.bfloat16
    remat: bool = True               # train mode: recompute each period
    max_seq: int = 32_768
    accum_steps: int = 1             # grad-accumulation microbatches

    # -- derived -------------------------------------------------------------
    @property
    def n_heads_eff(self) -> int:
        return self.pad_heads_to or self.n_heads

    @property
    def n_kv_eff(self) -> int:
        return self.pad_kv_to or self.n_kv_heads

    @property
    def vocab_eff(self) -> int:
        return self.pad_vocab_to or self.vocab_size

    @property
    def q_dim(self) -> int:
        return self.n_heads_eff * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_eff * self.head_dim

    @property
    def subquadratic(self) -> bool:
        """True iff no full-context attention anywhere."""
        return all(k in ("rglru", "rwkv6", "attn_local") for k in self.pattern)

    @property
    def rwkv_heads(self) -> int:
        return self.pad_heads_to or (self.d_model // self.head_dim)

    def layer_plan(self):
        """Split the stack into groups: (period_mixers, ffn, repeat).  All
        layers of one group share structure, so each group's parameters are
        one tree stacked on a leading ``repeat`` axis."""
        ffn = "moe" if self.n_experts else (
            "rwkv_cm" if "rwkv6" in self.pattern else "dense")
        plan = []
        n = self.n_layers
        if self.first_dense:
            plan.append((self.pattern, "dense", self.first_dense))
            n -= self.first_dense
        p = len(self.pattern)
        full, rem = divmod(n, p)
        if full:
            plan.append((self.pattern, ffn, full))
        if rem:
            plan.append((self.pattern[:rem], ffn, 1))
        return plan


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode


SHAPES = {
    "train_4k":    ShapeSpec("train_4k",    4_096,   256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  ShapeSpec("decode_32k",  32_768,  128, "decode"),
    "long_500k":   ShapeSpec("long_500k",   524_288, 1,   "decode"),
}


def cell_supported(cfg: ModelConfig, shape: ShapeSpec):
    """(supported, reason): a 524k-token decode is skipped for every
    architecture with full-context attention, as in the JAX package."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, ("full-attention arch: 524k-token full-attention KV "
                       "decode is the quadratic case the assignment skips")
    return True, ""


# Populated by configs/__init__.py importing each architecture module.
REGISTRY: dict = {}


def register(cfg: ModelConfig, reduced: ModelConfig):
    REGISTRY[cfg.name] = (cfg, reduced)
    return cfg


def get(name: str, reduced: bool = False) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"no architecture {name!r} (registered: "
                       f"{sorted(REGISTRY)})")
    cfg, red = REGISTRY[name]
    return red if reduced else cfg
