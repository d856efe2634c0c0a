"""Three-term roofline from dry-run records, for the H100 SXM (port of
``repro/launch/roofline.py``, whose targets were a TPU v5e's).

  compute    = sum over dtypes of FLOPs_per_device[dtype] / peak[dtype]
  memory     = bytes_per_device / HBM bandwidth
  collective = sum over collectives of wire bytes / the link they cross

FLOPs, bytes and collectives come from ``launch.hlo_cost``, which counts
the eager program as it runs, K1-K4 by their own work formulas.  A TPU ran
everything at one bf16 peak; this card does not: bf16 and fp16 products
run on the tensor cores, f32 products on them too under TF32 (the counter
books those as ``tf32`` when the step allows TF32), and every other f32
operation (the CUDA-core kernels K3 in f32 and K4, f32 products without
TF32) on the CUDA cores, 15x slower than bf16.  So the compute term sums
each dtype's FLOPs over that dtype's peak.  Wire bytes apply ring-model
factors per collective: all-gather/reduce-scatter (g-1)/g, all-reduce
2(g-1)/g, all-to-all (g-1)/g, collective-permute 1.  A collective whose
group lies within one 8-card node (DGX H100: ranks 8n .. 8n+7) crosses
NVLink 4; one whose group spans nodes crosses each card's network port.

MODEL_FLOPS is the analytic useful-work count: 6*N_active*tokens for
training, 2*N_active*tokens for inference, with N_active excluding the
embedding table and counting only activated experts.  The ratio
MODEL_FLOPS/counted FLOPs surfaces remat recompute, causal-block waste and
TP head padding.  Every time this module gives is a prediction from counts
and data-sheet peaks, never a measurement.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs import ModelConfig, ShapeSpec
from repro_torch.tune.cost import H100, INT32_LANES_PER_SM, MEM_BYTES_PER_S

# NVIDIA H100 SXM5 data sheet, dense (no sparsity), per card
PEAK_BF16 = 989e12           # bf16 / fp16 tensor cores, FLOP/s
PEAK_TF32 = 495e12           # TF32 tensor cores, FLOP/s
PEAK_F32 = 67e12             # f32 outside the tensor cores, FLOP/s
HBM_BW = MEM_BYTES_PER_S     # 3.35e12 bytes/s, HBM3
HBM_BYTES = 80e9             # 80 GB of HBM3
NVLINK_BW = 450e9            # NVLink 4, bytes/s a direction, within a node
NET_BW = 50e9                # one 400 Gb/s NDR port a card, across nodes
NODE_CARDS = 8               # cards a DGX H100 node joins over NVLink
# INT32 lane operations/s (K1's and K2's PE work): 132 SMs x 64 lanes x
# 1980 MHz, the constants the tuner's cost model holds
PEAK_INT32 = H100.sms * INT32_LANES_PER_SM * H100.clock_hz

PEAKS = {"bf16": PEAK_BF16, "f16": PEAK_BF16, "tf32": PEAK_TF32,
         "f32": PEAK_F32, "int32": PEAK_INT32}

# (peak operations/s, memory bandwidth) per backend for the plan
# autotuner's pre-timing ranking.  Candidates at one sweep point share
# kernel, bucket and batch, so only the relative compute/memory balance
# matters; winners are still picked by measurement.  A DP fill's work is
# int32 PE operations (K1, K2), so the card's peak is its INT32 rate.
BACKEND_PEAKS = {
    "gpu": (PEAK_INT32, MEM_BYTES_PER_S),
    "cpu": (100e9, 30e9),
}

_WIRE = {"all-gather": lambda g: (g - 1) / g,
         "reduce-scatter": lambda g: (g - 1) / g,
         "all-reduce": lambda g: 2 * (g - 1) / g,
         "all-to-all": lambda g: (g - 1) / g,
         "collective-permute": lambda g: 1.0}


def _fields(rec):
    """(op, payload bytes, group size, trips, nodes spanned) of a
    collective record: a dict or a tuple of 4 (JAX's) or 5 entries."""
    if isinstance(rec, dict):
        return (rec["op"], rec["payload_bytes"], rec["group"],
                rec["trips"], rec.get("nodes", 1))
    return (*rec[:4], rec[4] if len(rec) > 4 else 1)


def _wire(rec) -> float:
    op, b, g, t, _ = _fields(rec)
    return 0.0 if g <= 1 else _WIRE[op](g) * b * t


def wire_bytes(collectives) -> float:
    """Per-device ring-model wire bytes from hlo_cost collective records."""
    return sum(_wire(rec) for rec in collectives)


def collective_seconds(collectives) -> float:
    """Wire seconds of the records: each over NVLink when its group lies in
    one node, else over the network port."""
    return sum(_wire(rec) / (NVLINK_BW if _fields(rec)[4] <= 1 else NET_BW)
               for rec in collectives)


# ---------------------------------------------------------------------------
# Analytic parameter counts (per layer kind), mirroring models/*
# ---------------------------------------------------------------------------
def _mixer_params(cfg: ModelConfig, kind: str, padded: bool) -> float:
    D, hd = cfg.d_model, cfg.head_dim
    H = cfg.n_heads_eff if padded else cfg.n_heads
    K = cfg.n_kv_eff if padded else cfg.n_kv_heads
    if kind in ("attn", "attn_local"):
        return D * H * hd + 2 * D * K * hd + H * hd * D
    if kind == "mla":
        ql, kl, rd = cfg.q_lora, cfg.kv_lora, cfg.rope_dim
        return (D * ql + ql * H * (hd + rd) + D * (kl + rd)
                + 2 * kl * H * hd + H * hd * D)
    if kind == "rglru":
        W = cfg.lru_width
        wb = W // cfg.n_heads            # block-diagonal gates
        return 2 * D * W + 2 * W * wb + W * D + cfg.conv_width * W
    if kind == "rwkv6":
        M = (cfg.rwkv_heads if padded else cfg.d_model // cfg.head_dim) * hd
        return 5 * D * M + D * 5 * 32 + D * 64 + 64 * M
    raise ValueError(kind)


def _ffn_params(cfg: ModelConfig, kind: str, active: bool) -> float:
    D = cfg.d_model
    if kind == "dense":
        return (3 if cfg.act in ("swiglu", "geglu") else 2) * D * cfg.d_ff
    if kind == "rwkv_cm":
        return 2 * D * cfg.d_ff
    # moe
    e = (cfg.top_k if active else cfg.n_experts)
    p = e * 3 * D * cfg.d_ff_expert + D * cfg.n_experts
    p += cfg.n_shared_experts * 3 * D * cfg.d_ff_expert
    return p


def param_count(cfg: ModelConfig, active: bool = False,
                padded: bool = False) -> float:
    """Non-embedding params (+ output head).  active=True -> MoE activated
    subset; padded=True -> include TP head padding (the counted view)."""
    total = 0.0
    for mixers_t, ffn_kind, repeat in cfg.layer_plan():
        per = sum(_mixer_params(cfg, k, padded) for k in mixers_t)
        per += len(mixers_t) * _ffn_params(cfg, ffn_kind, active)
        total += per * repeat
    V = cfg.vocab_eff if padded else cfg.vocab_size
    D = cfg.d_model
    total += D * V                       # output head (tied or not: used)
    if cfg.enc_dec:                      # encoder stack + cross attention
        enc = cfg.n_enc_layers * (
            _mixer_params(cfg, "attn", padded)
            + _ffn_params(cfg, "dense", active))
        cross = cfg.n_layers * _mixer_params(cfg, "attn", padded)
        total += enc + cross
    if cfg.mtp:
        total += (_mixer_params(cfg, cfg.pattern[0], padded)
                  + _ffn_params(cfg, "dense", active) + 2 * D * D)
    return total


def model_flops(cfg: ModelConfig, shape: ShapeSpec) -> float:
    """Global analytic useful FLOPs for one step of this cell."""
    N = param_count(cfg, active=True, padded=False)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        if cfg.enc_dec:
            tokens *= 2                  # encoder + decoder streams
        return 6.0 * N * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * N * tokens * (2 if cfg.enc_dec else 1)
    return 2.0 * N * shape.global_batch  # decode: one token per row


def attn_flops(cfg: ModelConfig, shape: ShapeSpec) -> float:
    """Causal-optimal attention score+value FLOPs (not in 6ND)."""
    B, S = shape.global_batch, shape.seq_len
    H, hd = cfg.n_heads, cfg.head_dim
    n_attn = sum(k in ("attn", "attn_local", "mla")
                 for k in cfg.pattern) / len(cfg.pattern) * cfg.n_layers
    if shape.kind == "decode":
        eff_s = S if cfg.window is None else min(cfg.window, S)
        per_tok = 2 * 2 * H * hd * eff_s   # read the visible cache
        return n_attn * B * per_tok
    eff = S * S / 2 if cfg.window is None else S * min(cfg.window, S)
    fl = n_attn * B * 2 * 2 * H * hd * eff
    if shape.kind == "train":
        fl *= 3                          # fwd + bwd(2x)
    return fl


@dataclasses.dataclass
class PlanRoofline:
    """Two-term roofline for one plan candidate (one card, no
    collectives): predicted seconds and predicted cells/sec, the quantity
    the autotuner ranks schedule candidates by before timing."""
    compute_s: float
    memory_s: float
    cells: float

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s)

    @property
    def cells_per_s(self) -> float:
        return self.cells / max(self.bound_s, 1e-12)

    @property
    def dominant(self) -> str:
        return "compute" if self.compute_s >= self.memory_s else "memory"


def plan_roofline(cost, cells: float, *, backend: str = "gpu",
                  trips: float = 1.0) -> PlanRoofline:
    """Roofline terms for one plan candidate from a ``hlo_cost.Cost``
    (usually :func:`hlo_cost.analyze_plan`'s).  The counter already runs
    every wavefront step of the eager program, so ``trips`` is 1 unless a
    caller scales one counted pass to several; both terms scale by it.
    Operations dominate DP fills (K1's int32 PE work, the traceback's
    elementwise passes), so the compute term uses ``flops +
    ewise_flops``."""
    peak, bw = BACKEND_PEAKS.get(backend, BACKEND_PEAKS["cpu"])
    return PlanRoofline(
        compute_s=(cost.flops + cost.ewise_flops) * trips / peak,
        memory_s=cost.bytes * trips / bw,
        cells=cells)


@dataclasses.dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float
    hlo_flops_global: float
    useful_ratio: float

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)


def compute_seconds(flops_by_dtype: Dict[str, float]) -> float:
    """Sum over dtypes of FLOPs over that dtype's peak."""
    return sum(n / PEAKS[dt] for dt, n in flops_by_dtype.items())


def from_record(rec: Dict, cfg: ModelConfig, shape: ShapeSpec) -> Roofline:
    """Build roofline terms from one dryrun JSONL record."""
    n_dev = rec.get("n_devices") or (512 if rec["mesh"] == "2x16x16"
                                     else 256)
    hc = rec["hlo_cost"]
    fl_dev = hc["flops_per_device"]
    mf = model_flops(cfg, shape) + attn_flops(cfg, shape)
    return Roofline(
        compute_s=compute_seconds(hc["flops_by_dtype"]),
        memory_s=hc["bytes_per_device"] / HBM_BW,
        collective_s=collective_seconds(hc["collectives"]),
        model_flops=mf,
        hlo_flops_global=fl_dev * n_dev,
        useful_ratio=mf / max(fl_dev * n_dev, 1.0),
    )
