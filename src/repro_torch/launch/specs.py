"""Per-cell specs (port of ``repro/launch/specs.py``): (arch x shape x mesh)
-> (fn, abstract args, in/out shardings).  The one source the dry run,
the roofline and the tests all run cells through.

``input_specs`` gives every model input as a ``meta`` tensor (shapes and
dtypes, no storage), JAX's ShapeDtypeStruct stand-ins.  Frontend stubs:
whisper gets precomputed frame embeddings, llava gets patch embeddings
spliced ahead of the token embeddings.  Each sharding is a
``sharding.MeshSharding`` from ``ShardCtx.leaf``/``tree``, where JAX's are
``NamedSharding``s, and a cell's ``fn`` runs the port's own
``make_train_step``, ``prefill`` and ``decode_step`` with ``sc=`` on
DTensors placed by them (``launch/dryrun.py::place_args``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import train as train_mod
from repro_torch.configs import ModelConfig, ShapeSpec
from repro_torch.configs.llava_next_mistral_7b import LLAVA_PATCHES
from repro_torch.models import get_model, lm as lm_mod, whisper as whisper_mod
from repro_torch.models.params import to_dtype
from repro_torch.optim import AdamWConfig, cosine_with_warmup
from repro_torch.sharding import (AxisRules, INFER_RULES, INFER_RULES_V2,
                                  TRAIN_RULES, TRAIN_RULES_V2)
from .shardctx import ShardCtx

__all__ = ["LLAVA_PATCHES", "Cell", "pick_rules", "batch_specs",
           "train_cell", "prefill_cell", "decode_cell", "build_cell",
           "input_specs"]


def pick_rules(cfg: ModelConfig, kind: str, version: str = "v1"):
    """v1 = paper-faithful baseline layouts; v2 = beyond-paper optimized
    (2-D expert sharding; TP-only inference params where they fit)."""
    if kind == "train":
        return TRAIN_RULES if version == "v1" else TRAIN_RULES_V2
    if version == "v2" and not cfg.infer_fsdp:
        return INFER_RULES_V2
    if version == "v2":                      # keep FSDP, still 2-D experts
        return AxisRules(dict(INFER_RULES.rules, **{
            "expert": INFER_RULES_V2.rules["expert"]}))
    return INFER_RULES


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


@dataclasses.dataclass
class Cell:
    name: str
    fn: Any                     # (args...) -> outputs
    args: Tuple                 # abstract (meta) tensors
    in_shardings: Tuple
    out_shardings: Any
    donate: Tuple[int, ...] = ()


def batch_specs(cfg: ModelConfig, shape: ShapeSpec):
    """Train/prefill input tree + logical axes."""
    B, S = shape.global_batch, shape.seq_len
    dt = to_dtype(cfg.compute_dtype)
    if cfg.enc_dec:
        return ({"frames": _meta((B, S, cfg.d_model), dt),
                 "tokens": _meta((B, S), torch.int32)},
                {"frames": ("batch", None, "embed"),
                 "tokens": ("batch", None)})
    if cfg.frontend == "vlm":
        P = min(LLAVA_PATCHES, S // 2)
        return ({"prefix_embeds": _meta((B, P, cfg.d_model), dt),
                 "tokens": _meta((B, S - P), torch.int32)},
                {"prefix_embeds": ("batch", None, "embed"),
                 "tokens": ("batch", None)})
    return ({"tokens": _meta((B, S), torch.int32)},
            {"tokens": ("batch", None)})


def train_cell(cfg: ModelConfig, shape: ShapeSpec, mesh,
               opt_cfg: Optional[AdamWConfig] = None,
               use_ef: bool = False, rules=TRAIN_RULES) -> Cell:
    opt_cfg = opt_cfg or AdamWConfig(quantized=True)
    sc = ShardCtx(mesh, rules)
    astate = train_mod.abstract_state(cfg, opt_cfg, use_ef=use_ef)
    slog = train_mod.state_logical(cfg, opt_cfg, use_ef=use_ef)
    state_sh = sc.tree(astate, slog)
    abatch, blog = batch_specs(cfg, shape)
    batch_sh = sc.tree(abatch, blog)
    step = train_mod.make_train_step(cfg, opt_cfg,
                                     cosine_with_warmup(3e-4, 2000, 100_000),
                                     sc=sc, use_ef=use_ef)
    return Cell(name=f"{cfg.name}:{shape.name}", fn=step,
                args=(astate, abatch),
                in_shardings=(state_sh, batch_sh),
                out_shardings=(state_sh, None),
                donate=(0,))


def _cache(cfg: ModelConfig, B: int, S: int, sc: ShardCtx):
    """(abstract cache, its shardings)."""
    if cfg.enc_dec:
        acache = whisper_mod.abstract_cache(cfg, B, S, S)
        return acache, sc.tree(acache, whisper_mod.cache_logical(cfg))
    acache = lm_mod.abstract_cache(cfg, B, S)
    return acache, sc.tree(acache, lm_mod.cache_logical(cfg))


def prefill_cell(cfg: ModelConfig, shape: ShapeSpec, mesh,
                 rules=INFER_RULES) -> Cell:
    sc = ShardCtx(mesh, rules)
    model = get_model(cfg)
    aparams = model.abstract(cfg)
    params_sh = sc.tree(aparams, model.logical(cfg))
    abatch, blog = batch_specs(cfg, shape)
    batch_sh = sc.tree(abatch, blog)
    _, cache_sh = _cache(cfg, shape.global_batch, shape.seq_len, sc)

    def fn(params, batch):
        return model.prefill(cfg, params, batch, sc=sc)

    return Cell(name=f"{cfg.name}:{shape.name}", fn=fn,
                args=(aparams, abatch),
                in_shardings=(params_sh, batch_sh),
                out_shardings=(None, cache_sh, None))


def decode_cell(cfg: ModelConfig, shape: ShapeSpec, mesh,
                rules=INFER_RULES) -> Cell:
    sc = ShardCtx(mesh, rules)
    model = get_model(cfg)
    aparams = model.abstract(cfg)
    params_sh = sc.tree(aparams, model.logical(cfg))
    B = shape.global_batch
    acache, cache_sh = _cache(cfg, B, shape.seq_len, sc)
    atok = _meta((B,), torch.int32)
    aklen = _meta((B,), torch.int32)
    tok_sh = sc.leaf(atok, ("batch",))

    def fn(params, cache, token, k_len):
        return model.decode_step(cfg, params, cache, token, k_len, sc=sc)

    return Cell(name=f"{cfg.name}:{shape.name}", fn=fn,
                args=(aparams, acache, atok, aklen),
                in_shardings=(params_sh, cache_sh, tok_sh, tok_sh),
                out_shardings=(None, cache_sh),
                donate=(1,))


def build_cell(cfg: ModelConfig, shape: ShapeSpec, mesh,
               rules_version: str = "v1", **kw) -> Cell:
    rules = pick_rules(cfg, shape.kind, rules_version)
    if shape.kind == "train":
        return train_cell(cfg, shape, mesh, rules=rules, **kw)
    if shape.kind == "prefill":
        return prefill_cell(cfg, shape, mesh, rules=rules)
    return decode_cell(cfg, shape, mesh, rules=rules)


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, Any]:
    """Public meta-tensor view of one cell's model inputs."""
    if shape.kind in ("train", "prefill"):
        return batch_specs(cfg, shape)[0]
    B, S = shape.global_batch, shape.seq_len
    cache = (whisper_mod.abstract_cache(cfg, B, S, S) if cfg.enc_dec
             else lm_mod.abstract_cache(cfg, B, S))
    return {"token": _meta((B,), torch.int32),
            "k_len": _meta((B,), torch.int32), "cache": cache}
