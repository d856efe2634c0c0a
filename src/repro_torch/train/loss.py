"""Next-token cross-entropy with the z-loss, and the MoE and multi-token
prediction terms (port of ``repro/train/loss.py``).  The MoE and MTP terms
are written as JAX writes them; ``models.get_model`` still refuses the
configs that produce them."""
from __future__ import annotations

import torch

F32 = torch.float32


def _ce(logits, labels, vocab_valid):
    """logits: (..., V_eff) f32; labels: (...) int.  Padded vocab masked.
    -> (per-position cross-entropy, log-sum-exp)."""
    V = logits.shape[-1]
    if vocab_valid < V:
        mask = torch.arange(V, device=logits.device) < vocab_valid
        logits = torch.where(mask, logits, -1e30)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return lse - gold, lse


def lm_loss(cfg, out, batch, z_coef: float = 1e-4, aux_coef: float = 1e-2):
    """-> (scalar loss, metrics dict of 0-dim tensors)."""
    logits = out["logits"].to(F32)
    prefix = out.get("prefix", 0)
    tokens = torch.as_tensor(batch["tokens"], device=logits.device)
    St = tokens.shape[1]
    preds = logits[:, prefix:prefix + St - 1]
    labels = tokens[:, 1:]
    ce, lse = _ce(preds, labels, cfg.vocab_size)
    loss = ce.mean()
    zl = z_coef * lse.square().mean()
    total = loss + zl
    metrics = {"ce": loss, "z_loss": zl}
    aux = out.get("aux_loss", 0.0)
    if cfg.n_experts:
        total = total + aux_coef * aux
        metrics["moe_aux"] = aux
    if "mtp_logits" in out:
        mtp_ce, _ = _ce(out["mtp_logits"][:, :-1].to(F32), tokens[:, 2:],
                        cfg.vocab_size)
        mtp = mtp_ce.mean()
        total = total + cfg.mtp_weight * mtp
        metrics["mtp_ce"] = mtp
    metrics["loss"] = total
    return total, metrics
