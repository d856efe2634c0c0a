"""Next-token cross-entropy with the z-loss, and the MoE and multi-token
prediction terms (port of ``repro/train/loss.py``).

On DTensor logits whose vocabulary is split over a mesh axis (``vocab`` on
'model' under ``TRAIN_RULES``), the log-sum-exp and the gold logit are
reduced over that axis explicitly (``_ce_sharded``): each rank holds its
vocabulary slice, the max and the sums are all-reduced over the axis's
group, and no rank gathers the (B, S, V) logits."""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

F32 = torch.float32


class _SumOver(torch.autograd.Function):
    """All-reduce (sum) over ``group`` whose result every rank then uses
    alike: the gradient of each rank's addend is the result's gradient
    itself, with no reduction."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def _ce_sharded(logits, labels, vocab_valid):
    """``_ce`` of DTensor logits (..., V) and labels (...), through
    ``sharding.on_shards``: the batch split as the logits' is, the
    vocabulary (the last dim) as it is over the other mesh axes, and the
    local slices reduced over those axes' group."""
    from repro_torch.sharding import on_shards, shard_dims
    mesh, last = logits.device_mesh, logits.ndim - 1
    bdims = shard_dims(logits, 0)
    vaxes = [i for i in shard_dims(logits, last) if i not in bdims]
    if len(vaxes) > 1:
        raise NotImplementedError("a vocabulary split over several mesh "
                                  "axes")
    V = logits.shape[-1]

    def local(x, lab):
        if not vaxes or mesh.size(vaxes[0]) == 1:
            return _ce(x, lab, vocab_valid)
        group = mesh.get_group(vaxes[0])
        v_loc = x.shape[-1]
        lo = mesh.get_local_rank(vaxes[0]) * v_loc
        if vocab_valid < V:
            valid = torch.arange(lo, lo + v_loc, device=x.device) < \
                vocab_valid
            x = torch.where(valid, x, -1e30)
        m = x.detach().amax(-1)
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
        se = _SumOver.apply(torch.exp(x - m[..., None]).sum(-1), group)
        lse = m + torch.log(se)
        idx = lab.long() - lo
        inside = (idx >= 0) & (idx < v_loc)
        gold = torch.gather(x, -1, idx.clamp(0, v_loc - 1)[..., None])[..., 0]
        gold = _SumOver.apply(torch.where(inside, gold, 0.0), group)
        return lse - gold, lse

    return on_shards(local, mesh, bdims, vaxes, [(0, last), (0, None)],
                     [(0, None), (0, None)])(logits, labels)


def _ce(logits, labels, vocab_valid):
    """logits: (..., V_eff) f32; labels: (...) int.  Padded vocab masked.
    -> (per-position cross-entropy, log-sum-exp)."""
    if isinstance(logits, DTensor):
        return _ce_sharded(logits, labels, vocab_valid)
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
    tokens = batch["tokens"]
    if not isinstance(tokens, DTensor):
        tokens = torch.as_tensor(tokens, device=logits.device)
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
