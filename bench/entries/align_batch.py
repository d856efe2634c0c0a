"""Entry ``align_batch``: ``repro_torch.core.batch.align_batch`` on one
padded block a call, the block's codes in pinned host memory (on the card)
and its lengths as host arrays, with the traffic's ``with_traceback``.  A
call's answers are copied to pinned host memory behind it, so the next
call can be submitted before this one is harvested."""
from __future__ import annotations


class Caller:
    """Submits a block and harvests its answers to host numpy arrays."""

    def __init__(self, align, spec, params, blocks, fields, with_tb, dev):
        self.align, self.spec, self.params = align, spec, params
        self.blocks, self.fields, self.with_tb = blocks, fields, with_tb
        self.dev = dev
        self.cuda = dev.type == "cuda"

    def submit(self, k: int):
        import torch
        b = self.blocks
        out = self.align(self.spec, self.params, b.q[k], b.r[k],
                         b.pool[k].q_lens, b.pool[k].r_lens,
                         with_traceback=self.with_tb, device=self.dev)
        host = {}
        for f in self.fields:
            v = getattr(out, f)
            if self.cuda:
                h = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                h.copy_(v, non_blocking=True)
                host[f] = h
            else:
                host[f] = v
        ev = None
        if self.cuda:
            ev = torch.cuda.Event()
            ev.record()
        return k, host, ev

    @staticmethod
    def harvest(pending) -> tuple:
        k, host, ev = pending
        if ev is not None:
            ev.synchronize()
        return k, {f: v.numpy().copy() for f, v in host.items()}


def make(cell, blocks, dev, call=None) -> Caller:
    """The configuration's spec and parameters (tensors on ``dev``) behind
    ``align_batch``, or behind ``call`` where a test plants a fault; the
    answers harvested are the reference's fields."""
    import torch
    from bench import load_module
    from repro_torch.core.batch import align_batch
    config = cell.config
    ref = load_module("reference", config["reference"], cell.bench_dir)
    spec, params = load_module("programs", config["program"]["adapter"],
                               cell.bench_dir).make(config["program"])
    params = {k: v.to(dev) if isinstance(v, torch.Tensor) else v
              for k, v in params.items()}
    with_tb = bool(cell.traffic.get("with_traceback", False))
    fields = tuple(ref.FIELDS) + (tuple(ref.TB_FIELDS) if with_tb else ())
    return Caller(call or align_batch, spec, params, blocks, fields,
                  with_tb, dev)
