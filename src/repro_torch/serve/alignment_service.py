"""The paper's accelerator as a service (counterpart of
``repro.serve.alignment_service``): batched DP alignment on one device.

This is the N_K x N_B arbiter of DP-HLS §5.3: requests queue up per
``(kernel, length-bucket)`` channel (heterogeneous kernels = multiple
channels, the paper's "mix of global and local aligners"), are padded to
their *bucket* — not a global ``max_len`` — and dispatched through the
shared ``repro_torch.runtime`` plan cache.  A 40-base query therefore pays
the wavefront cost of a 64-cell bucket, not of the service-wide maximum.
On the card a batch is one K1 launch and its traceback walk; the opt-in
prefilter rung and the overload answers are K2 launches.

The queue/admission/dispatch machinery lives in
:class:`repro_torch.serve.gateway.Gateway`; this module contributes only
what is alignment-specific — the per-kernel channel (bucketing, padding,
the ``myers`` prefilter rung, plan resolution, result landing) and the
service facade.  Each batch is padded once on the host, in pinned memory
when the device is a GPU, and copied to the device once.  Multi-GPU
placement (JAX's ``mesh=``) is ROADMAP queue 1 item 14; the service refuses
``mesh`` until it is ported.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import kernels_zoo
from repro_torch.core.kernels_zoo import edit as edit_kernel
from repro_torch.core.spec_utils import params_on_device
from repro_torch.core.traceback import moves_to_cigar, raise_if_truncated
from repro_torch.runtime import bucketing
from repro_torch.runtime import plan as plan_mod

from . import gateway as gateway_mod
from .gateway import (FaultPlan, Gateway, InflightBatch, ServiceOverloaded,
                      ShedOverload)

__all__ = ["AlignRequest", "AlignFuture", "AlignmentService",
           "InflightBatch", "ServiceOverloaded"]


@dataclasses.dataclass(eq=False)   # identity semantics: ndarray fields
class AlignRequest:
    rid: int
    kernel: str                  # kernels_zoo name
    query: np.ndarray
    ref: np.ndarray
    result: Optional[dict] = None
    gen: int = 0                 # bumped on every re-submission
    waits: int = 0               # batch pops this request was passed over
    attempts: int = 0            # failed dispatches (bounded-retry budget)
    not_before: float = 0.0      # retry backoff gate
    deadline: Optional[float] = None


class AlignFuture:
    """Lightweight handle returned by ``submit``; resolving it drives the
    service's dispatcher loop (single-process: there is no background
    thread — ``result()`` pumps ``wait`` until this request completes).
    A dead-lettered request resolves with the typed error dict
    (``result()["failed"]``) instead of hanging."""

    __slots__ = ("req", "_svc")

    def __init__(self, req: AlignRequest, svc: "AlignmentService"):
        self.req = req
        self._svc = svc

    def done(self) -> bool:
        return self.req.result is not None

    def result(self, worker: str = "w0") -> dict:
        if not self.done():
            self._svc.wait([self], worker=worker)
        if self.req.result is None:
            raise RuntimeError(f"request {self.req.rid} did not complete")
        return self.req.result

    def __repr__(self):
        state = "done" if self.done() else "pending"
        return f"AlignFuture(rid={self.req.rid}, {state})"


# serving-side filter ladder: one module-level screen spec so every
# prefilter batch lands on the same plan-cache keys
_PREFILTER_SPEC = edit_kernel.edit_search()


class _AlignChannel(gateway_mod.Channel):
    """One kernel's channel: queue keys stay ``(kernel, bucket)`` and the
    dispatch record keeps its historical shape."""

    def __init__(self, svc: "AlignmentService", kernel: str):
        self.svc = svc
        self.name = kernel

    def bucket_of(self, job: AlignRequest) -> Tuple[int, int]:
        return self.svc._bucket(job)

    def job_len(self, job: AlignRequest) -> int:
        return len(job.query) + len(job.ref)

    def block_for(self, bucket) -> int:
        return self.svc.block_for(self.name, bucket)

    def coalesce(self, bucket, jobs, block):
        svc = self.svc
        if not svc.coalesce:
            return bucket, block, False
        grown = svc._coalesce_batch(self.name, bucket, jobs, block)
        if grown == bucket:
            return bucket, block, False
        # re-cap the pad rows at the grown bucket
        return grown, max(len(jobs),
                          min(block, self.block_for(grown))), True

    def launch(self, bucket, reqs, block):
        svc = self.svc
        spec, params = svc._channel(self.name)
        batch = svc._pad_batch(reqs, bucket, spec, block)
        if svc._screenable(spec):
            # ladder rung 1: rejects resolve here; only survivors
            # (rebound into ``reqs`` so a failing main launch requeues
            # exactly the requests still owed a result) pay the full
            # plan below
            reqs, batch = svc._prefilter_batch(spec, reqs, bucket, batch,
                                               block)
            if not reqs:
                return [], None
        qs, rs, ql, rl = batch
        plan = plan_mod.get_plan(
            spec, svc.engine_name, tuple(qs.shape[1:]), tuple(rs.shape[1:]),
            batch_size=block,
            with_traceback=svc.with_traceback and spec.traceback is not None,
            device=svc.device)
        out = plan(params, *svc._to_device(qs, rs), ql, rl)
        return reqs, out

    def materialize(self, out):
        score = out.score.cpu().numpy()
        end_i = out.end_i.cpu().numpy()
        end_j = out.end_j.cpu().numpy()
        moves = n_moves = None
        if getattr(out, "moves", None) is not None:
            truncated = out.truncated.cpu().numpy()
            moves = out.moves.cpu().numpy()
            n_moves = out.n_moves.cpu().numpy()
            # never emit a corrupt path
            raise_if_truncated(dataclasses.replace(out, truncated=truncated))
        return score, end_i, end_j, moves, n_moves

    def land(self, job: AlignRequest, i: int, host) -> int:
        score, end_i, end_j, moves, n_moves = host
        res = {"score": float(score[i]),
               "end": (int(end_i[i]), int(end_j[i]))}
        if moves is not None:
            res["cigar"] = moves_to_cigar(moves[i], int(n_moves[i]))
        job.result = res
        return 1

    def record(self, bucket, n, coalesced):
        return {"kernel": self.name, "bucket": bucket, "n": n,
                "coalesced": coalesced}

    # -- overload degradation: answer with the myers screen ------------------
    @property
    def can_degrade(self) -> bool:
        svc = self.svc
        if svc.degrade != "myers":
            return False
        spec, _ = svc._channel(self.name)
        return spec.char_shape == () and spec.char_dtype == torch.uint8

    def launch_degraded(self, bucket, reqs, block) -> None:
        """Past the degrade watermark, answer the whole batch with the
        bit-parallel edit-distance screen (K2; exact distance: the
        threshold is set beyond the bucket perimeter so it never clips).
        Degraded results are typed (``degraded: True``, ``score =
        -distance``) so callers can tell an approximation from a full
        alignment."""
        svc = self.svc
        spec, _ = svc._channel(self.name)
        qs, rs, ql, rl = svc._pad_batch(reqs, bucket, spec, block)
        params = edit_kernel.default_params(bucket[0] + bucket[1])
        screen = plan_mod.get_plan(
            _PREFILTER_SPEC, svc.prefilter_engine,
            tuple(qs.shape[1:]), tuple(rs.shape[1:]), batch_size=block,
            with_traceback=False, mode="fill", device=svc.device)
        out = screen(params, *svc._to_device(qs, rs), ql, rl)
        dist = out.score.cpu().numpy()[: len(reqs)]
        for r, d in zip(reqs, dist):
            if r.result is not None:
                continue
            r.result = {"score": -float(d), "edit_distance": int(d),
                        "end": (0, 0), "degraded": True}
            svc._job_resolved(r, 1, "degraded")


class AlignmentService(Gateway):
    """Alignment channels on the unified gateway, on one device.

    ``device`` is where the plans run: the card unless the caller passes
    ``device="cpu"`` (the kernels' plain versions); without a CUDA device
    the service raises rather than falling back.  ``mesh`` (JAX's sharded
    channels) is refused until multi-GPU placement is ported.  ``max_len``
    caps request lengths (the largest bucket is ``max_len`` snapped up to
    the bucket grid); ``min_bucket`` floors the smallest.
    ``pipeline_depth`` is how many batches may be in flight on the device
    at once (1 = synchronous).

    ``tb_budget_bytes`` sizes batches by memory instead of the fixed
    ``block``: each (kernel, bucket) channel launches as many alignments
    as fit the traceback-store budget (never fewer than ``block``, at most
    ``max_block``).  Bit-packed pointers cut the per-alignment footprint
    by the kernel's ``tb_pack``, so the same budget admits up to 4x larger
    blocks.

    ``max_pending`` bounds how many submitted-but-incomplete requests the
    service holds (queued + in flight); ``backpressure`` picks what
    ``submit`` does at the budget: ``'block'`` works one batch at a time
    off the queues until there is room, ``'raise'`` sheds the request with
    :class:`ServiceOverloaded`, and ``'shed'`` resolves the newest request
    immediately with a typed ``shed`` error result.

    The robustness knobs (``fault_plan``, ``max_retries``,
    ``retry_backoff_s``, ``deadline_s``, ``harvest_timeout_s``,
    ``degrade``/``degrade_watermark``) and the multi-worker ``serve()``
    pool are inherited from :class:`~repro_torch.serve.gateway.Gateway`.
    """

    def __init__(self, max_len: int = 256, block: int = 8, mesh=None,
                 engine_name: str = "wavefront", with_traceback: bool = True,
                 redispatch_after: float = 60.0,
                 min_bucket: int = bucketing.DEFAULT_MIN_BUCKET,
                 coalesce: bool = True, pipeline_depth: int = 2,
                 tb_budget_bytes: Optional[int] = None, max_block: int = 256,
                 max_pending: Optional[int] = None,
                 backpressure: str = "block",
                 prefilter: Optional[float] = None,
                 prefilter_engine: str = "myers",
                 warm_start: Optional[Sequence] = None,
                 fault_plan: Optional[FaultPlan] = None,
                 max_retries: Optional[int] = 3,
                 retry_backoff_s: float = 0.0,
                 deadline_s: Optional[float] = None,
                 harvest_timeout_s: Optional[float] = None,
                 degrade: Optional[str] = None,
                 degrade_watermark: Optional[int] = None,
                 device="cuda"):
        if mesh is not None:
            raise ValueError(
                "mesh= (sharded channels) is not ported: multi-GPU "
                "placement is ROADMAP queue 1 item 14; the service runs on "
                "one device (device=)")
        Gateway.__init__(
            self, pipeline_depth=pipeline_depth, max_pending=max_pending,
            backpressure=backpressure, redispatch_after=redispatch_after,
            fault_plan=fault_plan, max_retries=max_retries,
            retry_backoff_s=retry_backoff_s, deadline_s=deadline_s,
            harvest_timeout_s=harvest_timeout_s,
            degrade_watermark=degrade_watermark)
        self.device = plan_mod.resolve_device(device)
        self.max_len, self.block = max_len, block
        self.tb_budget_bytes = tb_budget_bytes
        self.max_block = max_block
        self.min_bucket = min(min_bucket, max_len)
        # largest admissible bucket: max_len snapped *up* to the grid, so
        # every request <= max_len has an on-grid bucket
        self.max_bucket = bucketing.bucket_length(
            max_len, min_bucket=self.min_bucket)
        self.coalesce = coalesce
        self.engine_name = engine_name
        self.with_traceback = with_traceback
        # filter ladder (opt-in): ``prefilter=frac`` screens every batch
        # with the thresholded bit-parallel edit_search before the main
        # plan — requests whose best edit distance exceeds
        # ceil(frac * query_len) resolve immediately with
        # ``{'filtered': True}`` and never pay full DP.  Only uint8
        # scalar-code channels are screened; None = no behavior change.
        if prefilter is not None and not 0.0 < prefilter < 1.0:
            raise ValueError(
                f"prefilter must be a fraction in (0, 1), got {prefilter}")
        self.prefilter = prefilter
        self.prefilter_engine = prefilter_engine
        if degrade not in (None, "myers"):
            raise ValueError(
                f"degrade must be None or 'myers', got {degrade!r}")
        self.degrade = degrade
        self.channels: Dict[str, tuple] = {}   # kernel -> (spec, params)
        # warm boot: dispatch the declared channel grid once, so the first
        # request at each (kernel, bucket) lands on a hot plan
        if warm_start:
            self.warm(warm_start)

    def warm(self, entries: Sequence) -> int:
        """Dispatch once, at boot, the plans for ``(kernel, bucket)`` (or
        ``(kernel, bucket, block)``) channel entries; ``bucket`` may be one
        length (square) or a ``(q, r)`` pair, snapped to the service's
        bucket grid exactly as a request of those lengths would be.

        Each entry warms the plan a launch would resolve — identical
        ``get_plan`` arguments — plus, on screenable channels, the
        prefilter's score-only screen plan.  Returns the number of plans
        warmed.
        """
        from repro_torch.tune import warm as warm_mod

        n = 0
        for entry in entries:
            kernel, bucket = entry[0], entry[1]
            block = entry[2] if len(entry) > 2 else None
            if isinstance(bucket, int):
                bucket = (bucket, bucket)
            bucket = bucketing.bucket_shape(
                bucket[0], bucket[1], min_bucket=self.min_bucket,
                max_bucket=self.max_bucket)
            spec, params = self._channel(kernel)
            if block is None:
                block = self.block_for(kernel, bucket)
            char = spec.char_shape
            q_shape, r_shape = (bucket[0],) + char, (bucket[1],) + char
            if self._screenable(spec):
                warm_mod.warm_plan(
                    _PREFILTER_SPEC, edit_kernel.default_params(1),
                    self.prefilter_engine, q_shape, r_shape,
                    batch_size=block, with_traceback=False, mode="fill",
                    device=self.device)
                n += 1
            warm_mod.warm_plan(
                spec, params, self.engine_name, q_shape, r_shape,
                batch_size=block,
                with_traceback=self.with_traceback and
                spec.traceback is not None, device=self.device)
            n += 1
        return n

    def _bucket(self, req: AlignRequest) -> Tuple[int, int]:
        return bucketing.bucket_shape(
            len(req.query), len(req.ref),
            min_bucket=self.min_bucket, max_bucket=self.max_bucket)

    def block_for(self, kernel: str, bucket: Tuple[int, int]) -> int:
        """Batch rows one launch carries at this (kernel, bucket) channel.

        Without a budget this is the fixed ``block``.  With
        ``tb_budget_bytes`` it is how many alignments' traceback stores
        fit the budget (floored at ``block``, capped at ``max_block``) —
        a 4x-packed kernel gets 4x the in-flight alignments per bucket.
        """
        if self.tb_budget_bytes is None:
            return self.block
        spec, _ = self._channel(kernel)
        per = plan_mod.traceback_bytes(spec, bucket[0], bucket[1],
                                       engine_name=self.engine_name)
        if per == 0:                      # score-only kernel: no tb store
            return self.max_block
        return max(self.block, min(self.max_block,
                                   self.tb_budget_bytes // per))

    def _channel(self, kernel: str):
        """Per-kernel spec and params (the params on the service's
        device)."""
        if kernel not in self.channels:
            with self._lock:
                if kernel not in self.channels:
                    spec, params = kernels_zoo.make(kernel)
                    self.channels[kernel] = (
                        spec, params_on_device(params, self.device))
        return self.channels[kernel]

    def _resolve_channel(self, name: str) -> _AlignChannel:
        ch = self._gw_channels.get(name)
        if ch is None:
            with self._lock:
                ch = self._gw_channels.get(name)
                if ch is None:
                    ch = self.register_channel(_AlignChannel(self, name))
        return ch

    # -- intake ------------------------------------------------------------
    def submit(self, req: AlignRequest) -> AlignFuture:
        if len(req.query) > self.max_len or len(req.ref) > self.max_len:
            raise ValueError(
                f"request {req.rid}: lengths ({len(req.query)}, "
                f"{len(req.ref)}) exceed max_len {self.max_len}")
        if not self._admit(req.rid):
            self._count_submitted(req)
            with self._lock:     # shed: resolve newest with a typed error
                self._dead_letter(
                    self._resolve_channel(req.kernel), req,
                    ShedOverload(
                        f"request {req.rid}: {self._pending} requests "
                        f"pending >= max_pending {self.max_pending}"),
                    free_pending=False, worker="submit")
            return AlignFuture(req, self)
        self._count_submitted(req)
        self._stamp_deadline(req)
        with self._lock:
            self._pending += 1
            self._push(self._resolve_channel(req.kernel), req)
        return AlignFuture(req, self)

    # -- batch formation ---------------------------------------------------
    def _pad_batch(self, reqs: List[AlignRequest], bucket: Tuple[int, int],
                   spec, n: int):
        """``(qs, rs, ql, rl)``: the requests padded to the bucket in ``n``
        rows of host memory (pinned when the device is a GPU), the rows
        past the requests length-1 dummies that no request reads back."""
        Lq, Lr = bucket
        char = spec.char_shape
        pin = self.device.type == "cuda"
        qs = torch.zeros((n, Lq) + char, dtype=spec.char_dtype,
                         pin_memory=pin)
        rs = torch.zeros((n, Lr) + char, dtype=spec.char_dtype,
                         pin_memory=pin)
        q_np, r_np = qs.numpy(), rs.numpy()
        ql = np.ones((n,), np.int32)
        rl = np.ones((n,), np.int32)
        for i, r in enumerate(reqs):
            ql[i] = len(r.query)
            rl[i] = len(r.ref)
            q_np[i, : ql[i]] = r.query
            r_np[i, : rl[i]] = r.ref
        return qs, rs, ql, rl

    def _to_device(self, qs, rs):
        """One host-to-device copy of a padded batch (asynchronous from
        pinned memory)."""
        return (qs.to(self.device, non_blocking=True),
                rs.to(self.device, non_blocking=True))

    def _coalesce_batch(self, kernel: str, bucket: Tuple[int, int],
                        reqs: List[AlignRequest], block: int) -> Tuple[int, int]:
        """Top a partial batch up with requests from dominating buckets.

        A bucket ``b2`` dominates when both sides are >= ``bucket`` — its
        requests fit after padding to ``b2``, so the combined batch
        dispatches at the elementwise-max bucket.  Closest (smallest
        dominating) buckets are drained first to keep padding waste low.
        Under a memory budget the row cap is re-evaluated at each grown
        bucket (``block_for``), so coalescing into a bigger bucket can
        never launch a batch whose traceback store exceeds the budget.
        """
        out_bucket = bucket
        donors = sorted(
            (b2 for (k2, b2) in self.queues
             if k2 == kernel and b2 != bucket
             and b2[0] >= bucket[0] and b2[1] >= bucket[1]
             and self.queues[(k2, b2)]),
            key=lambda b2: b2[0] * b2[1])
        for b2 in donors:
            grown = (max(out_bucket[0], b2[0]), max(out_bucket[1], b2[1]))
            allowed = min(block, self.block_for(kernel, grown))
            if len(reqs) >= allowed:
                break                 # growing further would bust the cap
            queue = self.queues[(kernel, b2)]
            while queue and len(reqs) < allowed:
                reqs.append(queue.pop(0))
                out_bucket = grown
            if len(reqs) >= allowed:
                break
        return out_bucket

    # -- the prefilter rung ------------------------------------------------
    def _screenable(self, spec) -> bool:
        """The edit screen only reads uint8 scalar symbol codes; channels
        with per-position channels (profiles, DTW floats) pass through."""
        return (self.prefilter is not None and spec.char_shape == ()
                and spec.char_dtype == torch.uint8)

    def _prefilter_batch(self, spec, reqs, bucket, batch, block):
        """Screen one padded batch with thresholded bit-parallel
        edit_search (K2); rejects resolve immediately with ``filtered:
        True`` and the channel-sentinel score.  One engine-side threshold
        (the batch max) keeps a single screen plan per bucket; the exact
        per-request cut ``ceil(prefilter * query_len)`` applies host-side.
        The host waits for the screen's distances (the screen is cheap).
        """
        qs, rs, ql, rl = batch
        ks = [int(np.ceil(self.prefilter * len(r.query))) for r in reqs]
        params = edit_kernel.default_params(max(ks))
        screen = plan_mod.get_plan(
            _PREFILTER_SPEC, self.prefilter_engine,
            tuple(qs.shape[1:]), tuple(rs.shape[1:]), batch_size=block,
            with_traceback=False, mode="fill", device=self.device)
        out = screen(params, *self._to_device(qs, rs), ql, rl)
        dist = out.score.cpu().numpy()[: len(reqs)]
        sent = float(spec.sentinel())
        survivors = []
        for r, d, k in zip(reqs, dist, ks):
            if float(d) <= k:
                survivors.append(r)
            else:
                r.result = {"score": sent, "end": (0, 0), "filtered": True}
                self._job_resolved(r, 1, "filtered")
        if len(survivors) != len(reqs):
            batch = self._pad_batch(survivors, bucket, spec, block)
        return survivors, batch
