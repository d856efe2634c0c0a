"""Read-mapping as a service (counterpart of
``repro.serve.mapping_service``): the ``map_reads`` channel next to align.

Where ``AlignmentService`` serves pre-paired (query, ref) requests, this
channel serves *reads only*: a ``ReadMapper`` owns the reference index and
every drained batch runs the full seed-chain-extend pipeline, whose screen
(K2) and extension (K1) stages land on the same shared plan cache as the
align channels.  ``drain`` hands the whole queue (up to ``max_batch``) to
one ``map_reads`` call instead of chopping it into tiny chunks, so the
extension stage sees enough bucketed blocks to keep the device busy.
Results attach to the submitted request objects (same contract as
``AlignRequest``), so callers keep their own ordering.

The queue lives on the shared :class:`repro_torch.serve.gateway.Gateway`
as a single FIFO channel (``map_reads`` is order-preserving: a failing
batch goes back to the *front* of the queue in its original order), which
buys the gateway's fault-tolerance contract — bounded retries, dead
letters, deadlines, fault injection, multi-worker ``serve()`` — for free.
``map_reads`` itself is synchronous, so the channel pins
``pipeline_depth=1``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from repro_torch.mapping import ReadMapper

from . import gateway as gateway_mod
from .gateway import FaultPlan, Gateway, ShedOverload

__all__ = ["MapRequest", "ReadMappingService"]


@dataclasses.dataclass(eq=False)   # identity semantics: ndarray field
class MapRequest:
    rid: int
    read: np.ndarray                 # uint8 DNA codes, as sequenced
    result: Optional[dict] = None    # {flag,pos,mapq,cigar,score,...}
    gen: int = 0                     # bumped on every re-dispatch
    waits: int = 0                   # batch pops passed over (FIFO: unused)
    attempts: int = 0                # failed dispatches
    not_before: float = 0.0          # retry backoff gate
    deadline: Optional[float] = None


class _MapReadsChannel(gateway_mod.Channel):
    """One FIFO pseudo-bucket over the whole read queue."""

    name = "map_reads"
    requeue_front = True             # keep submission order on requeue

    def __init__(self, svc: "ReadMappingService"):
        self.svc = svc

    def queue_key(self, bucket):
        return "reads"

    def bucket_of(self, job: MapRequest):
        return (1, 1)                # single pseudo-bucket: FIFO channel

    def block_for(self, bucket) -> int:
        svc = self.svc
        if svc.max_batch is None:
            return max(1, len(svc.queue))
        return svc.max_batch

    def launch(self, bucket, reqs, block):
        # map_reads is synchronous (seed-chain-extend incl. host post-
        # processing); the gateway runs this channel at depth 1
        records = self.svc.mapper.map_reads(
            [r.read for r in reqs],
            names=[f"r{r.rid}" for r in reqs])
        return reqs, records

    def land(self, job: MapRequest, i: int, records) -> int:
        rec = records[i]
        job.result = {
            "flag": rec.flag, "pos": rec.pos, "mapq": rec.mapq,
            "cigar": rec.cigar, "score": rec.score,
            "chain_score": rec.chain_score,
            "mapped": rec.is_mapped, "sam": rec.to_line(),
        }
        return 1

    def record(self, bucket, n, coalesced):
        return {"n": n}


class ReadMappingService(Gateway):
    """The map_reads channel on the unified gateway.

    ``block`` is the mapper's internal batch row count and ``device`` its
    device (both ignored when an explicit ``mapper`` is passed);
    ``max_batch`` caps how many queued reads one ``drain`` step hands to
    the mapper (``None`` = the whole queue).  ``mapper_kw`` goes to the
    ``ReadMapper``.
    """

    def __init__(self, ref, block: int = 16,
                 mapper: Optional[ReadMapper] = None,
                 max_batch: Optional[int] = 256,
                 warm_start: Optional[List] = None,
                 max_pending: Optional[int] = None,
                 backpressure: str = "block",
                 redispatch_after: float = 60.0,
                 fault_plan: Optional[FaultPlan] = None,
                 max_retries: Optional[int] = 3,
                 retry_backoff_s: float = 0.0,
                 deadline_s: Optional[float] = None, device="cuda",
                 **mapper_kw):
        Gateway.__init__(
            self, pipeline_depth=1, max_pending=max_pending,
            backpressure=backpressure, redispatch_after=redispatch_after,
            fault_plan=fault_plan, max_retries=max_retries,
            retry_backoff_s=retry_backoff_s, deadline_s=deadline_s)
        self.mapper = mapper if mapper is not None else ReadMapper(
            ref, block=block, device=device, **mapper_kw)
        self.max_batch = max_batch
        self._ch = self.register_channel(_MapReadsChannel(self))
        self._qkey = self._register_key(self._ch, (1, 1))
        if warm_start:
            self.warm(warm_start)

    @property
    def queue(self) -> List[MapRequest]:
        """The FIFO intake queue (a view onto the gateway queue)."""
        return self.queues[self._qkey]

    def warm(self, entries: List) -> int:
        """Dispatch once, at boot, the extension plans for
        ``(read_bucket, window_bucket, band)`` entries — the (spec, bucket)
        grid the mapper's extension stage will hit, resolved through
        ``extension_spec`` so the warmed spec object is the one
        ``extend_jobs`` dispatches — plus, when the filter ladder is on,
        the bit-parallel screen plan at the same bucket.  Buckets snap to
        the power-of-two grid as ``run_pairs`` would snap them.  Returns
        #plans warmed."""
        from repro_torch.core.kernels_zoo import edit as edit_kernel
        from repro_torch.mapping import extend as extend_mod
        from repro_torch.runtime import bucketing
        from repro_torch.tune import warm as warm_mod

        m = self.mapper
        n = 0
        for qb, rb, band in entries:
            bucket = bucketing.bucket_shape(qb, rb)
            spec, params = extend_mod.extension_spec(band, m.gap_mode)
            warm_mod.warm_plan(
                spec, params, m.engine_name, (bucket[0],), (bucket[1],),
                batch_size=m.block, with_traceback=True, device=m.device)
            n += 1
            if m.filter_mode == "myers":
                warm_mod.warm_plan(
                    extend_mod.SCREEN_SPEC, edit_kernel.default_params(1),
                    m.filter_engine, (bucket[0],), (bucket[1],),
                    batch_size=m.screen_block, with_traceback=False,
                    device=m.device)
                n += 1
        return n

    def submit(self, req: MapRequest) -> None:
        if not self._admit(req.rid):
            self._count_submitted(req)
            with self._lock:     # shed: resolve newest with a typed error
                self._dead_letter(
                    self._ch, req,
                    ShedOverload(
                        f"request {req.rid}: {self._pending} requests "
                        f"pending >= max_pending {self.max_pending}"),
                    free_pending=False, worker="submit")
            return
        self._count_submitted(req)
        self._stamp_deadline(req)
        with self._lock:
            self._pending += 1
            self.queues[self._qkey].append(req)
