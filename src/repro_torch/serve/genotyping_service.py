"""Genotyping as a service (counterpart of
``repro.serve.genotyping_service``): the pair-HMM forward channel next to
align.

Where ``AlignmentService`` serves (query, ref) pairs one result each, a
genotype request is a *site*: N reads x H candidate haplotypes whose N*H
forward likelihoods are the evidence for one genotype call.  The service
flattens every submitted site into pair jobs, queues them per length bucket
(one score-only logsumexp plan per bucket, shared service-wide; on the card
K1's logsumexp instantiation), and drives launch/harvest through the shared
:class:`repro_torch.serve.gateway.Gateway` dispatcher: host padding of
batch N+1 overlaps the device computing batch N, and the gateway's
fault-tolerance contract (heartbeat redispatch, generation counters,
bounded retries, deadlines, dead letters, multi-worker ``serve()``) comes
with it.  A site's call (``repro_torch.prob.genotype.call_genotype``) lands
the moment its last pair harvests (sites therefore complete out of
submission order under mixed lengths — the future, not the queue, carries
the ordering contract); a site that exhausts its retries or deadline
resolves with one typed error result and its remaining pair jobs are
dropped from the queues.

Backpressure mirrors ``AlignmentService``: ``max_pending`` bounds
incomplete *sites*, ``backpressure='block'`` makes ``submit`` work batches
synchronously until there is room, ``'raise'`` sheds with
``ServiceOverloaded``, ``'shed'`` resolves the newest site with a typed
``shed`` error result.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.spec_utils import params_on_device
from repro_torch.prob import genotype as genotype_mod
from repro_torch.prob import kernels as prob_kernels
from repro_torch.runtime import bucketing
from repro_torch.runtime import plan as plan_mod

from . import gateway as gateway_mod
from .gateway import FaultPlan, Gateway, ShedOverload, error_result

__all__ = ["GenotypeRequest", "GenotypeFuture", "GenotypingService"]


@dataclasses.dataclass(eq=False)   # identity semantics: ndarray fields
class GenotypeRequest:
    """One site: reads + candidate haplotypes -> a genotype call."""
    rid: int
    reads: List[np.ndarray]
    haplotypes: List[np.ndarray]
    ploidy: int = 2
    result: Optional[dict] = None    # genotype.call_genotype dict + "ll"
    deadline: Optional[float] = None


@dataclasses.dataclass(eq=False)
class _PairJob:
    """One (read, haplotype) cell of a site's likelihood matrix."""
    req: GenotypeRequest
    read_idx: int
    hap_idx: int
    query: np.ndarray
    ref: np.ndarray
    waits: int = 0                   # batch pops this job was passed over
    gen: int = 0                     # bumped on every re-dispatch
    attempts: int = 0                # failed dispatches
    not_before: float = 0.0          # retry backoff gate


class GenotypeFuture:
    """Handle returned by ``submit``; ``result()`` pumps the service's
    dispatcher until this site's call lands (same single-process contract
    as ``AlignFuture``)."""

    __slots__ = ("req", "_svc")

    def __init__(self, req: GenotypeRequest, svc: "GenotypingService"):
        self.req = req
        self._svc = svc

    def done(self) -> bool:
        return self.req.result is not None

    def result(self) -> dict:
        if not self.done():
            self._svc.wait([self])
        if self.req.result is None:
            raise RuntimeError(f"site {self.req.rid} did not complete")
        return self.req.result

    def __repr__(self):
        state = "done" if self.done() else "pending"
        return f"GenotypeFuture(rid={self.req.rid}, {state})"


class _PairHMMChannel(gateway_mod.Channel):
    """The single forward-likelihood channel; queue keys are bare bucket
    tuples and the *site*, not the pair job, is the pending/dead-letter
    unit."""

    name = "pairhmm"

    def __init__(self, svc: "GenotypingService"):
        self.svc = svc

    def queue_key(self, bucket):
        return bucket

    def bucket_of(self, job: _PairJob) -> Tuple[int, int]:
        svc = self.svc
        return bucketing.bucket_shape(
            len(job.query), len(job.ref),
            min_bucket=svc.min_bucket, max_bucket=svc.max_bucket)

    def job_len(self, job: _PairJob) -> int:
        return len(job.query) + len(job.ref)

    def job_rid(self, job: _PairJob):
        return job.req.rid

    def job_done(self, job: _PairJob) -> bool:
        # a pair cell is done when its likelihood landed; the whole job is
        # moot once the site carries a result (called, or dead-lettered:
        # remaining cells must not occupy batch slots)
        return (job.req.result is not None
                or not np.isnan(job.req._ll[job.read_idx, job.hap_idx]))

    def deadline_of(self, job: _PairJob) -> Optional[float]:
        return job.req.deadline

    def block_for(self, bucket) -> int:
        return self.svc.block

    def launch(self, bucket, jobs, block):
        svc = self.svc
        Lq, Lr = bucket
        pin = svc.device.type == "cuda"
        qs = torch.zeros((block, Lq), dtype=torch.uint8, pin_memory=pin)
        rs = torch.zeros((block, Lr), dtype=torch.uint8, pin_memory=pin)
        q_np, r_np = qs.numpy(), rs.numpy()
        ql = np.ones((block,), np.int32)
        rl = np.ones((block,), np.int32)
        for i, job in enumerate(jobs):
            ql[i], rl[i] = len(job.query), len(job.ref)
            q_np[i, : ql[i]] = job.query
            r_np[i, : rl[i]] = job.ref
        plan = plan_mod.get_plan(svc.spec, svc.engine_name,
                                 (Lq,), (Lr,), batch_size=block,
                                 with_traceback=False, device=svc.device)
        out = plan(svc.params, qs.to(svc.device, non_blocking=True),
                   rs.to(svc.device, non_blocking=True), ql, rl)
        return jobs, out

    def materialize(self, out):
        return out.score.cpu().numpy()             # sync point

    def land(self, job: _PairJob, i: int, scores) -> int:
        """Write one likelihood cell; call the site when its matrix just
        filled.  Returns 1 only on site completion (the pending unit is the
        site)."""
        svc = self.svc
        req = job.req
        ll = float(scores[i])
        if svc.hap_norm:
            ll -= float(np.log(len(job.ref)))
        req._ll[job.read_idx, job.hap_idx] = ll
        req._left -= 1
        if req._left == 0 and req.result is None:
            req.result = genotype_mod.call_genotype(req._ll, req.ploidy)
            req.result["ll"] = req._ll
            return 1
        return 0

    def fail(self, job: _PairJob, exc: BaseException) -> int:
        """A pair job's terminal failure fails its whole site (one typed
        result); sibling cells already queued are dropped at the next batch
        formation via ``job_done``."""
        req = job.req
        if req.result is not None:
            return 0
        req.result = error_result(exc)
        return 1

    def record(self, bucket, n, coalesced):
        return {"bucket": bucket, "n": n}


class GenotypingService(Gateway):
    """The genotyping channel on the unified gateway, on one device.

    ``device`` is where the plans run (the card unless ``"cpu"``);
    ``max_len`` caps read and haplotype lengths (snapped up to the bucket
    grid like the align channels); ``block`` is the pair-batch row count;
    ``pipeline_depth`` how many blocks may be in flight.  ``hap_norm``
    applies the per-haplotype ``-log(len)`` free-start normalization (see
    ``prob.genotype``).  Fault tolerance (``fault_plan``, ``max_retries``,
    ``retry_backoff_s``, ``deadline_s``, ``harvest_timeout_s``) and the
    multi-worker ``serve()`` pool come from
    :class:`~repro_torch.serve.gateway.Gateway`.
    """

    _unit = ("site", "sites")

    def __init__(self, max_len: int = 512, block: int = 8,
                 engine_name: str = "wavefront", params=None,
                 pipeline_depth: int = 2,
                 min_bucket: int = bucketing.DEFAULT_MIN_BUCKET,
                 hap_norm: bool = True,
                 max_pending: Optional[int] = None,
                 backpressure: str = "block",
                 warm_start: Optional[Sequence[Tuple[int, int]]] = None,
                 redispatch_after: float = 60.0,
                 fault_plan: Optional[FaultPlan] = None,
                 max_retries: Optional[int] = 3,
                 retry_backoff_s: float = 0.0,
                 deadline_s: Optional[float] = None,
                 harvest_timeout_s: Optional[float] = None,
                 device="cuda"):
        Gateway.__init__(
            self, pipeline_depth=pipeline_depth, max_pending=max_pending,
            backpressure=backpressure, redispatch_after=redispatch_after,
            fault_plan=fault_plan, max_retries=max_retries,
            retry_backoff_s=retry_backoff_s, deadline_s=deadline_s,
            harvest_timeout_s=harvest_timeout_s)
        self.device = plan_mod.resolve_device(device)
        self.max_len = max_len
        self.block = block
        self.engine_name = engine_name
        self.min_bucket = min(min_bucket, max_len)
        self.max_bucket = bucketing.bucket_length(
            max_len, min_bucket=self.min_bucket)
        self.hap_norm = hap_norm
        self.spec = prob_kernels.cached_pairhmm()
        self.params = params_on_device(
            prob_kernels.default_params() if params is None else params,
            self.device)
        self._ch = self.register_channel(_PairHMMChannel(self))
        if warm_start:
            self.warm(warm_start)

    def warm(self, entries: Sequence[Tuple[int, int]]) -> int:
        """Dispatch once, at boot, the forward plan for each
        ``(read_bucket, hap_bucket)`` pair (snapped to the service's bucket
        grid) with exactly the launch's arguments, so the first site at
        each shape lands on a hot plan.  Returns #plans warmed."""
        from repro_torch.tune import warm as warm_mod

        for rb, hb in entries:
            bucket = bucketing.bucket_shape(
                rb, hb, min_bucket=self.min_bucket,
                max_bucket=self.max_bucket)
            warm_mod.warm_plan(
                self.spec, self.params, self.engine_name, (bucket[0],),
                (bucket[1],), batch_size=self.block,
                with_traceback=False, device=self.device)
        return len(entries)

    # -- intake ------------------------------------------------------------
    def submit(self, req: GenotypeRequest) -> GenotypeFuture:
        reads = [np.asarray(r, np.uint8) for r in req.reads]
        haps = [np.asarray(h, np.uint8) for h in req.haplotypes]
        if not reads or len(haps) < 1:
            raise ValueError(f"site {req.rid}: needs >= 1 read and haplotype")
        if req.ploidy < 1:
            raise ValueError(f"site {req.rid}: ploidy must be >= 1, "
                             f"got {req.ploidy}")
        for arr, kind in ((reads, "read"), (haps, "haplotype")):
            for a in arr:
                if not 1 <= len(a) <= self.max_len:
                    raise ValueError(
                        f"site {req.rid}: {kind} length {len(a)} outside "
                        f"[1, {self.max_len}]")
        if not self._admit(req.rid):
            self._count_submitted(req)
            with self._lock:     # shed: resolve newest with a typed error
                exc = ShedOverload(
                    f"site {req.rid}: {self._pending} sites pending >= "
                    f"max_pending {self.max_pending}")
                req.result = error_result(exc)
                self._record_dead_letter(self._ch.name, req.rid, exc,
                                         worker="submit")
            return GenotypeFuture(req, self)
        self._count_submitted(req)
        req.reads, req.haplotypes = reads, haps
        req._ll = np.full((len(reads), len(haps)), np.nan)   # type: ignore
        req._left = len(reads) * len(haps)                   # type: ignore
        self._stamp_deadline(req)
        with self._lock:
            self._pending += 1
            for ri, read in enumerate(reads):
                for hi, hap in enumerate(haps):
                    self._push(self._ch, _PairJob(
                        req=req, read_idx=ri, hap_idx=hi,
                        query=read, ref=hap))
        return GenotypeFuture(req, self)
