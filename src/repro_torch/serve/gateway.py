"""The unified serving gateway: one dispatcher core, N workers, any channel
(copy of ``repro.serve.gateway``, over the port's runtime, heartbeat and
``obs``).

DP-HLS deploys its kernels as an always-on accelerator service (AWS F1
hosts serving alignment traffic), and ASAP frames alignment as a
latency-bound service where tail behavior — stragglers, dead workers,
overload — *is* the product.  This module is that host-side story for
the port's runtime: the queue/admission/batch-formation/launch/
harvest machinery that ``AlignmentService``, ``GenotypingService`` and
``ReadMappingService`` used to near-copy now lives here once, behind a
small :class:`Channel` adapter (how to bucket a job, pad a block, land a
row), and the three services are thin channel definitions on top.

The robustness contract layered over the shared core:

* **Multi-worker dispatch** — :meth:`Gateway.serve` drives the queues
  with a pool of dispatcher threads, each running the same pipelined
  launch/harvest loop (``runtime.dispatch.run_pipelined``) the inline
  ``wait``/``drain`` path uses, beating the shared
  :class:`~repro_torch.ft.HeartbeatMonitor` at every launch and harvest.  A
  supervisor loop reclaims batches whose worker went quiet
  (``redispatch_dead``), times out overdue harvests, sweeps expired
  deadlines, and — with ``elastic=True`` — respawns dead workers.
* **Deterministic fault injection** — a :class:`FaultPlan` threaded
  through launch/harvest kills worker *k* at its *b*-th dispatch, fails
  launches/harvests with seeded per-(worker, seq) probabilities, and
  injects harvest latency; every decision is a pure function of
  ``(seed, worker, seq, site)`` so chaos runs are reproducible.
* **Launch and harvest on the card** — a channel's ``launch`` enqueues
  its kernels (K1, K2) on the current CUDA stream through ctypes, which
  releases the GIL, so worker threads overlap; ``materialize`` is the
  device-to-host copy where a worker waits.  The kernel libraries load
  once per process under a per-library lock (``kernels/build.py``), and
  plan-cache misses from two threads build one plan.
* **Bounded retries + dead letters** — a failing batch requeues its
  unfinished jobs with a bumped generation (late results are discarded:
  no double-completion) and a per-job attempt counter; past
  ``max_retries`` the job resolves with a typed error dict instead of
  retrying forever, and the event is recorded in ``dead_letters``.
  ``retry_backoff_s`` adds exponential backoff between attempts.
* **Deadlines** — ``deadline_s`` stamps every admitted request;
  expired jobs dead-letter with :class:`DeadlineExceeded` instead of
  occupying a batch slot.  ``harvest_timeout_s`` bounds how long a
  launched batch may sit un-harvested before it is reclaimed.
* **Graceful degradation** — ``backpressure='shed'`` rejects the
  *newest* request past ``max_pending`` with a typed ``shed`` result
  (the existing ``'block'``/``'raise'`` modes are unchanged), and
  channels that opt in (``can_degrade``) can answer overload with a
  cheap approximate result (the alignment channels degrade to the
  bit-parallel ``myers`` edit-distance screen) once ``_pending``
  crosses ``degrade_watermark``.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
import zlib
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.ft import DEAD, HeartbeatMonitor
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.runtime import dispatch as dispatch_mod


# -- typed failures ---------------------------------------------------------
class GatewayError(RuntimeError):
    """Base of the gateway's typed failures; ``kind`` is the machine-
    readable tag carried by dead-letter records and error results."""
    kind = "error"


class DeadlineExceeded(GatewayError):
    """The request's deadline passed before a result landed."""
    kind = "deadline"


class RetriesExhausted(GatewayError):
    """The job failed more than ``max_retries`` times and was
    dead-lettered instead of requeued."""
    kind = "retries"


class ShedOverload(GatewayError):
    """Admission rejected the request under ``backpressure='shed'``."""
    kind = "shed"


class InjectedFault(GatewayError):
    """A :class:`FaultPlan` made this launch/harvest fail on purpose."""
    kind = "injected"


class WorkerKilled(GatewayError):
    """A :class:`FaultPlan` killed this worker; its thread exits without
    cleanup (in-flight batches are left for heartbeat reclaim)."""
    kind = "killed"


class GatewayTimeout(GatewayError):
    """``serve`` gave up before the workload completed."""
    kind = "timeout"


class ServiceOverloaded(RuntimeError):
    """``submit`` under ``backpressure='raise'``: the in-flight budget
    (``max_pending``) is exhausted — shed the request or retry later."""


def error_result(exc: BaseException) -> dict:
    """The typed result dict a dead-lettered request resolves with, so a
    future's ``result()`` returns instead of hanging: callers branch on
    ``res.get("failed")`` / ``res["error"]["kind"]``."""
    return {"failed": True,
            "error": {"kind": getattr(exc, "kind", "error"),
                      "type": type(exc).__name__,
                      "message": str(exc)}}


# -- deterministic chaos ----------------------------------------------------
@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A reproducible schedule of injected failures.

    Every decision is a pure function of ``(seed, worker, seq, site)``
    where ``seq`` is the worker's launch counter — re-running the same
    workload under the same plan injects the same faults, which is what
    makes the chaos benchmark's bit-identity assertion meaningful.

    ``kill`` maps a worker name to the launch index (or collection of
    indices) at which it dies *silently*: the un-launched batch is
    requeued (it never reached the device), launched batches stay in
    ``inflight`` for heartbeat reclaim, and the worker never beats
    again.  ``fail_launch_p``/``fail_harvest_p`` raise
    :class:`InjectedFault` from the launch/harvest of a batch with the
    given probability; ``latency_s`` sleeps inside harvest with
    probability ``latency_p`` (straggler injection — both knobs must be
    set for latency to fire).
    """
    seed: int = 0
    kill: Dict[str, object] = dataclasses.field(default_factory=dict)
    fail_launch_p: float = 0.0
    fail_harvest_p: float = 0.0
    latency_s: float = 0.0
    latency_p: float = 0.0

    def _draw(self, worker: str, seq: int, site: str) -> float:
        salt = zlib.crc32(f"{worker}/{seq}/{site}".encode())
        return float(np.random.default_rng((self.seed, salt)).random())

    def kills(self, worker: str, seq: int) -> bool:
        at = self.kill.get(worker)
        if at is None:
            return False
        if isinstance(at, (list, tuple, set, frozenset)):
            return seq in at
        return seq == at

    def fails_launch(self, worker: str, seq: int) -> bool:
        return (self.fail_launch_p > 0.0
                and self._draw(worker, seq, "launch") < self.fail_launch_p)

    def fails_harvest(self, worker: str, seq: int) -> bool:
        return (self.fail_harvest_p > 0.0
                and self._draw(worker, seq, "harvest") < self.fail_harvest_p)

    def harvest_latency(self, worker: str, seq: int) -> float:
        if self.latency_s <= 0.0 or self.latency_p <= 0.0:
            return 0.0
        if self._draw(worker, seq, "latency") < self.latency_p:
            return self.latency_s
        return 0.0


# -- the in-flight unit -----------------------------------------------------
@dataclasses.dataclass(eq=False)   # identity semantics: held in lists
class InflightBatch:
    """One launched batch: device output not yet harvested.

    ``gens`` snapshots each job's generation at launch; harvest only
    writes results for jobs still on that generation (a re-dispatch
    bumps ``job.gen``, so the stale original is discarded).  ``seq`` is
    the launching worker's dispatch counter (the FaultPlan coordinate);
    ``launched_at`` feeds the per-batch harvest timeout.
    """
    worker: str
    kernel: str                      # channel name (kernel for align)
    bucket: Tuple[int, int]
    reqs: List
    gens: List[int]
    out: object                      # device tensors (async), None in tests
    cancelled: bool = False
    seq: int = -1
    launched_at: Optional[float] = None


# -- the channel adapter ----------------------------------------------------
class Channel:
    """What a workload must define to be served by the gateway.

    A *job* is whatever the channel queues (an ``AlignRequest``, a
    genotyping pair cell, a read); the gateway only requires that it
    carry ``gen``/``attempts``/``waits``/``not_before`` counters.  A
    *unit* is what ``max_pending`` counts — one per job for alignment
    and mapping, one per *site* for genotyping (``land`` returns the
    units completed by a row, ``fail`` the units freed by a failure).
    """

    name: str = "channel"
    requeue_front = False     # preserve FIFO order on requeue (mapping)
    can_degrade = False       # overload may answer via launch_degraded

    # -- queue geometry
    def queue_key(self, bucket):
        return (self.name, bucket)

    def bucket_of(self, job) -> Tuple[int, int]:
        raise NotImplementedError

    def job_len(self, job) -> int:
        """Sort key for longest-first block formation (0 = keep FIFO)."""
        return 0

    def job_rid(self, job):
        return getattr(job, "rid", None)

    def job_done(self, job) -> bool:
        return job.result is not None

    def deadline_of(self, job) -> Optional[float]:
        return getattr(job, "deadline", None)

    def block_for(self, bucket) -> int:
        raise NotImplementedError

    def coalesce(self, bucket, jobs, block):
        """Optionally top a partial batch up from other queues; returns
        ``(bucket, block, coalesced)``."""
        return bucket, block, False

    # -- the two pipeline stages
    def launch(self, bucket, jobs, block):
        """Enqueue device work; returns ``(surviving_jobs, out)``.
        ``out=None`` means every job resolved during launch (e.g. the
        prefilter rejected the whole batch) — the batch is recorded but
        harvest is a no-op.  Must not block on device results."""
        raise NotImplementedError

    def materialize(self, out):
        """Device->host sync for one batch (called outside the gateway
        lock); whatever it returns is handed to ``land`` per row."""
        return out

    def land(self, job, row: int, host) -> int:
        """Write one row's result into its job; returns completed units."""
        raise NotImplementedError

    def fail(self, job, exc: BaseException) -> int:
        """Resolve a job with a typed error; returns freed units (0 when
        the job's request already carries a result)."""
        if job.result is not None:
            return 0
        job.result = error_result(exc)
        return 1

    def launch_degraded(self, bucket, jobs, block) -> None:
        """Answer every job with a cheap approximate result (overload
        path; only called when ``can_degrade``).  Must resolve the jobs
        itself via ``gateway._job_resolved``."""
        raise NotImplementedError

    def record(self, bucket, n: int, coalesced: bool) -> dict:
        """The telemetry dict appended to ``gateway.dispatches``."""
        return {"channel": self.name, "bucket": bucket, "n": n}


# -- the gateway ------------------------------------------------------------
class Gateway:
    """Generic multi-worker pair-job dispatcher over per-bucket queues.

    Services subclass this and register :class:`Channel` adapters; the
    gateway owns admission (``max_pending`` + ``backpressure``
    block/raise/shed), longest-first block formation with the
    anti-starvation ``STALE_AFTER`` guard, pipelined launch/harvest
    (inline via ``wait``/``drain``, concurrent via ``serve``), heartbeat
    bookkeeping, generation counters, bounded retries, deadlines, fault
    injection and the dead-letter queue.  All shared state — queues,
    ``inflight``, ``_pending``, ``dispatches``, ``stats`` — is guarded
    by one re-entrant lock that is *released* around device work
    (padding, launch, the harvest sync), so N dispatcher threads overlap
    host staging with device compute exactly like the single-worker
    pipeline overlapped batches.
    """

    # batch pops a job may be passed over (by longest-first block
    # formation) before it jumps to the front of its queue
    STALE_AFTER = 4

    # admission nouns for backpressure messages ("request" / "site")
    _unit = ("request", "requests")

    def __init__(self, *, pipeline_depth: int = 2,
                 max_pending: Optional[int] = None,
                 backpressure: str = "block",
                 redispatch_after: float = 60.0,
                 monitor: Optional[HeartbeatMonitor] = None,
                 fault_plan: Optional[FaultPlan] = None,
                 max_retries: Optional[int] = 3,
                 retry_backoff_s: float = 0.0,
                 deadline_s: Optional[float] = None,
                 harvest_timeout_s: Optional[float] = None,
                 degrade_watermark: Optional[int] = None,
                 clock=time.monotonic):
        if backpressure not in ("block", "raise", "shed"):
            raise ValueError(
                f"backpressure must be 'block', 'raise' or 'shed', "
                f"got {backpressure!r}")
        if max_pending is not None and max_pending < 1:
            raise ValueError(f"max_pending must be >= 1, got {max_pending}")
        if max_retries is not None and max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {max_retries}")
        if retry_backoff_s < 0.0:
            raise ValueError(
                f"retry_backoff_s must be >= 0, got {retry_backoff_s}")
        self.pipeline_depth = pipeline_depth
        self.max_pending = max_pending
        self.backpressure = backpressure
        self.fault_plan = fault_plan
        self.max_retries = max_retries
        self.retry_backoff_s = retry_backoff_s
        self.deadline_s = deadline_s
        self.harvest_timeout_s = harvest_timeout_s
        self.degrade_watermark = degrade_watermark
        self.monitor = monitor if monitor is not None else \
            HeartbeatMonitor(dead_after=redispatch_after)
        self.queues: Dict[object, List] = {}
        self.inflight: Dict[str, List[InflightBatch]] = {}
        # per-batch shape telemetry, bounded so a long-lived service
        # doesn't accumulate host memory
        self.dispatches = collections.deque(maxlen=4096)
        self.dead_letters: List[dict] = []
        self.stats: Dict[str, object] = {
            "submitted": 0, "completed": 0, "retries": 0,
            "dead_lettered": 0, "redispatched": 0, "timed_out": 0,
            "shed": 0, "degraded": 0, "filtered": 0, "faults": 0,
            "worker_errors": 0, "killed": [], "respawned": [],
        }
        self._pending = 0
        self._metrics = obs_metrics.MetricsRegistry()
        self._clock = clock
        self._lock = threading.RLock()
        self._qinfo: Dict[object, tuple] = {}    # key -> (channel, bucket)
        self._qorder: Dict[object, tuple] = {}   # key -> stable sort key
        self._gw_channels: Dict[str, Channel] = {}
        self._seq: Dict[str, int] = {}           # per-worker launch counter
        self._killed: set = set()                # FaultPlan-killed workers

    # -- channel / queue registry -------------------------------------------
    def register_channel(self, ch: Channel) -> Channel:
        with self._lock:
            self._gw_channels[ch.name] = ch
        return ch

    def _resolve_channel(self, name: str) -> Channel:
        ch = self._gw_channels.get(name)
        if ch is None:
            raise KeyError(f"no channel registered under {name!r}")
        return ch

    def _register_key(self, ch: Channel, bucket):
        key = ch.queue_key(bucket)
        if key not in self._qinfo:
            with self._lock:
                if key not in self._qinfo:
                    self.queues.setdefault(key, [])
                    self._qinfo[key] = (ch, bucket)
                    self._qorder[key] = (str(ch.name),
                                         int(bucket[0]) * int(bucket[1]))
        return key

    def _push(self, ch: Channel, job) -> None:
        key = self._register_key(ch, ch.bucket_of(job))
        self.queues[key].append(job)

    # -- admission -----------------------------------------------------------
    def _admit(self, rid) -> bool:
        """Backpressure gate: make room under ``max_pending``, raise, or
        shed.  Returns False only under ``'shed'`` (the caller resolves
        the rejected request with a typed ``shed`` result)."""
        if self.max_pending is None or self._pending < self.max_pending:
            return True
        one, many = self._unit
        if self.backpressure == "raise":
            raise ServiceOverloaded(
                f"{one} {rid}: {self._pending} {many} pending >= "
                f"max_pending {self.max_pending}")
        if self.backpressure == "shed":
            with self._lock:
                self.stats["shed"] += 1
            self._metrics.counter("gw_shed_total").inc()
            return False
        # block: work batches off the queues synchronously until there is
        # room.  Outside wait() nothing is in flight, so queued work is
        # the entire backlog; stop only when the queues are empty (a
        # batch may legitimately complete zero requests — stale gens),
        # so submit can never spin on an idle service.
        while self._pending >= self.max_pending:
            if self._step() is None:
                break
        return True

    def _stamp_deadline(self, job) -> None:
        if self.deadline_s is not None and \
                getattr(job, "deadline", None) is None:
            job.deadline = self._clock() + self.deadline_s

    def submit_all(self, reqs: Sequence) -> list:
        return [self.submit(r) for r in reqs]

    # -- batch formation ------------------------------------------------------
    def _next_batch(self, worker: str = "w0"):
        """Pop the next ``(channel, bucket, jobs, coalesced, rows)``
        batch, smallest bucket first per channel, or None when every
        queue is empty (or cooling down in retry backoff)."""
        sp = obs_trace.span("gw.form", cat="gateway", worker=worker)
        with sp, self._lock:
            self._sample_queues()
            now = self._clock()
            for key in sorted((k for k, q in self.queues.items() if q),
                              key=self._qorder.__getitem__):
                ch, bucket = self._qinfo[key]
                queue = self.queues[key]
                # drop jobs resolved elsewhere (dead-lettered sites,
                # stale duplicates); dead-letter expired deadlines
                live = []
                for j in queue:
                    if ch.job_done(j):
                        continue
                    dl = ch.deadline_of(j)
                    if dl is not None and now >= dl:
                        self._dead_letter(ch, j, DeadlineExceeded(
                            f"{ch.name}/{ch.job_rid(j)}: deadline expired "
                            f"{now - dl:.3f}s ago before dispatch"),
                            worker=worker)
                        continue
                    live.append(j)
                queue[:] = live
                if not queue:
                    continue
                block = ch.block_for(bucket)
                # longest-first within a bounded arrival window: blocks
                # come out length-homogeneous (the engine's early-exit
                # fill stops at the *block max* wavefront).  A
                # passed-over counter guarantees progress under
                # sustained arrivals: a job out-sorted STALE_AFTER times
                # jumps to the front regardless of length, so no future
                # can be starved by a stream of longer requests.
                w = min(len(queue), 4 * block)
                queue[:w] = sorted(
                    queue[:w],
                    key=lambda j: (j.waits < self.STALE_AFTER,
                                   -ch.job_len(j)))
                jobs: List = []
                i = 0
                while i < len(queue) and len(jobs) < block:
                    if queue[i].not_before <= now:   # retry backoff gate
                        jobs.append(queue.pop(i))
                    else:
                        i += 1
                if not jobs:
                    continue                         # whole key cooling down
                for j in queue[:max(0, w - len(jobs))]:
                    j.waits += 1
                coalesced = False
                if not queue and len(jobs) < block:
                    bucket, block, coalesced = ch.coalesce(
                        bucket, jobs, block)
                sp.set(channel=ch.name, bucket=list(bucket), n=len(jobs))
                return ch.name, bucket, jobs, coalesced, block
            sp.drop()          # idle poll: keep worker tracks span-clean
            return None

    def _sample_queues(self) -> None:
        """Per-channel queue-depth gauges plus the Perfetto counter
        track samples (caller holds the lock)."""
        per = {name: 0 for name in self._gw_channels}
        for key, q in self.queues.items():
            if q:
                ch, _ = self._qinfo[key]
                per[ch.name] = per.get(ch.name, 0) + len(q)
        for name, n in per.items():
            self._metrics.gauge("gw_queue_depth", channel=name).set(n)
        self._metrics.gauge("gw_pending").set(self._pending)
        obs_trace.counter("gw.queue_depth", sum(per.values()))
        obs_trace.counter("gw.pending", self._pending)

    # -- launch / harvest (the two pipeline stages) ---------------------------
    def _launch(self, worker: str, item) -> InflightBatch:
        """Stage one batch on the device (the kernels are enqueued on the
        current stream; an align plan's traceback walk still waits on the
        device, see ``runtime/dispatch.py``).  On failure the popped jobs
        go through the bounded-retry requeue — a raising plan must never
        lose work."""
        name, bucket, jobs, coalesced, block = item
        ch = self._resolve_channel(name)
        self.monitor.beat(worker)
        with self._lock:
            seq = self._seq.get(worker, 0)
            self._seq[worker] = seq + 1
        fp = self.fault_plan
        if fp is not None and fp.kills(worker, seq):
            # silent death: the popped item never reached the device, so
            # requeue it without charging an attempt; batches already
            # launched by this worker stay in ``inflight`` until the
            # heartbeat deadline reclaims them.
            obs_trace.instant("gw.kill", cat="gateway", worker=worker,
                              seq=seq)
            with self._lock:
                self._killed.add(worker)
                self.stats["killed"].append({"worker": worker, "seq": seq})
                self._recover_jobs(ch, jobs, None, count_attempt=False,
                                   worker=worker)
            raise WorkerKilled(f"worker {worker!r} killed at dispatch #{seq}")
        degraded = (self.degrade_watermark is not None and ch.can_degrade
                    and self._pending >= self.degrade_watermark)
        sp = obs_trace.span("gw.launch", cat="gateway", worker=worker,
                            channel=name, seq=seq, n=len(jobs))
        try:
            with sp:
                if fp is not None and fp.fails_launch(worker, seq):
                    with self._lock:
                        self.stats["faults"] += 1
                    raise InjectedFault(
                        f"launch #{seq} on worker {worker!r} ({ch.name})")
                if degraded:
                    sp.set(degraded=True)
                    obs_trace.instant("gw.degrade", cat="gateway",
                                      worker=worker, channel=name,
                                      n=len(jobs))
                    ch.launch_degraded(bucket, jobs, block)
                    survivors: List = []
                    out = None
                else:
                    with obs_trace.annotate(f"gw.launch/{name}"):
                        survivors, out = ch.launch(bucket, jobs, block)
        except BaseException as exc:
            with self._lock:
                self._recover_jobs(ch, jobs, exc, count_attempt=True,
                                   worker=worker)
            raise
        self._observe_batch_shape(ch, bucket, jobs, block)
        ib = InflightBatch(worker=worker, kernel=name, bucket=bucket,
                           reqs=survivors,
                           gens=[j.gen for j in survivors], out=out,
                           cancelled=out is None, seq=seq,
                           launched_at=self._clock())
        with self._lock:
            self.inflight.setdefault(worker, []).append(ib)
            rec = ch.record(bucket, len(jobs) if degraded else len(survivors),
                            coalesced)
            if degraded:
                rec = dict(rec, degraded=True)
            self.dispatches.append(rec)
        return ib

    def _observe_batch_shape(self, ch: Channel, bucket, jobs,
                             block: int) -> None:
        """Occupancy / padding-waste histograms for one launched batch.
        Waste uses ``job_len`` against the bucket perimeter when the
        channel exposes lengths, else falls back to empty-row fraction."""
        occ = len(jobs) / block if block else 1.0
        self._metrics.histogram(
            "gw_batch_occupancy", channel=ch.name).observe(occ)
        used = sum(ch.job_len(j) for j in jobs)
        denom = block * (int(bucket[0]) + int(bucket[1]))
        waste = (max(0.0, 1.0 - used / denom) if used > 0 and denom > 0
                 else max(0.0, 1.0 - occ))
        self._metrics.histogram(
            "gw_padding_waste", channel=ch.name).observe(waste)

    def _harvest(self, item, ib: InflightBatch) -> int:
        """Block on one launched batch and land its results.

        Stale writes are discarded: a job re-dispatched since launch
        (``gen`` mismatch) or already resolved keeps its authoritative
        result.  On failure the still-incomplete jobs go through the
        bounded-retry requeue; the batch always leaves ``inflight``.
        """
        ch = self._resolve_channel(item[0])
        fp = self.fault_plan
        done = 0
        sp = obs_trace.span("gw.harvest", cat="gateway", worker=ib.worker,
                            channel=ch.name, seq=ib.seq, n=len(ib.reqs))
        t_h0 = self._clock()
        try:
            with sp:
                if not ib.cancelled:
                    if fp is not None:
                        lat = fp.harvest_latency(ib.worker, ib.seq)
                        if lat > 0.0:
                            time.sleep(lat)
                        if fp.fails_harvest(ib.worker, ib.seq):
                            with self._lock:
                                self.stats["faults"] += 1
                            raise InjectedFault(
                                f"harvest #{ib.seq} on worker {ib.worker!r} "
                                f"({ch.name})")
                    host = ch.materialize(ib.out)    # sync point: blocks
                    with self._lock:
                        for i, (job, gen) in enumerate(
                                zip(ib.reqs, ib.gens)):
                            if job.gen != gen or ch.job_done(job):
                                continue         # stale or double write
                            units = ch.land(job, i, host)
                            if units:
                                done += units
                                self._pending -= units
                                self.stats["completed"] += units
                                self._observe_latency(job, "completed")
                sp.set(done=done)
        except BaseException as exc:
            with self._lock:
                self._requeue_incomplete(ib, exc=exc, count_attempt=True)
            raise
        finally:
            with self._lock:
                self._forget(ib)
            self.monitor.beat(ib.worker)
        if done:
            self._metrics.counter("gw_completed_total").inc(done)
        if not ib.cancelled and ib.reqs:
            # device-level throughput: padded cells the batch filled
            cells = len(ib.reqs) * int(ib.bucket[0]) * int(ib.bucket[1])
            self._metrics.counter("gw_cells_total").inc(cells)
            dt = self._clock() - t_h0
            if dt > 0.0:
                self._metrics.histogram("gw_gcups").observe(
                    cells / dt / 1e9)
        return done

    def _forget(self, ib: InflightBatch) -> None:
        batches = self.inflight.get(ib.worker, [])
        if ib in batches:
            batches.remove(ib)
        if not batches:
            self.inflight.pop(ib.worker, None)

    # -- failure recovery -----------------------------------------------------
    def _recover_jobs(self, ch: Channel, jobs, exc, *, count_attempt: bool,
                      gens=None, worker: Optional[str] = None) -> int:
        """Requeue popped-but-unfinished jobs with a bumped generation,
        under the bounded-retry contract: an attempt-charging failure
        past ``max_retries`` dead-letters the job instead, and
        ``retry_backoff_s`` schedules exponential backoff.  Returns the
        number of jobs recovered (requeued or dead-lettered).  Caller
        holds the lock."""
        now = self._clock()
        n = 0
        retry: List = []
        for idx, job in enumerate(jobs):
            if gens is not None and job.gen != gens[idx]:
                continue                      # re-dispatched since launch
            if ch.job_done(job):
                continue
            job.gen += 1
            n += 1
            if count_attempt:
                job.attempts += 1
                if self.max_retries is not None and \
                        job.attempts > self.max_retries:
                    self._dead_letter(ch, job, RetriesExhausted(
                        f"{ch.name}/{ch.job_rid(job)}: attempt "
                        f"{job.attempts} > max_retries {self.max_retries}"
                        + (f" (last error: {exc})" if exc is not None
                           else "")), worker=worker)
                    continue
                self.stats["retries"] += 1
                self._metrics.counter("gw_retries_total").inc()
            retry.append(job)
            if count_attempt and self.retry_backoff_s > 0.0:
                job.not_before = now + self.retry_backoff_s * \
                    (2.0 ** (job.attempts - 1))
        if retry:
            obs_trace.instant("gw.retry", cat="gateway", channel=ch.name,
                              n=len(retry), worker=worker)
            if ch.requeue_front:
                # FIFO channels (mapping) put the failed chunk back at
                # the front in its original relative order
                groups: Dict[object, List] = {}
                for j in retry:
                    key = self._register_key(ch, ch.bucket_of(j))
                    groups.setdefault(key, []).append(j)
                for key, grp in groups.items():
                    self.queues[key][:0] = grp
            else:
                for j in retry:
                    self._push(ch, j)
        return n

    def _requeue_incomplete(self, ib: InflightBatch, *, exc=None,
                            count_attempt: bool = False) -> int:
        """Put a batch's unfinished jobs back on their queues with a
        bumped generation (so any late device result is discarded)."""
        ib.cancelled = True
        ch = self._resolve_channel(ib.kernel)
        return self._recover_jobs(ch, ib.reqs, exc,
                                  count_attempt=count_attempt, gens=ib.gens,
                                  worker=ib.worker)

    def _dead_letter(self, ch: Channel, job, exc: BaseException, *,
                     free_pending: bool = True,
                     worker: Optional[str] = None) -> int:
        """Resolve a job with a typed error result and record it.
        Caller holds the lock."""
        freed = ch.fail(job, exc)
        if freed:
            if free_pending:
                self._pending -= freed
            self._record_dead_letter(ch.name, ch.job_rid(job), exc,
                                     worker=worker,
                                     attempts=getattr(job, "attempts", 0))
            self._observe_latency(job, "dead_letter")
        return freed

    def _record_dead_letter(self, channel: str, rid, exc, *,
                            worker: Optional[str] = None,
                            attempts: int = 0) -> None:
        kind = getattr(exc, "kind", "error")
        self.stats["dead_lettered"] += 1
        self.dead_letters.append({
            "rid": rid, "channel": channel, "kind": kind,
            "error": f"{type(exc).__name__}: {exc}",
            "worker": worker, "attempts": int(attempts),
            "ts": self._clock()})
        self._metrics.counter("gw_dead_letters_total", kind=kind).inc()
        obs_trace.instant("gw.dead_letter", cat="gateway", channel=channel,
                          rid=rid, kind=kind, worker=worker)

    def _job_resolved(self, job, units: int = 1,
                      counter: str = "completed") -> None:
        """Accounting hook for jobs a channel resolves outside harvest
        (prefilter rejects, degraded answers)."""
        with self._lock:
            self._pending -= units
            self.stats[counter] = self.stats.get(counter, 0) + units
        self._metrics.counter(f"gw_{counter}_total").inc(units)
        self._observe_latency(job, counter)

    # -- observability --------------------------------------------------------
    def _count_submitted(self, job=None, units: int = 1) -> None:
        """Intake accounting: services call this for every request that
        passed validation *and* ``_admit`` (a ``backpressure='raise'``
        rejection never resolves, so it must never count).  Stamps the
        submit time used for submit→resolve latency and feeds the
        reconciliation invariant ``submitted == completed + degraded +
        filtered + dead_lettered``."""
        if job is not None:
            try:
                job._t_submit = self._clock()
            except Exception:
                pass                       # slotted/frozen job types
        with self._lock:
            self.stats["submitted"] += units
        self._metrics.counter("gw_submitted_total").inc(units)

    def _observe_latency(self, job, outcome: str) -> None:
        """Submit→resolve latency for one resolved job (pair jobs reach
        their site's stamp through ``job.req``).  Stamps the resolve time
        on the job as ``_t_resolve``, so a caller can take exact latency
        percentiles beside the histogram's bucketed ones."""
        now = self._clock()
        try:
            job._t_resolve = now
        except Exception:
            pass                           # slotted/frozen job types
        t0 = getattr(job, "_t_submit", None)
        if t0 is None:
            t0 = getattr(getattr(job, "req", None), "_t_submit", None)
        if t0 is not None:
            self._metrics.histogram("gw_latency_s", outcome=outcome) \
                .observe(now - t0)

    def metrics(self) -> dict:
        """One JSON-safe observability snapshot: the stats dict, every
        metric family, dead letters by kind, plan-cache totals and the
        reconciliation invariant the chaos gate asserts
        (``submitted == resolved + dead_lettered``)."""
        from repro_torch.runtime import plan as plan_mod
        with self._lock:
            stats = {k: (list(v) if isinstance(v, list) else v)
                     for k, v in self.stats.items()}
            by_kind: Dict[str, int] = {}
            for d in self.dead_letters:
                by_kind[d["kind"]] = by_kind.get(d["kind"], 0) + 1
        resolved = int(stats["completed"]) + int(stats["degraded"]) \
            + int(stats["filtered"])
        dead = int(stats["dead_lettered"])
        submitted = int(stats["submitted"])
        return {
            "stats": stats,
            "metrics": self._metrics.snapshot(),
            "dead_letters_by_kind": by_kind,
            "plan_cache": plan_mod.plan_cache_info()["totals"],
            "reconcile": {
                "submitted": submitted, "resolved": resolved,
                "dead_lettered": dead,
                "ok": submitted == resolved + dead},
        }

    def prometheus(self) -> str:
        """This gateway's metrics in Prometheus text exposition."""
        return self._metrics.prometheus()

    def dump_trace(self, path: str) -> dict:
        """Write everything :mod:`repro_torch.obs.trace` collected as Chrome
        trace-event JSON (open at https://ui.perfetto.dev); returns the
        object written."""
        from repro_torch.obs import export as obs_export
        return obs_export.write_chrome_trace(path)

    # -- the inline dispatcher loop -------------------------------------------
    def _step(self, worker: str = "w0") -> Optional[int]:
        """Launch + harvest one batch synchronously; #completed units, or
        ``None`` when every queue is empty."""
        item = self._next_batch(worker)
        if item is None:
            return None
        return self._harvest(item, self._launch(worker, item))

    def wait(self, futures: Optional[Sequence] = None,
             worker: str = "w0") -> int:
        """Run the pipelined dispatcher until ``futures`` resolve (or,
        with ``futures=None``, until every queue is empty).  Returns the
        number of completed units.

        Host padding of batch N+1 overlaps device compute of batch N
        (``runtime.dispatch.run_pipelined``); heartbeats fire at every
        launch and harvest, so a worker wedged inside a device sync goes
        quiet and ``redispatch_dead`` can reclaim its batches.
        """
        def batches() -> Iterator:
            while True:
                if futures is not None and all(f.done() for f in futures):
                    return
                item = self._next_batch(worker)
                if item is None:
                    return
                yield item

        return dispatch_mod.run_pipelined(
            batches(),
            lambda item: self._launch(worker, item),
            self._harvest,
            depth=self.pipeline_depth,
            on_abandon=lambda item, ib: self._abandon(worker, item, ib))

    def _abandon(self, worker: str, item, ib: InflightBatch) -> None:
        if worker in self._killed:
            # silent death: leave the window in ``inflight`` — the
            # heartbeat deadline (or the serve() supervisor noticing the
            # dead thread) reclaims it, exactly like a wedged worker
            return
        with self._lock:
            self._requeue_incomplete(ib)
            self._forget(ib)

    def drain(self, worker: str = "w0") -> int:
        """Compat wrapper: submissions have happened via ``submit``;
        process everything queued and return #completed."""
        return self.wait(worker=worker)

    # -- supervision ----------------------------------------------------------
    def redispatch_dead(self, now: Optional[float] = None) -> int:
        """Requeue in-flight batches whose worker stopped beating.

        Requeued jobs get a new generation, so if the original batch
        does eventually finish, its harvest is discarded — exactly one
        result per request ever lands.  The dead worker's heartbeat
        history is dropped (``monitor.forget``) so its stale intervals
        stop skewing straggler detection.
        """
        n = 0
        sp = obs_trace.span("gw.sweep_dead", cat="supervise")
        with sp, self._lock:
            for worker in list(self.inflight):
                # status() is DEAD both for tracked workers past the
                # deadline and for workers that never beat at all
                if self.monitor.status(worker, now) == DEAD:
                    for ib in self.inflight.pop(worker, []):
                        n += self._requeue_incomplete(ib, count_attempt=True)
                    self.monitor.forget(worker)
                    self._killed.discard(worker)
            if n:
                self.stats["redispatched"] += n
                self._metrics.counter("gw_redispatched_total").inc(n)
                sp.set(n=n)
            else:
                sp.drop()
        return n

    def redispatch_timed_out(self, now: Optional[float] = None) -> int:
        """Reclaim launched batches older than ``harvest_timeout_s`` —
        the per-batch bound that catches a harvest wedged on one bad
        batch while its worker still beats on others."""
        if self.harvest_timeout_s is None:
            return 0
        now = self._clock() if now is None else now
        n = 0
        sp = obs_trace.span("gw.sweep_timeout", cat="supervise")
        with sp, self._lock:
            for worker in list(self.inflight):
                batches = self.inflight[worker]
                for ib in list(batches):
                    if ib.cancelled or ib.launched_at is None:
                        continue
                    if now - ib.launched_at > self.harvest_timeout_s:
                        batches.remove(ib)
                        n += self._requeue_incomplete(ib, count_attempt=True)
                if not batches:
                    self.inflight.pop(worker, None)
            if n:
                self.stats["timed_out"] += n
                self.stats["redispatched"] += n
                self._metrics.counter("gw_redispatched_total").inc(n)
                sp.set(n=n)
            else:
                sp.drop()
        return n

    def sweep_deadlines(self, now: Optional[float] = None) -> int:
        """Dead-letter queued jobs whose deadline passed (the per-batch
        check in ``_next_batch`` only sees queues being popped; this
        sweep also covers idle ones)."""
        now = self._clock() if now is None else now
        n = 0
        sp = obs_trace.span("gw.sweep_deadlines", cat="supervise")
        with sp, self._lock:
            for key, queue in list(self.queues.items()):
                if not queue:
                    continue
                ch, _ = self._qinfo[key]
                live = []
                for j in queue:
                    if ch.job_done(j):
                        continue
                    dl = ch.deadline_of(j)
                    if dl is not None and now >= dl:
                        n += self._dead_letter(ch, j, DeadlineExceeded(
                            f"{ch.name}/{ch.job_rid(j)}: deadline expired "
                            f"{now - dl:.3f}s ago in queue"),
                            worker="supervisor")
                        continue
                    live.append(j)
                queue[:] = live
            if n:
                sp.set(n=n)
            else:
                sp.drop()
        return n

    # -- the multi-worker pool ------------------------------------------------
    def _drive(self, worker: str, stop: threading.Event) -> int:
        def batches() -> Iterator:
            while not stop.is_set():
                item = self._next_batch(worker)
                if item is None:
                    return
                yield item

        return dispatch_mod.run_pipelined(
            batches(),
            lambda item: self._launch(worker, item),
            self._harvest,
            depth=self.pipeline_depth,
            on_abandon=lambda item, ib: self._abandon(worker, item, ib))

    def _worker_loop(self, worker: str, stop: threading.Event,
                     poll_s: float) -> None:
        while not stop.is_set():
            try:
                self._drive(worker, stop)
            except WorkerKilled:
                return                        # silent death: no cleanup
            except GatewayError:
                continue                      # injected fault: keep going
            except BaseException:
                with self._lock:
                    self.stats["worker_errors"] += 1
                continue                      # recovery already requeued
            if stop.is_set():
                return
            self.monitor.beat(worker)         # idle beat: alive, no work
            time.sleep(poll_s)

    def _all_done(self, futures) -> bool:
        if futures is not None:
            return all(f.done() for f in futures)
        with self._lock:
            return (self._pending <= 0
                    and not any(self.queues.values())
                    and not self.inflight)

    def serve(self, n_workers: int = 2, futures: Optional[Sequence] = None,
              *, poll_s: float = 0.004, timeout_s: float = 60.0,
              elastic: bool = False,
              max_workers: Optional[int] = None) -> dict:
        """Drive the queues with a pool of ``n_workers`` dispatcher
        threads until ``futures`` resolve (or, with ``futures=None``,
        until queues, pending and inflight are all empty).

        The calling thread is the supervisor: it reclaims dead workers'
        batches (``redispatch_dead`` + ``redispatch_timed_out``), sweeps
        expired deadlines, and — with ``elastic=True`` — respawns a
        fresh worker for each one that died (``max_workers`` caps the
        total ever spawned).  Departed workers are dropped from the
        heartbeat fleet so their history can't skew straggler detection.
        Returns a stats snapshot (plus wall time and worker count).
        """
        if n_workers < 1:
            raise ValueError(f"n_workers must be >= 1, got {n_workers}")
        stop = threading.Event()
        threads: Dict[str, threading.Thread] = {}
        spawned = 0

        def spawn() -> str:
            nonlocal spawned
            name = f"w{spawned}"
            spawned += 1
            t = threading.Thread(target=self._worker_loop, name=f"gw-{name}",
                                 args=(name, stop, poll_s), daemon=True)
            threads[name] = t
            t.start()
            return name

        for _ in range(n_workers):
            spawn()
        t0 = time.monotonic()
        try:
            while not self._all_done(futures):
                if time.monotonic() - t0 > timeout_s:
                    raise GatewayTimeout(
                        f"serve(): workload incomplete after {timeout_s}s "
                        f"({self._pending} pending, "
                        f"{len(self.dead_letters)} dead-lettered)")
                self.redispatch_dead()
                self.redispatch_timed_out()
                self.sweep_deadlines()
                for name, t in list(threads.items()):
                    if not t.is_alive():
                        threads.pop(name)
                        self.monitor.forget(name)
                        if elastic and (max_workers is None
                                        or spawned < max_workers):
                            fresh = spawn()
                            self.stats["respawned"].append(fresh)
                            obs_trace.instant("gw.respawn", cat="supervise",
                                              worker=fresh, died=name)
                time.sleep(poll_s)
        finally:
            stop.set()
            for t in threads.values():
                t.join(timeout=5.0)
        return dict(self.stats, wall_s=time.monotonic() - t0,
                    workers=spawned)
