"""Request batching for the serving layer.

Port of the JAX package's ``serve/batcher.py``:
  - ``DynamicBatcher``: every /generate request becomes a Job for one
    worker thread, which drains the queue for ``window_ms`` after a job
    arrives and runs each group of compatible jobs as ONE
    ``ChatterboxTTS.generate_batch`` call under the shared device lock.
    Compatible means the same generation parameters and conditionals of
    the same shapes (``Conditionals.stack`` row-stacks mixed voices, so
    different emotion profiles batch together). A request with an explicit
    ``seed`` runs alone: a batch shares its draws, so batching would change
    what a seeded request gets. Admission control: while a stream is live
    (``stream_active_fn``), a bulk batch runs through
    ``generate_batch_preemptible``, which releases the lock between its
    pieces, so that stream ticks interleave with it.
  - ``StreamBatcher``: concurrent /generate/stream requests form LOCKSTEP
    groups (``pipeline/streaming.stream_generate_batch``), and the worker
    advances every live group one tick at a time under the device lock.
The cost of coalescing: a lone request waits up to one window for
companions.
"""

import logging
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)


def _cond_shapes(conds) -> Tuple:
    """The shapes past the batch axis of every conditionals tensor: jobs
    whose shapes agree can be row-stacked into one call."""
    return tuple(tuple(x.shape[1:]) for x in (*conds.t3, *conds.gen))


@dataclass
class Job:
    text: str
    conds: Any  # single-voice Conditionals (leading dim 1)
    params: Dict[str, Any]  # generate_batch kwargs (sampling + max_new_tokens)
    seed: Optional[int]  # explicit request seed -> solo group
    done: threading.Event = field(default_factory=threading.Event)
    result: Any = None
    error: Optional[BaseException] = None

    def group_key(self) -> Tuple:
        return (
            tuple(sorted(self.params.items())),
            _cond_shapes(self.conds),
            self.seed,  # None for all batchable jobs; a seeded job is unique
            id(self) if self.seed is not None else 0,
        )


class DynamicBatcher:
    """Coalesces concurrent generate requests into batched pipeline calls.

    ``submit`` blocks the calling (HTTP handler) thread until its request's
    row is synthesized; all device work runs on the single worker thread.
    """

    def __init__(self, tts, max_batch: int = 16, window_ms: float = 25.0,
                 device_lock=None, stream_active_fn=None,
                 bulk_chunk_tokens: int = 50, bulk_rows_with_streams: int = 4):
        self.tts = tts
        self.max_batch = max_batch
        self.window_ms = window_ms
        # serializes pipeline dispatch/compile against OTHER device users
        # (streaming handlers, cold-voice conditioning) -- see service.py
        from .fairlock import FairRLock

        self.device_lock = device_lock or FairRLock()
        # mixed-load admission control: when ``stream_active_fn()`` reports
        # live streams, bulk batches run PREEMPTIBLY
        # (ChatterboxTTS.generate_batch_preemptible) -- chunked T3 decode and
        # row-split synthesis with the device lock released between the
        # pieces -- so a stream tick waits for one piece instead of a whole
        # batch. None or bulk_chunk_tokens=0 turns it off.
        self.stream_active_fn = stream_active_fn
        self.bulk_chunk_tokens = bulk_chunk_tokens
        self.bulk_rows_with_streams = bulk_rows_with_streams
        self.queue: "queue.Queue[Job]" = queue.Queue()
        self.stats = {"requests": 0, "batches": 0, "rows_in_batches": 0,
                      "max_batch_seen": 0, "preempted_batches": 0}
        self._stats_lock = threading.Lock()
        self._stop = False
        self.worker = threading.Thread(target=self._run, name="tts-batcher", daemon=True)
        self.worker.start()

    # ------------------------------------------------------------------ api
    def submit(self, text: str, conds, params: Dict[str, Any], seed: Optional[int],
               timeout: Optional[float] = None):
        job = Job(text=text, conds=conds, params=dict(params), seed=seed)
        with self._stats_lock:  # submit runs on many handler threads
            self.stats["requests"] += 1
        self.queue.put(job)
        if not job.done.wait(timeout):
            raise TimeoutError("generation timed out")
        if job.error is not None:
            raise job.error
        return job.result

    def shutdown(self):
        self._stop = True
        self.queue.put(None)  # wake the worker
        self.worker.join(timeout=5)

    # --------------------------------------------------------------- worker
    def _collect_window(self, first: Job) -> List[Job]:
        """Gather jobs arriving within window_ms of the first (bounded by
        max_batch); a lone request proceeds after at most one window."""
        jobs = [first]
        deadline = time.monotonic() + self.window_ms / 1000.0
        while len(jobs) < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                j = self.queue.get(timeout=remaining)
            except queue.Empty:
                break
            if j is None:
                self._stop = True
                break
            jobs.append(j)
        return jobs

    def _run(self):
        while not self._stop:
            try:
                first = self.queue.get()
            except Exception:
                continue
            if first is None:
                break
            jobs = self._collect_window(first)
            # group by compatibility; preserve arrival order within groups
            groups: Dict[Tuple, List[Job]] = {}
            for j in jobs:
                groups.setdefault(j.group_key(), []).append(j)
            for group in groups.values():
                self._execute(group)

    def _execute(self, group: List[Job]):
        from ..pipeline.conditionals import Conditionals

        try:
            texts = [j.text for j in group]
            conds = Conditionals.stack([j.conds for j in group])
            params = group[0].params
            seed = group[0].seed
            if seed is None:
                # fresh draw per batch; no request asked for determinism
                seed = int(time.time() * 1000) % (2**31)
            if (
                self.stream_active_fn is not None
                and self.bulk_chunk_tokens > 0
                and self.stream_active_fn()
            ):
                # admission control: live streams -> bounded bulk dispatches
                # (token-identical to the one-shot path; see pipeline/tts)
                wavs = self.tts.generate_batch_preemptible(
                    texts, conds=conds, seed=seed, lock=self.device_lock,
                    t3_chunk_tokens=self.bulk_chunk_tokens,
                    s3gen_max_rows=self.bulk_rows_with_streams, **params,
                )
                self.stats["preempted_batches"] += 1
            else:
                with self.device_lock:
                    wavs = self.tts.generate_batch(texts, conds=conds, seed=seed, **params)
            self.stats["batches"] += 1
            self.stats["rows_in_batches"] += len(group)
            self.stats["max_batch_seen"] = max(self.stats["max_batch_seen"], len(group))
            for j, w in zip(group, wavs):
                j.result = w
                j.done.set()
        except Exception as e:  # propagate to every waiting handler
            logger.exception("batched generation failed")
            for j in group:
                j.error = e
                j.done.set()


@dataclass
class StreamJob:
    text: str
    conds: Any
    params: Dict[str, Any]  # stream_generate_batch kwargs (sampling etc.)
    seed: Optional[int]
    out: "queue.Queue" = field(default_factory=queue.Queue)

    def group_key(self) -> Tuple:
        return (
            tuple(sorted(self.params.items())),
            _cond_shapes(self.conds),
            self.seed,
            id(self) if self.seed is not None else 0,
        )


class _StreamGroup:
    """One lockstep stream_generate_batch generator + its per-row sinks."""

    def __init__(self, tts, jobs: List["StreamJob"]):
        from ..pipeline.conditionals import Conditionals
        from ..pipeline.streaming import stream_generate_batch

        self.jobs = jobs
        texts = [j.text for j in jobs]
        conds = Conditionals.stack([j.conds for j in jobs])
        seed = jobs[0].seed
        if seed is None:
            seed = int(time.time() * 1000) % (2**31)
        self.gen = stream_generate_batch(
            tts, texts, conds=conds, seed=seed, **jobs[0].params
        )

    def tick(self) -> bool:
        """Advance one lockstep step; deliver per-row chunks. Returns False
        when the group is finished (sentinels delivered)."""
        try:
            chunks = next(self.gen)
        except StopIteration:
            for j in self.jobs:
                j.out.put(None)
            return False
        except Exception as e:  # deliver the error to every stream
            logger.exception("lockstep stream group failed")
            for j in self.jobs:
                j.out.put(e)
            return False
        for j, c in zip(self.jobs, chunks):
            if c is not None and len(c):
                j.out.put(c)
        return True


class StreamBatcher:
    """Coalesces concurrent /generate/stream requests into LOCKSTEP groups
    (pipeline/streaming.stream_generate_batch): N streams share one batched
    T3 chunk and one batched flow and vocoder a tick instead of serializing
    N whole streams on the device lock.

    The worker interleaves ALL active groups one tick at a time, so a stream
    that arrives while another is playing starts after at most one tick +
    window rather than after the whole earlier stream. Requests arriving
    within ``window_ms`` of each other (and compatible: same sampling
    params, stackable voices, no explicit seed) form one group, capped at
    ``max_streams`` rows.
    """

    def __init__(self, tts, max_streams: int = 8, window_ms: float = 50.0,
                 device_lock=None):
        self.tts = tts
        self.max_streams = max_streams
        self.window_ms = window_ms
        from .fairlock import FairRLock

        self.device_lock = device_lock or FairRLock()
        self.queue: "queue.Queue[StreamJob]" = queue.Queue()
        self.stats = {"stream_requests": 0, "stream_groups": 0,
                      "max_group_seen": 0, "active_streams": 0}
        self._stats_lock = threading.Lock()
        self._active: List[_StreamGroup] = []  # owned by the worker thread
        self._stop = False
        self.worker = threading.Thread(target=self._run, name="tts-stream-batcher", daemon=True)
        self.worker.start()

    def has_active(self) -> bool:
        """Advisory: any live or queued streams? (The DynamicBatcher's
        admission-control trigger -- momentary staleness is harmless: the
        policy only changes bulk dispatch granularity.)"""
        return bool(self._active) or not self.queue.empty()

    def submit(self, text: str, conds, params: Dict[str, Any], seed: Optional[int]):
        """Returns an iterator of float32 chunks (raises mid-iteration on
        group failure)."""
        job = StreamJob(text=text, conds=conds, params=dict(params), seed=seed)
        with self._stats_lock:  # submit runs on many handler threads
            self.stats["stream_requests"] += 1
        self.queue.put(job)

        def chunks():
            while True:
                item = job.out.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item

        return chunks()

    def shutdown(self):
        self._stop = True
        self.queue.put(None)
        self.worker.join(timeout=5)

    # --------------------------------------------------------------- worker
    def _drain_new_jobs(self, block: bool) -> List[StreamJob]:
        jobs: List[StreamJob] = []
        try:
            first = self.queue.get(block=block)
        except queue.Empty:
            return jobs
        if first is None:
            self._stop = True
            return jobs
        jobs.append(first)
        deadline = time.monotonic() + self.window_ms / 1000.0
        while len(jobs) < self.max_streams:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                j = self.queue.get(timeout=remaining)
            except queue.Empty:
                break
            if j is None:
                self._stop = True
                break
            jobs.append(j)
        return jobs

    def _run(self):
        while not self._stop:
            new = self._drain_new_jobs(block=not self._active)
            if new:
                groups: Dict[Tuple, List[StreamJob]] = {}
                for j in new:
                    groups.setdefault(j.group_key(), []).append(j)
                for jobs in groups.values():
                    try:
                        with self.device_lock:
                            self._active.append(_StreamGroup(self.tts, jobs))
                        self.stats["stream_groups"] += 1
                        self.stats["max_group_seen"] = max(
                            self.stats["max_group_seen"], len(jobs)
                        )
                    except Exception as e:
                        logger.exception("stream group start failed")
                        for j in jobs:
                            j.out.put(e)
            still = []
            for g in self._active:
                with self.device_lock:
                    alive = g.tick()
                if alive:
                    still.append(g)
            self._active = still
            self.stats["active_streams"] = sum(len(g.jobs) for g in self._active)
        for g in self._active:
            for j in g.jobs:
                j.out.put(None)
