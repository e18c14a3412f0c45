"""GenerationJob and JobExecutor: image generation through the admission
plane (the port's own copy of cake_tpu/serve/admission/jobs.py:
GenerationJob, JobExecutor, JobCancelled, JobsDraining).

An image job does not decode through KV slots, so the serve engine does
not batch it; it still flows through the SAME class-aware weighted-fair
queue as chat (its depth counts into cake_serve_queue_depth and
cake_serve_qos_queue_depth), emits the same timeline events (enqueue,
admit, finish, with class and tenant; `GET /api/v1/requests/<id>` shows
its lifecycle) and respects drain (new jobs refused typed while running
ones finish).

The executor runs at most CAKE_JOB_WORKERS (default 1) jobs at once, on
threads started at the first submit. A job function receives its job and
calls `job.checkpoint()` between diffusion steps: the checkpoint raises
JobCancelled once the client has gone (the job stops at the next step
instead of finishing for nobody) and yields the thread briefly while
interactive requests are queued anywhere on the plane.
"""
from __future__ import annotations

import logging
import os
import threading
import time
import uuid

from ...obs import (SERVE_JOBS_RUNNING, SERVE_QOS_E2E_SECONDS,
                    SERVE_QOS_QUEUE_DEPTH, TIMELINES, now, set_request_id)
from .queue import AdmissionQueue

__all__ = ["GenerationJob", "JobCancelled", "JobExecutor", "JobsDraining"]

log = logging.getLogger("cake_tpu_torch.serve.admission")

# seconds a checkpoint yields while interactive work is queued: enough for
# the engine's scheduler thread to take the GIL and dispatch
_YIELD_S = 0.002


class JobCancelled(Exception):
    """Raised inside job.checkpoint() once the client abandoned the job."""


class JobsDraining(RuntimeError):
    """Job admission refused: the plane is draining for shutdown (running
    jobs finish; new ones answer 503 with Retry-After)."""

    def __init__(self, retry_after_s: int = 5):
        super().__init__("admission plane draining for shutdown")
        self.retry_after_s = retry_after_s


class GenerationJob:
    """One queued heavy workload: id / qos / tenant / t_enqueue /
    cancelled / admitted / done / result ("value" or "error")."""

    def __init__(self, kind: str, fn, qos: str = "batch",
                 tenant: str | None = None, request_id: str | None = None):
        self.id = request_id or f"{kind}-" + uuid.uuid4().hex[:16]
        self.kind = kind                # "image"
        self.fn = fn                    # fn(job) -> result value
        self.qos = qos
        self.tenant = tenant
        self.t_enqueue = now()
        self.cancelled = threading.Event()
        self.admitted = threading.Event()
        self.done = threading.Event()
        self.result: dict = {}
        self._done_cbs: list = []
        self._cb_lock = threading.Lock()

    def cancel(self) -> None:
        self.cancelled.set()

    def wait(self, timeout: float | None = None) -> bool:
        return self.done.wait(timeout)

    def add_done_callback(self, cb) -> None:
        """cb runs (worker thread) at the terminal transition, or at once
        (caller thread) if the job has already finished."""
        with self._cb_lock:
            if not self.done.is_set():
                self._done_cbs.append(cb)
                return
        cb()

    def checkpoint(self) -> None:
        """Between diffusion steps: abort a cancelled job, and yield while
        interactive traffic is queued anywhere on the plane."""
        if self.cancelled.is_set():
            raise JobCancelled(f"job {self.id} cancelled")
        if SERVE_QOS_QUEUE_DEPTH.value(qos="interactive") > 0:
            time.sleep(_YIELD_S)

    def _finish(self, value=None, error: BaseException | None = None):
        if error is not None:
            self.result["error"] = error
        else:
            self.result["value"] = value
        with self._cb_lock:
            self.done.set()
            cbs, self._done_cbs = self._done_cbs, []
        for cb in cbs:
            try:
                cb()
            except Exception:
                pass                    # the waiter may be gone


class JobExecutor:
    """At most `workers` (CAKE_JOB_WORKERS, 1) jobs running at once, fed
    weighted-fair from a class-aware AdmissionQueue of CAKE_MAX_QUEUE
    (64) per class."""

    def __init__(self, workers: int | None = None,
                 max_queue: int | None = None):
        if workers is None:
            workers = int(os.environ.get("CAKE_JOB_WORKERS") or 1)
        self.workers = max(int(workers), 1)
        if max_queue is None:
            max_queue = int(os.environ.get("CAKE_MAX_QUEUE") or 64)
        self.queue = AdmissionQueue(max_queue)
        self.running = 0                # guarded by self._lock
        self._running_by_kind: dict = {}
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._draining = threading.Event()
        self._threads: list[threading.Thread] = []

    def submit(self, job: GenerationJob) -> GenerationJob:
        """Enqueue; raises JobsDraining during drain and QueueFull when the
        job's class lane is at its bound."""
        if self._draining.is_set() or self._stop.is_set():
            raise JobsDraining()
        self.queue.put(job)
        # close() may have drained the queue between the check and the put
        if self._stop.is_set() and self.queue.purge(lambda j: j is job):
            raise JobsDraining()
        TIMELINES.begin(job.id)
        TIMELINES.event(job.id, "enqueue", qos=job.qos, workload=job.kind,
                        depth=self.queue.depth(),
                        **({"tenant": job.tenant} if job.tenant else {}))
        self._ensure_threads()
        self._wake.set()
        return job

    def _ensure_threads(self) -> None:
        with self._lock:
            while len(self._threads) < self.workers:
                t = threading.Thread(target=self._loop, daemon=True,
                                     name=f"cake-torch-jobs-"
                                          f"{len(self._threads)}")
                self._threads.append(t)
                t.start()

    def begin_drain(self) -> None:
        """Refuse new jobs at once; running and queued ones go on."""
        self._draining.set()
        self._wake.set()

    def drain(self, timeout: float | None = None) -> bool:
        """Refuse new jobs and wait for the queued and running ones; True
        once idle, False at the timeout."""
        self.begin_drain()
        deadline = None if timeout is None else now() + timeout
        while self.queue.depth() or self.running_count():
            if deadline is not None and now() >= deadline:
                return False
            time.sleep(0.02)
        return True

    def running_count(self) -> int:
        with self._lock:
            return self.running

    def close(self, timeout: float = 5.0) -> None:
        self._stop.set()
        self._wake.set()
        for job in self.queue.drain():
            job._finish(error=JobsDraining())
        for t in self._threads:
            t.join(timeout=timeout)

    def _loop(self) -> None:
        while not self._stop.is_set():
            job = self.queue.pop()
            if job is None:
                self._wake.wait(0.2)
                self._wake.clear()
                continue
            if job.cancelled.is_set():
                job._finish(error=JobCancelled(
                    f"job {job.id} cancelled while queued"))
                continue
            self._run_one(job)

    def _set_running(self, job: GenerationJob, delta: int) -> None:
        with self._lock:
            self.running += delta
            n = max(self._running_by_kind.get(job.kind, 0) + delta, 0)
            self._running_by_kind[job.kind] = n
        SERVE_JOBS_RUNNING.set(n, kind=job.kind)

    def _run_one(self, job: GenerationJob) -> None:
        self._set_running(job, 1)
        job.admitted.set()
        tenant = {"tenant": job.tenant} if job.tenant else {}
        TIMELINES.event(job.id, "admit", qos=job.qos, workload=job.kind,
                        queue_wait_ms=round((now() - job.t_enqueue) * 1e3,
                                            3), **tenant)
        set_request_id(job.id)
        try:
            value = job.fn(job)
        except JobCancelled as e:
            TIMELINES.event(job.id, "error", type="cancelled")
            job._finish(error=e)
        except BaseException as e:      # surfaced to the API's waiter
            TIMELINES.event(job.id, "error", type=type(e).__name__)
            job._finish(error=e)
        else:
            TIMELINES.event(job.id, "finish", outcome="ok", qos=job.qos,
                            e2e_ms=round((now() - job.t_enqueue) * 1e3, 3),
                            **tenant)
            job._finish(value=value)
        finally:
            set_request_id(None)
            self._set_running(job, -1)
            err = job.result.get("error")
            SERVE_QOS_E2E_SECONDS.observe(
                now() - job.t_enqueue, exemplar=job.id, qos=job.qos,
                outcome="ok" if err is None else (
                    "cancelled" if isinstance(err, JobCancelled)
                    else "error"))
