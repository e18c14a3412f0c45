"""Continuous-batching serve engine (the core of
cake_tpu/serve/engine.py: ServeEngine, ServeRequest, chunked admission).

A bounded admission queue feeds one scheduler thread that owns a fixed
pool of KV rows ("slots") and every device tensor. Each iteration:

  1. sweeps cancelled requests (decoding, mid-prefill, queued);
  2. moves queued requests into free slots as chunked admissions;
  3. dispatches ONE batched decode step over the pool (rows whose prefill
     has completed are `active`; the others ride along frozen);
  4. advances ONE in-flight admission by one chunk (round-robin), so a
     long prompt delays running decodes by a chunk, never by the prompt;
  5. fetches the step's packed token ids in one device-to-host copy and
     fans them out to the request streams.

Every torch call happens on the scheduler thread, so the device state
needs no lock; client threads only touch thread-safe queues and events.
Left out of this port so far (see ROADMAP.md): prefix cache, paged KV,
speculative decoding, preemption, the crash-recovery supervisor, QoS
lanes, deadlines and the metrics plane. A failure on the scheduler thread
fails every request and marks the engine dead.
"""
from __future__ import annotations

import collections
import logging
import queue as queue_mod
import threading
import time
import uuid

import torch

from ..ops.sampling import SamplingConfig

log = logging.getLogger("cake_tpu_torch.serve")

RECENT_N = SamplingConfig().repeat_last_n
DEFAULT_SLOTS = 4
DEFAULT_CTX = 4096
DEFAULT_CHUNK = 256
DEFAULT_QUEUE = 64


class QueueFull(RuntimeError):
    def __init__(self, retry_after_s: int = 1):
        super().__init__("admission queue full")
        self.retry_after_s = retry_after_s


class EngineDraining(RuntimeError):
    def __init__(self, retry_after_s: int = 5):
        super().__init__("serve engine draining for shutdown")
        self.retry_after_s = retry_after_s


class EngineDown(RuntimeError):
    def __init__(self, msg: str, retry_after_s: int = 30):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


def _pow2_chunk(n: int, ctx: int) -> int:
    """Clamp the prefill chunk to a power of two in [16, ctx]."""
    n = max(16, min(int(n), ctx))
    b = 16
    while b * 2 <= n:
        b *= 2
    return b


class SlotPool:
    """Lowest-index-first slot allocator (scheduler thread only, except
    the counts, which are read for health)."""

    def __init__(self, n: int):
        self.n = n
        self._busy = [False] * n

    def alloc(self) -> int | None:
        for i, b in enumerate(self._busy):
            if not b:
                self._busy[i] = True
                return i
        return None

    def free(self, i: int) -> None:
        if not self._busy[i]:
            raise ValueError(f"slot {i} is not busy")
        self._busy[i] = False

    def busy(self) -> list[int]:
        return [i for i, b in enumerate(self._busy) if b]

    @property
    def busy_count(self) -> int:
        return sum(self._busy)

    @property
    def free_count(self) -> int:
        return self.n - self.busy_count


class AdmissionQueue:
    """Bounded FIFO shared by client threads and the scheduler."""

    def __init__(self, maxsize: int):
        self.maxsize = maxsize
        self._q: collections.deque = collections.deque()
        self._lock = threading.Lock()

    def put(self, item, allow_extra: int = 0) -> None:
        with self._lock:
            if len(self._q) >= self.maxsize + allow_extra:
                raise QueueFull(retry_after_s=max(1, len(self._q) // 8))
            self._q.append(item)

    def pop(self):
        with self._lock:
            return self._q.popleft() if self._q else None

    def purge(self, pred) -> list:
        with self._lock:
            keep, out = collections.deque(), []
            for item in self._q:
                (out if pred(item) else keep).append(item)
            self._q = keep
            return out

    def drain(self) -> list:
        return self.purge(lambda _: True)

    def depth(self) -> int:
        with self._lock:
            return len(self._q)


class _Prefill:
    """Scheduler-private state of one in-flight chunked admission."""

    __slots__ = ("req", "slot", "ids", "n", "pos", "chunks")

    def __init__(self, req: "ServeRequest", slot: int):
        self.req = req
        self.slot = slot
        self.ids = req.prompt_ids
        self.n = len(self.ids)
        self.pos = 0
        self.chunks = 0


class ServeRequest:
    """One submitted generation. The scheduler delivers Token objects,
    then DONE, to `out_q`, and fills `result` with tokens / stats /
    error. `cancel()` works from any thread."""

    DONE = object()

    def __init__(self, prompt_ids: list[int], max_new_tokens: int,
                 sampling: SamplingConfig | None,
                 request_id: str | None = None):
        self.id = request_id or "serve-" + uuid.uuid4().hex[:16]
        self.prompt_ids = list(prompt_ids)
        self.max_new_tokens = max_new_tokens
        self.sampling = sampling or SamplingConfig()
        self.out_q: queue_mod.Queue = queue_mod.Queue()
        self.cancelled = threading.Event()
        self.admitted = threading.Event()
        self.done = threading.Event()
        self.result: dict = {}
        self.tokens: list[int] = []
        self.stats: dict = {}
        self.t_enqueue = time.perf_counter()
        # scheduler-owned
        self.slot: int | None = None
        self.budget = 0                 # decode tokens left after the first
        self.t_first = 0.0
        self._first_pending = False     # first token sampled, not fetched
        self._engine: "ServeEngine | None" = None

    def cancel(self):
        self.cancelled.set()
        eng = self._engine
        if eng is not None:
            eng._wake.set()

    def wait(self, timeout: float | None = None) -> bool:
        return self.done.wait(timeout)

    def _deliver(self, item):           # scheduler thread
        self.out_q.put(item)


class ServeEngine:
    """Owns the slot pool, the admission queue and the scheduler thread."""

    def __init__(self, model, slots: int = DEFAULT_SLOTS,
                 max_queue: int = DEFAULT_QUEUE,
                 ctx_len: int | None = DEFAULT_CTX, seed: int = 0,
                 prefill_chunk: int = DEFAULT_CHUNK):
        self.model = model
        self.slots = slots
        self.ctx = min(ctx_len or DEFAULT_CTX, model.max_cache_len)
        self.chunk = _pow2_chunk(prefill_chunk, self.ctx)
        self.pool = SlotPool(slots)
        self.queue = AdmissionQueue(max_queue)
        self._seed = seed
        self._vocab = model.cfg.vocab_size
        self._init_device_state()
        self._reqs: list[ServeRequest | None] = [None] * slots
        self._prefills: list[_Prefill] = []
        self._rr = 0
        self._draining = threading.Event()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self.steps = 0
        self.last_step = time.perf_counter()
        self.dead: BaseException | None = None
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="cake-torch-serve")
        self._thread.start()

    def _init_device_state(self):
        """The KV pool and every per-slot carry live on the model's device
        and advance inside the batched decode step; the host writes them
        only at admission and release."""
        dev = self.model.device
        n = self.slots
        self._layers = self.model.new_cache(n, kv_len=self.ctx)["layers"]
        self._toks = torch.zeros(n, dtype=torch.int32, device=dev)
        self._pos = torch.zeros(n, dtype=torch.int32, device=dev)
        self._temps = torch.zeros(n, dtype=torch.float32, device=dev)
        self._top_ks = torch.full((n,), self._vocab, dtype=torch.int32,
                                  device=dev)
        self._top_ps = torch.ones(n, dtype=torch.float32, device=dev)
        self._pens = torch.ones(n, dtype=torch.float32, device=dev)
        self._recents = torch.full((n, RECENT_N), -1, dtype=torch.int32,
                                   device=dev)
        self._act = torch.zeros(n, dtype=torch.bool, device=dev)
        self._gen = torch.Generator(device=dev).manual_seed(self._seed)

    # -- client surface (any thread) ----------------------------------------

    def submit(self, prompt_ids: list[int], max_new_tokens: int = 256,
               sampling: SamplingConfig | None = None,
               request_id: str | None = None) -> ServeRequest:
        """Enqueue a generation. Raises QueueFull under backpressure,
        EngineDraining while shutting down, EngineDown when the scheduler
        died, ValueError for prompts a slot can never hold."""
        if self.dead is not None or not self._thread.is_alive():
            raise EngineDown(f"serve engine is down: {self.dead}")
        if self._draining.is_set():
            raise EngineDraining()
        n = len(prompt_ids)
        if n < 1:
            raise ValueError("empty prompt")
        if n > self.ctx - 2:
            raise ValueError(f"prompt length {n} exceeds the serve context "
                             f"({self.ctx} tokens per slot)")
        req = ServeRequest(prompt_ids, max_new_tokens, sampling, request_id)
        req._engine = self
        # free slots extend the bound: a burst that fits the idle pool is
        # admitted even though the scheduler drains one per iteration
        self.queue.put(req, allow_extra=self.pool.free_count)
        self._wake.set()
        return req

    def stream(self, req: ServeRequest):
        """Iterator over the request's Tokens (blocking). Closing it early
        cancels the request, freeing its slot. Raises the request's error,
        if any, after the last token."""
        try:
            while True:
                item = req.out_q.get()
                if item is ServeRequest.DONE:
                    break
                yield item
        finally:
            req.cancel()
        if "error" in req.result:
            raise req.result["error"]

    def health(self) -> dict:
        return {
            "alive": self.dead is None and self._thread.is_alive(),
            "slots": self.slots,
            "slots_busy": self.pool.busy_count,
            "queue_depth": self.queue.depth(),
            "ctx_len": self.ctx,
            "prefill_chunk": self.chunk,
            "prefilling": len(self._prefills),
            "draining": self._draining.is_set(),
            "steps": self.steps,
            "last_step_age_s": round(time.perf_counter() - self.last_step, 3),
        }

    def begin_drain(self) -> None:
        self._draining.set()
        self._wake.set()

    def drain(self, timeout: float | None = None) -> bool:
        """Stop admission and wait for busy slots and queued requests to
        finish. True when the engine went idle within the timeout."""
        self.begin_drain()
        deadline = None if timeout is None else time.perf_counter() + timeout
        while self.pool.busy_count or self.queue.depth():
            if self.dead is not None or not self._thread.is_alive():
                return False
            if deadline is not None and time.perf_counter() >= deadline:
                return False
            time.sleep(0.02)
        return True

    def close(self, timeout: float = 5.0):
        self._stop.set()
        self._wake.set()
        self._thread.join(timeout=timeout)
        for req in self.queue.drain():
            self._fail(req, EngineDown("serve engine shut down"))
        if self._thread.is_alive():
            # still inside a device call: release the waiters, touch no
            # scheduler state
            self.dead = self.dead or RuntimeError("shutdown timed out")
            for req in list(self._reqs):
                if req is not None:
                    self._fail(req, EngineDown("serve engine shut down"))
            return
        self._prefills.clear()
        for i, req in enumerate(self._reqs):
            if req is not None:
                self._finish(i, req, cancelled=True)

    # -- scheduler thread ---------------------------------------------------

    def _loop(self):
        try:
            while not self._stop.is_set():
                worked = self._step()
                self.last_step = time.perf_counter()
                if worked:
                    self.steps += 1
                else:
                    self._wake.wait(0.5)
                    self._wake.clear()
        except BaseException as e:      # terminal: release every waiter
            log.exception("serve engine died")
            self._die(e)
            if not isinstance(e, Exception):
                raise

    def _die(self, e: BaseException):
        self.dead = e
        self._prefills.clear()
        for req in self.queue.drain():
            self._fail(req, e)
        for i, req in enumerate(self._reqs):
            if req is not None:
                req.result.setdefault("error", e)
                self._finish(i, req, cancelled=True, release=False)

    def _step(self) -> bool:
        busy = self.pool.busy()
        if not (busy or self.queue.depth()):
            return False
        # 1. cancel sweeps
        prefilling = {p.slot for p in self._prefills}
        for i in busy:
            req = self._reqs[i]
            if req is not None and req.cancelled.is_set() \
                    and i not in prefilling:
                self._finish(i, req, cancelled=True)
        for pf in [p for p in self._prefills if p.req.cancelled.is_set()]:
            self._abort_prefill(pf, None)
        for req in self.queue.purge(lambda r: r.cancelled.is_set()):
            self._fail(req, None)
        # 2. admissions take free slots (cheap: the prefill is chunked)
        while self.pool.free_count > 0 and self._start_admission():
            pass
        if not (self.pool.busy_count or self.queue.depth()):
            return True
        # 3. one batched decode step over the pool
        pf_job = (self._prefills[self._rr % len(self._prefills)]
                  if self._prefills else None)
        prefilling = {p.slot for p in self._prefills}
        active = [i for i in self.pool.busy()
                  if self._reqs[i] is not None and i not in prefilling]
        packed = None
        if active:
            (packed, self._toks, self._pos,
             self._recents) = self.model.decode_slots(
                self._layers, self._toks, self._pos, self._recents,
                self._temps, self._top_ks, self._top_ps, self._pens,
                self._act, self._gen)
        # 4. advance the chosen admission by one chunk, queued on the
        # device behind the decode step
        if pf_job is not None:
            idx = self._prefills.index(pf_job)
            self._rr = idx + 1 if self._advance_prefill(pf_job) else idx
        # 5. one fetch per iteration, then fan out
        if packed is not None:
            self._fanout(active, packed.cpu().numpy())
        return True

    # -- chunked admission --------------------------------------------------

    def _start_admission(self) -> bool:
        while True:
            req = self.queue.pop()
            if req is None:
                return False
            if not req.cancelled.is_set():
                break
            self._fail(req, None)
        slot = self.pool.alloc()
        self._reqs[slot] = req
        req.slot = slot
        req.admitted.set()
        req.stats = {"queue_wait_s": time.perf_counter() - req.t_enqueue}
        self._prefills.append(_Prefill(req, slot))
        return True

    def _advance_prefill(self, pf: _Prefill) -> bool:
        """Prefill one chunk into the slot's row; on the last chunk sample
        the first token and activate the slot. True while in flight."""
        take = min(self.chunk, pf.n - pf.pos)
        try:
            logits, self._layers = self.model.prefill_chunk(
                self._layers, pf.slot, pf.ids[pf.pos:pf.pos + take], pf.pos)
        except ValueError as e:
            # a request-scoped refusal (bounds): the admission dies alone.
            # Anything else may have poisoned the pool and goes on up,
            # taking the engine down
            self._abort_prefill(pf, e)
            return False
        pf.pos += take
        pf.chunks += 1
        if pf.pos >= pf.n:
            self._complete_prefill(pf, logits)
            return False
        return True

    def _complete_prefill(self, pf: _Prefill, logits):
        """Sample the first token (it stays on the device and rides the
        next decode step's fetch) and hand the slot to batched decode."""
        req, slot, scfg = pf.req, pf.slot, pf.req.sampling
        dev = self.model.device
        recent = torch.full((1, RECENT_N), -1, dtype=torch.int32, device=dev)
        tid = self.model.sample_one(logits, self._gen, scfg, recent)
        self._recents[slot] = -1
        self._recents[slot, -1] = tid[0]
        self._toks[slot] = tid[0]
        self._pos[slot] = pf.n
        self._set_slot_sampling(slot, scfg)
        self._act[slot] = True
        self._prefills.remove(pf)
        req.budget = min(req.max_new_tokens - 1, self.ctx - pf.n - 1)
        req._first_pending = True
        req.stats["prefill_chunks"] = pf.chunks

    def _set_slot_sampling(self, slot: int, scfg: SamplingConfig):
        self._temps[slot] = scfg.temperature
        self._top_ks[slot] = scfg.top_k or self._vocab
        self._top_ps[slot] = 1.0 if scfg.top_p is None else scfg.top_p
        self._pens[slot] = scfg.repeat_penalty

    def _abort_prefill(self, pf: _Prefill, error: BaseException | None):
        self._prefills.remove(pf)
        self._reqs[pf.slot] = None
        self.pool.free(pf.slot)
        self._fail(pf.req, error)
        self._release_row(pf.slot)

    def _release_row(self, slot: int):
        self._layers = self.model.slot_release(self._layers, slot)

    # -- batched decode fan-out ---------------------------------------------

    def _fanout(self, active: list[int], arr):
        """Row 0 of the packed ids is each slot's input token (a newly
        activated slot's unemitted first token), row 1 the sampled one."""
        for i in active:
            req = self._reqs[i]
            if req._first_pending:
                req._first_pending = False
                req.t_first = time.perf_counter()
                req.stats["ttft_s"] = req.t_first - req.t_enqueue
                first = int(arr[0, i])
                self._emit(req, first)
                if self.model.cfg.is_eos(first) or req.budget <= 0:
                    self._finish(i, req)
                    continue
            tid = int(arr[1, i])
            req.budget -= 1
            self._emit(req, tid)
            if self.model.cfg.is_eos(tid) or req.budget <= 0:
                self._finish(i, req)

    def _emit(self, req: ServeRequest, tid: int):
        req.tokens.append(tid)
        if not req.cancelled.is_set():
            req._deliver(self.model.mk_token(tid))

    def _finish(self, slot: int, req: ServeRequest, cancelled: bool = False,
                release: bool = True):
        self.pool.free(slot)
        self._reqs[slot] = None
        if release:
            # wipe the row so nothing lingers into the next occupant, and
            # freeze it in the decode step
            self._release_row(slot)
            self._toks[slot] = 0
            self._pos[slot] = 0
            self._act[slot] = False
        dt = time.perf_counter() - req.t_first if req.t_first else 0.0
        ndec = max(len(req.tokens) - 1, 0)
        req.stats.update({"decode_tokens": ndec, "decode_s": dt,
                          "tok_per_s": ndec / dt if dt > 0 and ndec else 0.0})
        req.result["tokens"] = req.tokens
        req.result["stats"] = req.stats
        if cancelled and "error" not in req.result:
            req.result["cancelled"] = True
        req._deliver(ServeRequest.DONE)
        req.done.set()

    def _fail(self, req: ServeRequest, error: BaseException | None):
        if error is not None:
            req.result["error"] = error
        req.result.setdefault("tokens", req.tokens)
        req.result.setdefault("stats", req.stats)
        req._deliver(ServeRequest.DONE)
        req.done.set()
