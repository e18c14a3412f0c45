"""Continuous-batching serve engine (the core of
cake_tpu/serve/engine.py: ServeEngine, ServeRequest, chunked admission,
the shared-prefix cache, paged KV and swap preemption).

A bounded admission queue feeds one scheduler thread that owns the KV
(a contiguous pool of rows, "slots", or a paged block pool behind
per-slot tables) and every device tensor. Each iteration:

  1. sweeps cancelled requests (decoding, mid-prefill, queued);
  2. resumes preempted requests first (oldest first), then moves queued
     requests into free slots as chunked admissions, splicing any cached
     shared prefix so only the suffix is prefilled;
  3. picks the admission to advance (round-robin) and, in paged mode,
     reserves its chunk's blocks and then every decoding slot's write
     block, preempting a victim when the pool is exhausted. All of it
     comes BEFORE the decode dispatch: a swap-out after the dispatch would
     capture carries holding a sampled token the host never fanned out;
  4. dispatches ONE batched decode step over the pool (rows whose prefill
     has completed are `active`; the others ride along frozen): on a card
     a replay of the step's CUDA graph, captured once when the scheduler
     thread starts (models/common/graphs.py), on the CPU the eager step;
  5. advances the chosen admission by one chunk, capturing every prefix
     block the chunk completed;
  6. fetches the step's packed token ids (the graph's static `packed`
     buffer) in one device-to-host copy and fans them out to the request
     streams.

Every torch call happens on the scheduler thread, so the device state
needs no lock; client threads only touch thread-safe queues and events.
The graph reads the KV and the per-slot carries (graphs.DecodeCarries) at
fixed addresses, so everything between two replays writes them in place
and nothing rebinds them. There is no fallback: a capture error fails the
constructor, a replay error kills the engine.

Sampling: each admission gets its own key, request_key(seed, seq) (the
reference's fold_in(base, seq)), and draws its noise from (key, counter)
on the device. The first token takes counter 0; each decode step of an
active row advances the row's counter. Key and counter are per-slot
carries that ride a swap, so a sampled request's tokens depend neither
on its company nor on a swap.
Left out of this port so far (see ROADMAP.md): recompute preemption (it
needs the crash-recovery supervisor's replay), speculative decoding, the
supervisor itself, QoS lanes and victim classes, deadlines, the fleet KV
tier and the metrics plane. A failure on the scheduler thread fails every
request and marks the engine dead.
"""
from __future__ import annotations

import collections
import logging
import queue as queue_mod
import threading
import time
import uuid

import torch

from ..models.common.graphs import DecodeCarries, DecodeGraph
from ..ops.sampling import SamplingConfig, request_key
from .paged.pool import KVPoolExhausted, PagedKV
from .paged.preempt import PreemptedSlot, choose_victim, victim_rank
from .prefix_cache import PagedPrefixCache, PrefixCache

log = logging.getLogger("cake_tpu_torch.serve")

RECENT_N = SamplingConfig().repeat_last_n
DEFAULT_SLOTS = 4
DEFAULT_CTX = 4096
DEFAULT_CHUNK = 256
DEFAULT_QUEUE = 64
DEFAULT_PREFIX_CACHE_MB = 256.0     # the reference's CAKE_PREFIX_CACHE_MB
DEFAULT_KV_BLOCK_TOKENS = 16        # the reference's CAKE_KV_BLOCK_TOKENS


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

    __slots__ = ("req", "slot", "ids", "n", "pos", "chunks", "keys",
                 "next_block", "hit_tokens")

    def __init__(self, req: "ServeRequest", slot: int):
        self.req = req
        self.slot = slot
        self.ids = req.prompt_ids
        self.n = len(self.ids)
        self.pos = 0
        self.chunks = 0
        self.keys: list[bytes] = []     # prefix-cache chain keys
        self.next_block = 0             # next prefix block to capture
        self.hit_tokens = 0             # prompt tokens spliced from cache


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
        self.key = 0                    # sampling key, set at admission
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
                 prefill_chunk: int = DEFAULT_CHUNK,
                 prefix_cache_mb: float = DEFAULT_PREFIX_CACHE_MB,
                 kv_blocks: int = 0,
                 kv_block_tokens: int = DEFAULT_KV_BLOCK_TOKENS,
                 preempt_mode: str = "swap"):
        """kv_blocks > 0 replaces the contiguous pool (slots x ctx rows)
        with a shared pool of that many blocks of kv_block_tokens tokens;
        prefix_cache_mb <= 0 turns the shared-prefix cache off. The one
        preemption mode is "swap"."""
        if preempt_mode != "swap":
            raise ValueError(
                f"preempt_mode must be 'swap', got {preempt_mode!r} "
                "(recompute preemption needs the crash-recovery "
                "supervisor's replay, which is not ported yet)")
        self.model = model
        self.slots = slots
        self.ctx = min(ctx_len or DEFAULT_CTX, model.max_cache_len)
        self.chunk = _pow2_chunk(prefill_chunk, self.ctx)
        self.kv_blocks = max(int(kv_blocks), 0)
        self.kv_block_tokens = kv_block_tokens
        self.preempt_mode = preempt_mode
        self.pool = SlotPool(slots)
        self.queue = AdmissionQueue(max_queue)
        self._seed = seed
        self._vocab = model.cfg.vocab_size
        self.paged: PagedKV | None = None
        self._init_device_state()
        self.prefix_cache = self._build_prefix_cache(prefix_cache_mb)
        self._reqs: list[ServeRequest | None] = [None] * slots
        self._prefills: list[_Prefill] = []
        self._preempted: list[PreemptedSlot] = []
        self._rr = 0
        self._draining = threading.Event()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self.steps = 0
        self.last_step = time.perf_counter()
        self.dead: BaseException | None = None
        self.graph = None               # the decode step's DecodeGraph
        self._ready = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="cake-torch-serve")
        self._thread.start()
        self._ready.wait()
        if self.dead is not None:
            self._thread.join()
            raise self.dead

    def _init_device_state(self):
        """The KV (contiguous rows, or a PagedKV) and every per-slot carry
        live on the model's device and advance inside the batched decode
        step; the host writes them only at admission, preemption and
        release."""
        dev = self.model.device
        n = self.slots
        if self.kv_blocks > 0:
            self.paged = PagedKV.build(self.model, n, self.ctx,
                                       self.kv_blocks, self.kv_block_tokens,
                                       self.chunk)
            self._layers = None
        else:
            self._layers = self.model.new_cache(n, kv_len=self.ctx)["layers"]
        self.carries = DecodeCarries.build(n, self._vocab, RECENT_N, dev)
        self._seq = 0                   # admissions so far: the key index

    def _decode_fn(self):
        """The in-place decode step over the pool that the graph captures."""
        model, c, paged = self.model, self.carries, self.paged
        if paged is not None:
            return lambda: model.decode_slots_paged_into(
                paged.pool, paged.rows, paged.tables, c)
        layers = self._layers
        return lambda: model.decode_slots_into(layers, c)

    def _build_prefix_cache(self, capacity_mb: float):
        """Mode-matched prefix cache: the paged one pins pool blocks by
        refcount (a hit is a table remap, no KV copy) and is the
        allocator's under-pressure evictor; the contiguous one keeps
        private block copies."""
        if self.paged is not None:
            pc = PagedPrefixCache.build_paged(self.model, self.paged,
                                              self.chunk, capacity_mb)
            self.paged.evictor = pc.evict_for_pressure if pc else None
            return pc
        return PrefixCache.build(self.model, self.ctx, self.chunk,
                                 capacity_mb)

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
        paged = self.paged
        if paged is not None and paged.blocks_for(n + 1) > paged.num_blocks:
            raise ValueError(f"prompt needs {paged.blocks_for(n + 1)} KV "
                             f"blocks but the pool holds {paged.num_blocks} "
                             f"(kv_blocks x kv_block_tokens tokens in all)")
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
        h = {
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
        pc = self.prefix_cache
        if pc is not None:
            h["prefix_cache"] = pc.occupancy()
        paged = self.paged
        if paged is not None:
            live = {}
            for i in self.pool.busy():
                req = self._reqs[i]
                if req is not None:
                    live[i] = len(req.prompt_ids) \
                        + max(len(req.tokens) - 1, 0)
            h["kv_pool"] = {**paged.occupancy(live),
                            "preempted_slots": len(self._preempted)}
            if pc is not None:
                h["kv_pool"]["prefix_entries"] = len(pc._blocks)
                h["kv_pool"]["prefix_pinned_blocks"] = pc.pinned
        return h

    def begin_drain(self) -> None:
        self._draining.set()
        self._wake.set()

    def drain(self, timeout: float | None = None) -> bool:
        """Stop admission and wait for busy slots and queued requests to
        finish. True when the engine went idle within the timeout."""
        self.begin_drain()
        deadline = None if timeout is None else time.perf_counter() + timeout
        while self.pool.busy_count or self.queue.depth() or self._preempted:
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
            for req in list(self._reqs) + [e.req for e in
                                           list(self._preempted)]:
                if req is not None:
                    self._fail(req, EngineDown("serve engine shut down"))
            return
        self._prefills.clear()
        while self._preempted:
            self._fail(self._preempted.pop(0).req,
                       EngineDown("serve engine shut down"))
        for i, req in enumerate(self._reqs):
            if req is not None:
                self._finish(i, req, cancelled=True)

    # -- scheduler thread ---------------------------------------------------

    def _loop(self):
        try:
            # captured with every row inactive (nothing admitted yet)
            self.graph = DecodeGraph(self._decode_fn(), self.model.device)
        except BaseException as e:
            log.exception("serve engine failed to capture its decode step")
            self.dead = e
            return
        finally:
            self._ready.set()
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
        while self._preempted:
            self._fail(self._preempted.pop(0).req, e)
        for i, req in enumerate(self._reqs):
            if req is not None:
                req.result.setdefault("error", e)
                self._finish(i, req, cancelled=True, release=False)

    def _step(self) -> bool:
        busy = self.pool.busy()
        if not (busy or self.queue.depth() or self._preempted):
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
        for entry in [e for e in self._preempted
                      if e.req.cancelled.is_set()]:
            self._preempted.remove(entry)
            self._fail(entry.req, None)
        for req in self.queue.purge(lambda r: r.cancelled.is_set()):
            self._fail(req, None)
        # 2. preempted requests resume first (their clients are mid-
        # stream), then admissions take free slots (cheap: at most a
        # prefix splice; the prefill itself is chunked)
        if self._preempted:
            self._resume_preempted()
        while self.pool.free_count > 0 and self._start_admission():
            pass
        if not (self.pool.busy_count or self.queue.depth()):
            # only parked entries that cannot resume yet: report idle so
            # the loop waits (its 0.5 s heartbeat retries the resume)
            return False
        # 3. choose the admission to advance and, in paged mode, reserve
        # its chunk's blocks and then the decoding slots' write blocks,
        # all BEFORE the decode dispatch (see the module docstring)
        pf_job = (self._prefills[self._rr % len(self._prefills)]
                  if self._prefills else None)
        if pf_job is not None and self.paged is not None:
            pf_job = self._prepare_prefill(pf_job)
        prefilling = {p.slot for p in self._prefills}
        active = [i for i in self.pool.busy()
                  if self._reqs[i] is not None and i not in prefilling]
        if self.paged is not None and active:
            active = self._ensure_decode_blocks(active)
        # 4. one batched decode step over the pool
        if active:
            self.graph.step()
        # 5. advance the chosen admission by one chunk, queued on the
        # device behind the decode step (a preemption in 3 may have
        # requeued it since)
        if pf_job is not None and pf_job in self._prefills:
            idx = self._prefills.index(pf_job)
            self._rr = idx + 1 if self._advance_prefill(pf_job) else idx
        # 6. one fetch per iteration, then fan out
        if active:
            self._fanout(active, self.carries.packed.cpu().numpy())
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
        req.key = request_key(self._seed, self._seq)
        self._seq += 1
        self._begin_prefill(_Prefill(req, slot))
        return True

    def _begin_prefill(self, pf: _Prefill) -> None:
        """Splice any cached shared prefix into the slot, then put the
        admission in flight."""
        pc = self.prefix_cache
        if pc is not None:
            pf.keys = pc.chain_keys(pf.ids)
            matched = pc.match(pf.ids, pf.keys)
            if matched:
                pc.splice(self._layers, pf.slot, pf.keys, matched)
                pf.next_block = matched
                pf.pos = pf.hit_tokens = matched * self.chunk
        self._prefills.append(pf)

    def _advance_prefill(self, pf: _Prefill) -> bool:
        """Prefill one chunk into the slot's row (or its blocks), capture
        every prefix block the chunk completed, and on the last chunk
        sample the first token and activate the slot. True while in
        flight."""
        take = min(self.chunk, pf.n - pf.pos)
        ids = pf.ids[pf.pos:pf.pos + take]
        try:
            if self.paged is not None:
                logits = self.paged.prefill_into(pf.slot, ids, pf.pos)
            else:
                logits, _ = self.model.prefill_chunk(self._layers, pf.slot,
                                                     ids, pf.pos)
        except ValueError as e:
            # a request-scoped refusal (bounds): the admission dies alone.
            # Anything else may have poisoned the pool and goes on up,
            # taking the engine down
            self._abort_prefill(pf, e)
            return False
        pf.pos += take
        pf.chunks += 1
        self._capture_blocks(pf)
        if pf.pos >= pf.n:
            self._complete_prefill(pf, logits)
            return False
        return True

    def _capture_blocks(self, pf: _Prefill) -> None:
        """Insert every prefix block the chunk that just landed completed,
        at the boundary where the row holds exactly that prefix. The block
        holding the final prompt token is never cached (its logits must be
        computed live), hence the n-1 cap."""
        pc = self.prefix_cache
        if pc is None:
            return
        while (pf.next_block + 1) * self.chunk <= min(pf.pos, pf.n - 1):
            pc.insert(self._layers, pf.slot, pf.ids, pf.next_block, pf.keys)
            pf.next_block += 1

    def _complete_prefill(self, pf: _Prefill, logits):
        """Sample the first token with draw 0 of the request's key (it
        stays on the device and rides the next decode step's fetch) and
        hand the slot to batched decode with its counter at 1."""
        req, slot, scfg = pf.req, pf.slot, pf.req.sampling
        c = self.carries
        recent = torch.full((1, RECENT_N), -1, dtype=torch.int32,
                            device=self.model.device)
        tid = self.model.sample_one(logits, req.key, 0, scfg, recent)
        c.recents[slot] = -1
        c.recents[slot, -1] = tid[0]
        c.toks[slot] = tid[0]
        c.pos[slot] = pf.n
        c.keys[slot] = req.key
        c.counters[slot] = 1
        self._set_slot_sampling(slot, scfg)
        c.active[slot] = True
        self._prefills.remove(pf)
        req.budget = min(req.max_new_tokens - 1, self.ctx - pf.n - 1)
        req._first_pending = True
        req.stats["prefill_chunks"] = pf.chunks
        req.stats["prefix_hit_tokens"] = pf.hit_tokens

    def _set_slot_sampling(self, slot: int, scfg: SamplingConfig):
        self.carries.set_sampling(
            slot, scfg.temperature, scfg.top_k or self._vocab,
            1.0 if scfg.top_p is None else scfg.top_p, scfg.repeat_penalty)

    def _abort_prefill(self, pf: _Prefill, error: BaseException | None):
        self._prefills.remove(pf)
        self._reqs[pf.slot] = None
        self.pool.free(pf.slot)
        self._fail(pf.req, error)
        self._release_row(pf.slot)

    def _release_row(self, slot: int):
        """Contiguous: wipe the pool row. Paged: deref the slot's blocks
        (shared ones survive under the prefix cache or other slots)."""
        if self.paged is not None:
            self.paged.release_slot(slot)
        else:
            self.model.slot_release(self._layers, slot)

    # -- paged-pool pressure: reserve / preempt / resume --------------------

    @staticmethod
    def _frontier(req: ServeRequest) -> int:
        """Tokens in a decoding request's KV at the start of an iteration
        (also its next write position): the prompt and every emitted
        token but the last, whose entry the next decode step writes."""
        return len(req.prompt_ids) + max(len(req.tokens) - 1, 0)

    def _prepare_prefill(self, pf: _Prefill) -> _Prefill | None:
        """Reserve the blocks pf's next chunk writes. None when the
        admission was failed: with every other occupant preempted or
        requeued the pool still cannot hold the chunk."""
        take = min(self.chunk, pf.n - pf.pos)
        if self._reserve_blocks(pf.slot, pf.pos, take):
            return pf
        self._abort_prefill(pf, KVPoolExhausted(
            f"KV pool exhausted admitting {pf.req.id}: the prompt needs "
            "more blocks than the pool can ever free"))
        return None

    def _reserve_blocks(self, slot: int, pos0: int, n: int) -> bool:
        """Back positions [pos0, pos0 + n) of `slot` with blocks, evicting
        prefix-cache LRU (inside the pool) and then preempting victims
        until it fits. False = nothing left to reclaim."""
        while not self.paged.reserve_range(slot, pos0, n):
            if not self._preempt_one(exclude=slot):
                return False
        return True

    def _ensure_decode_blocks(self, active: list[int]) -> list[int]:
        """Back every decoding slot's write block before the dispatch.
        Exhaustion evicts prefix-cache LRU, then preempts a victim; a slot
        that cannot grow with nothing left to reclaim fails typed. Returns
        the surviving active list."""
        for i in active:
            req = self._reqs[i]
            if req is None:
                continue        # preempted by an earlier slot's ensure
            wp = self._frontier(req)
            if not self._reserve_blocks(i, wp, 1):
                req.result["error"] = KVPoolExhausted(
                    f"KV pool exhausted: request {req.id} cannot grow "
                    f"past {wp} tokens and nothing is left to reclaim")
                self._finish(i, req, cancelled=True)
        return [i for i in active if self._reqs[i] is not None]

    def _preempt_one(self, exclude: int) -> bool:
        """Free blocks: preempt a decoding victim (the latest admission,
        victim_rank), else send another in-flight admission back for a
        clean restart (it has emitted nothing). False = nothing left."""
        prefilling = {p.slot for p in self._prefills}
        cands = [(i, self._reqs[i]) for i in self.pool.busy()
                 if i not in prefilling]
        victim = choose_victim(cands, exclude=exclude)
        if victim is not None:
            self._preempt_slot(*victim)
            return True
        others = [p for p in self._prefills if p.slot != exclude]
        if others:
            self._requeue_admission(max(others,
                                        key=lambda p: victim_rank(p.req)))
            return True
        return False

    def _preempt_slot(self, slot: int, req: ServeRequest):
        """Swap one decoding slot out: its blocks and carries go to host
        memory and its blocks are freed. Runs before the iteration's
        decode dispatch, so the carries hold no unfetched token, and an
        unfetched first token (`_first_pending`) rides `toks` back in."""
        wp = self._frontier(req)
        c = self.carries
        blob = self.paged.swap_out(slot, (c.toks, c.pos, c.recents, c.keys,
                                          c.counters))
        self.pool.free(slot)
        self._reqs[slot] = None
        req.slot = None
        c.active[slot] = False
        c.toks[slot] = 0
        c.pos[slot] = 0
        self._preempted.append(PreemptedSlot(req, "swap", wp, blob))
        log.warning("preempted slot %d (swap, %d tokens): KV pool "
                    "exhausted", slot, wp)

    def _requeue_admission(self, pf: _Prefill):
        """Send a mid-prefill admission back to readmission to free its
        blocks (a clean restart, ahead of every queued request). Its
        resume gate is the whole prompt's blocks."""
        self._prefills.remove(pf)
        self.paged.release_slot(pf.slot)
        self.pool.free(pf.slot)
        self._reqs[pf.slot] = None
        pf.req.slot = None
        self._preempted.append(PreemptedSlot(pf.req, "requeue",
                                             max(pf.n - 1, 0)))
        log.warning("readmitting request %s: KV pool exhausted "
                    "mid-prefill", pf.req.id)

    def _resume_preempted(self):
        """Oldest-first resume: a swap entry gets fresh blocks and its
        bytes and carries back; a requeued admission restarts its prefill
        once its whole prompt's blocks are free. Stops at the first entry
        that does not fit yet (strict FIFO: a big parked request is not
        starved by smaller ones behind it)."""
        while self._preempted and self.pool.free_count > 0:
            entry = self._preempted[0]
            req = entry.req
            if entry.mode == "swap":
                slot = self.pool.alloc()
                if not self.paged.swap_in(slot, entry.blob):
                    self.pool.free(slot)
                    self._fail_unresumable(entry)
                    return
                self._preempted.pop(0)
                toks, pos, recents, keys, counters = entry.blob["carries"]
                c = self.carries
                c.toks[slot] = int(toks)
                c.pos[slot] = int(pos)
                c.recents[slot] = recents.to(c.recents.device)
                c.keys[slot] = int(keys)
                c.counters[slot] = int(counters)
                self._set_slot_sampling(slot, req.sampling)
                c.active[slot] = True
                self._reqs[slot] = req
                req.slot = slot
            else:
                if not self.paged.ensure_free(
                        self.paged.blocks_for(entry.tokens_at_preempt + 1)):
                    self._fail_unresumable(entry)
                    return
                slot = self.pool.alloc()
                self._preempted.pop(0)
                self._reqs[slot] = req
                req.slot = slot
                self._begin_prefill(_Prefill(req, slot))
            log.warning("resumed preempted request %s into slot %d (%s)",
                        req.id, slot, entry.mode)

    def _fail_unresumable(self, entry: PreemptedSlot):
        """A parked entry whose resume gate failed waits while live work
        still holds blocks. With nothing running and the cache drained by
        the gate, no block can ever free, so it fails typed instead of
        hanging its client."""
        if self.pool.busy_count or self.queue.depth():
            return
        self._preempted.remove(entry)
        self._fail(entry.req, KVPoolExhausted(
            f"KV pool exhausted: preempted request {entry.req.id} needs "
            "more blocks than the pool can ever free"))

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
            c = self.carries
            c.toks[slot] = 0
            c.pos[slot] = 0
            c.active[slot] = False
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
