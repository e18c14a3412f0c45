"""Continuous-batching serve engine (the core of
cake_tpu/serve/engine.py: ServeEngine, ServeRequest, chunked admission,
the shared-prefix cache, paged KV, swap and recompute preemption, QoS
lanes and victim classes, queue and request deadlines, the metrics
plane's spans, timelines and instruments, and speculative decoding).

A bounded, class-aware admission queue (admission/queue.py: one lane per
QoS class, weighted-fair dequeue) feeds one scheduler thread that owns
the KV (a contiguous pool of rows, "slots", or a paged block pool behind
per-slot tables) and every device tensor. Each iteration:

  1. sweeps cancelled requests (decoding, mid-prefill, parked, queued),
     then the queue deadline (a request queued past `queue_deadline_s`
     fails with QueueDeadlineExceeded, 503) and the request deadline (an
     admitted or parked request older than `request_deadline_s` fails
     with RequestDeadlineExceeded, 504, and frees its slot);
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
     thread starts (models/common/graphs.py), on the CPU the eager step.
     With a drafter, when it proposed for any slot, the step is a batched
     speculative verify instead (below);
  5. advances the chosen admission by one chunk, capturing every prefix
     block the chunk completed: on a card a replay of the chunk's
     captured prefill program, one CUDA graph per (bucket, flash mode)
     (graphs.PrefillGraphs), on the CPU the same program run eagerly;
  6. fetches the step's packed token ids (the graph's static `packed`
     buffer) in one device-to-host copy and fans them out to the request
     streams.

Every torch call happens on the scheduler thread, so the device state
needs no lock; client threads only touch thread-safe queues and events.
The graphs read the KV, the per-slot carries (graphs.DecodeCarries) and
the prefill buffers (graphs.PrefillIO) at fixed addresses, so everything
between two replays writes them in place and nothing rebinds them. The
decode graph and the prefill programs the engine can reach are captured
when the scheduler thread starts; a prefill program past the buffer's end
is captured at its first use. There is no fallback to an eager prefill
or step on a card: a capture error at start fails the constructor; any
later failure (a capture at first use, a replay, the fetch) goes to the
supervisor.

The engine is crash-only (supervisor.py owns the policy, the reference's
cake_tpu/serve/supervisor.py): a step failure is classified, the device
state is reset IN PLACE (every captured graph keeps its addresses), and
`_rebuild` replays every live slot's prompt + generated tokens through
the captured prefill programs; a greedy continuation is bit-identical.
A request implicated in two consecutive crashes is quarantined and fails
alone (PoisonedRequest). Rebuilds are budgeted; past the budget the
engine goes DOWN (EngineDown, 503 + Retry-After) and a restore loop
probes the device with a trial chunk until one succeeds. A watchdog
flags a dispatch stuck past `step_watchdog_s` as wedged. A sticky CUDA
error (an illegal address) leaves the process's CUDA context unusable:
every rebuild and probe after it fails, and the engine stays DOWN until
the process restarts. `dead` is reached only when the supervisor itself
fails.

Sampling: each admission gets its own key, request_key(seed, seq) (the
reference's fold_in(base, seq)), and draws its noise from (key, counter)
on the device. The first token takes counter 0; each decode step of an
active row advances the row's counter. Key and counter are per-slot
carries that ride a swap, so a sampled request's tokens depend neither
on its company nor on a swap.

Preemption (paged pool exhausted) takes the lowest QoS class first, the
latest admission within a class (paged/preempt.py); an admission or a
decoding slot that could only make room by evicting higher-class work
parks itself instead ("self": a mid-prefill admission is requeued for a
clean restart, a decoding slot is preempted). "swap" keeps the victim's
blocks and
carries in host memory; "recompute" drops them and, at resume, replays
prompt + tokens[:-1] through the prefill programs (`_replay_slot`, the
reference's): a greedy stream resumes bit for bit, a sampled one on a
fresh key, request_key(seed, seq) with the next seq, as the reference
documents. A mid-prefill admission is requeued for a clean restart
either way (labelled "recompute", as the reference labels it).

Speculative decoding (`spec`, the reference's CAKE_SPEC; module 9): a
shareable drafter ("ngram") proposes up to `spec_k` tokens per decoding
slot from the slot's own history on the host (`_build_drafts`), and the
iteration replays the captured verify graph (one per `filt`: whether any
active slot filters its vocabulary) in place of the decode step: every
slot's window in one dispatch, acceptance ragged per slot, a slot with
no window taking a plain decode step inside it. Its fetch brings
[input token ; accepted drafts ; next token] per slot (`_fanout_spec`
emits the accepted drafts and the next token, stopping at EOS, the
budget or a stop inside the accepted prefix). In a paged pool each
speculating slot reserves blocks for its whole window first; under
pressure the window degrades to a plain step, other slots' speculative
tails are trimmed before any victim is preempted (`_trim_spec_tails`),
and a swapped-out victim carries only committed blocks. The verify is
supervised as the decode step is.

Observability (obs/): the spans `serve.step`, `serve.prefill_chunk`,
`serve.replay` and `spec.verify`, each request's timeline (enqueue,
admit, prefix_hit, prefill_chunk, prefill_done, first_token, decode,
spec_verify, preempt, resume, replay, finish or error) and the SERVE_*
and SPEC_* instruments are recorded at the reference's points from host
values the iteration already has. Nothing is recorded inside a capture
and nothing waits on the card: a span over device work ends at the
iteration's one fetch (`_close_spans`).

The fleet-shared KV tier (fleet/kvshare/replica.py: KVShareReplica) rides
an engine as `kv_share` (duck-typed: this package imports nothing of the
fleet). Its mailbox is drained by `run_pending()` at the top of every
`_step`, before the idle return, so that blob export, import, parking
and adoption run on the scheduler thread, where the pool and the prefix
cache live; `health()` carries its `kvshare` block, and a migrated stream
it adopts enters through the swap resume (`_resume_preempted`).
"""
from __future__ import annotations

import gc
import logging
import os
import queue as queue_mod
import threading
import time
import uuid

import numpy as np
import torch

from ..models.common.cache import kv_capacity, reset_layers
from ..models.common.graphs import DecodeCarries, DecodeGraph, SpecCarries
from ..models.common.text_model import prefill_start_keys
from ..obs import (RECORDER, SERVE_BATCH_OCCUPANCY, SERVE_E2E_SECONDS,
                   SERVE_ITL_SECONDS, SERVE_POISONED, SERVE_PREEMPTIONS,
                   SERVE_PREFILL_CHUNKS, SERVE_QOS_E2E_SECONDS,
                   SERVE_QOS_TTFT_SECONDS, SERVE_QUEUE_TIMEOUTS,
                   SERVE_QUEUE_WAIT_SECONDS, SERVE_REQUEST_TIMEOUTS,
                   SERVE_SLOTS_BUSY, SERVE_TTFT_SECONDS, TIMELINES, now,
                   now_us, observe_generation)
from ..ops.sampling import SamplingConfig, config_has_filters, request_key
from ..spec import resolve_drafter, spec_knobs
from ..spec.verify import record_step
from . import faults
from .admission import AdmissionQueue, QueueFull
from .admission.classes import class_of, priority
from .flight import FlightRecorder
from .paged.pool import KVPoolExhausted, PagedKV
from .paged.preempt import PreemptedSlot, choose_victim, victim_rank
from .prefix_cache import PagedPrefixCache, PrefixCache
from .supervisor import (DEFAULT_REBUILD_BUDGET, DEFAULT_REBUILD_WINDOW_S,
                         DEFAULT_RESTORE_INTERVAL_S, DEFAULT_STEP_WATCHDOG_S,
                         EngineDown, PoisonedRequest, RequestDeadlineExceeded,
                         Supervisor)

log = logging.getLogger("cake_tpu_torch.serve")

RECENT_N = SamplingConfig().repeat_last_n
DEFAULT_SLOTS = 4
DEFAULT_CTX = 4096
DEFAULT_CHUNK = 256
DEFAULT_QUEUE = 64
DEFAULT_PREFIX_CACHE_MB = 256.0     # the reference's CAKE_PREFIX_CACHE_MB
DEFAULT_KV_BLOCK_TOKENS = 16        # the reference's CAKE_KV_BLOCK_TOKENS
PREEMPT_MODES = ("swap", "recompute")   # the reference's CAKE_PREEMPT_MODE
# the reference's CAKE_QUEUE_DEADLINE_S and CAKE_REQUEST_DEADLINE_S
# defaults: 0 turns the sweep off
DEFAULT_QUEUE_DEADLINE_S = 0.0
DEFAULT_REQUEST_DEADLINE_S = 0.0
# a client's wait on the engine wakes this often to check that the
# scheduler thread still runs; the start waits at most START_TIMEOUT_S
POLL_S = 0.5
START_TIMEOUT_S = 900.0

__all__ = ["ENGINE_KNOBS", "EngineDown", "EngineDraining",
           "KVPoolExhausted", "PoisonedRequest", "QueueDeadlineExceeded",
           "QueueFull", "RequestDeadlineExceeded", "ServeEngine",
           "ServeRequest", "SlotPool", "engine_knobs", "maybe_engine"]


class EngineDraining(RuntimeError):
    def __init__(self, retry_after_s: int = 5):
        super().__init__("serve engine draining for shutdown")
        self.retry_after_s = retry_after_s


class QueueDeadlineExceeded(RuntimeError):
    """The request sat in the admission queue past the queue deadline
    (CAKE_QUEUE_DEADLINE_S): it is finished with 503 instead of eventually
    occupying a slot for a client that already gave up."""

    def __init__(self, waited_s: float, retry_after_s: int = 1):
        super().__init__(
            f"request expired in admission queue after {waited_s:.1f}s")
        self.waited_s = waited_s
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
                 request_id: str | None = None, qos: str = "interactive",
                 tenant: str | None = None):
        self.id = request_id or "serve-" + uuid.uuid4().hex[:16]
        self.prompt_ids = list(prompt_ids)
        self.max_new_tokens = max_new_tokens
        self.sampling = sampling or SamplingConfig()
        # QoS class (admission lane, weighted-fair share, preemption
        # rank) and tenant (quota accounting, timeline attribution)
        self.qos = qos
        self.tenant = tenant
        self.out_q: queue_mod.Queue = queue_mod.Queue()
        self.cancelled = threading.Event()
        self.admitted = threading.Event()
        self.done = threading.Event()
        self.result: dict = {}
        self.tokens: list[int] = []
        self.stats: dict = {}
        self.t_enqueue = now()
        # scheduler-owned
        self.slot: int | None = None
        self.key = 0                    # sampling key, set at admission
        self.budget = 0                 # decode tokens left after the first
        self.t_first = 0.0
        self._first_pending = False     # first token sampled, not fetched
        # a client reads the stream as it is produced (ServeEngine.stream
        # runs): the KV-share tier's drain parks only such requests
        self.streaming = False
        # an adopted stream blob: the generated tokens it carried, which
        # the answer replays before the ones decoded here
        self.replayed = 0
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
                 preempt_mode: str = "swap",
                 step_watchdog_s: float = DEFAULT_STEP_WATCHDOG_S,
                 rebuild_budget: int = DEFAULT_REBUILD_BUDGET,
                 rebuild_window_s: float = DEFAULT_REBUILD_WINDOW_S,
                 restore_interval_s: float = DEFAULT_RESTORE_INTERVAL_S,
                 queue_deadline_s: float = DEFAULT_QUEUE_DEADLINE_S,
                 request_deadline_s: float = DEFAULT_REQUEST_DEADLINE_S,
                 qos_weights: dict | None = None,
                 qos_bounds: dict | None = None,
                 spec=None, spec_k: int | None = None,
                 spec_reserve: int | None = None):
        """kv_blocks > 0 replaces the contiguous pool (slots x ctx rows)
        with a shared pool of that many blocks of kv_block_tokens tokens;
        prefix_cache_mb <= 0 turns the shared-prefix cache off;
        preempt_mode ("swap" or "recompute") is how a paged pool under
        pressure parks a decoding victim. The supervisor's knobs: a
        dispatch in flight past step_watchdog_s flags the engine wedged
        (0: no watchdog); rebuild_budget rebuilds per rolling
        rebuild_window_s, past which the engine goes DOWN and probes the
        device every restore_interval_s. queue_deadline_s > 0 fails a
        request still queued after that long (503); request_deadline_s >
        0 fails an admitted or parked one older than that (504).
        qos_weights / qos_bounds override the classes' weighted-fair
        weights and per-class queue bounds (max_queue each by default;
        None reads CAKE_QOS_WEIGHTS / CAKE_QOS_BOUNDS, as the
        reference's queue does). spec ("ngram" or a shareable Drafter;
        None reads CAKE_SPEC, off when unset) turns on speculative
        decoding with windows of spec_k tokens (CAKE_SPEC_K, 6);
        spec_reserve caps the speculative frontier a paged slot reserves
        ahead of a verify (CAKE_SPEC_RESERVE; 0 = the whole window). A
        drafter with per-sequence state is refused."""
        if preempt_mode not in PREEMPT_MODES:
            raise ValueError(f"preempt_mode must be one of {PREEMPT_MODES},"
                             f" got {preempt_mode!r}")
        self.model = model
        self.slots = slots
        self.ctx = min(ctx_len or DEFAULT_CTX, model.max_cache_len)
        self.chunk = _pow2_chunk(prefill_chunk, self.ctx)
        self.kv_blocks = max(int(kv_blocks), 0)
        self.kv_block_tokens = kv_block_tokens
        self.preempt_mode = preempt_mode
        self.pool = SlotPool(slots)
        self.queue = AdmissionQueue(max_queue, weights=qos_weights,
                                    bounds=qos_bounds)
        self.queue_deadline_s = queue_deadline_s
        self.request_deadline_s = request_deadline_s
        self._seed = seed
        self._vocab = model.cfg.vocab_size
        drafter, k = resolve_drafter(spec, spec_k)
        if drafter is not None and not drafter.shareable:
            raise ValueError(
                f"drafter {drafter.name!r} keeps per-sequence state and "
                "cannot be shared across engine slots: use 'ngram' "
                "(a DraftModelDrafter belongs on the generate() path)")
        self.spec_drafter = drafter
        self.spec_k = k
        if spec_reserve is None:
            spec_reserve = spec_knobs()["spec_reserve"]
        self.spec_reserve = max(int(spec_reserve), 0)
        self.spec_steps = self.spec_proposed = self.spec_accepted = 0
        # windows degraded to a plain step at the pool's edge, and blocks
        # of speculative tails given back (paged pool)
        self.spec_degraded = self.spec_trimmed = 0
        # this iteration's draft lengths (slot -> n): the speculative
        # tail trim keeps the blocks the pending verify will write
        self._cur_nd: dict[int, int] = {}
        self.paged: PagedKV | None = None
        self._init_device_state()
        self._prefix_cache_mb = prefix_cache_mb
        self.prefix_cache = self._build_prefix_cache()
        self._reqs: list[ServeRequest | None] = [None] * slots
        self._prefills: list[_Prefill] = []
        self._preempted: list[PreemptedSlot] = []
        self.preemptions = {mode: 0 for mode in PREEMPT_MODES}
        self.replays = 0                # recompute resumes replayed
        self._rr = 0
        self._draining = threading.Event()
        self._wake = threading.Event()
        self._stop = threading.Event()
        # the fleet KV-share agent (fleet/kvshare/replica.py), set by the
        # API server when CAKE_KVSHARE is on; its run_pending() runs at
        # the top of every scheduler step
        self.kv_share = None
        self.steps = 0
        self.last_step = now()
        # device-work spans of this iteration, closed at its fetch:
        # [(name, t0_us, args)]
        self._spans: list[tuple[str, int, dict]] = []
        self.dead: BaseException | None = None
        self.graph = None               # the decode step's DecodeGraph
        # the verify step's graphs, by filt (speculation only)
        self.verify_graphs: dict[bool, DecodeGraph] = {}
        self.capture_s = 0.0            # seconds capturing at start
        self.last_rebuild: dict | None = None   # the last _rebuild's record
        # the ring the supervisor dumps on a wedge or DOWN (flight.py)
        self.flight = FlightRecorder()
        self.supervisor = Supervisor(
            self, watchdog_s=step_watchdog_s, rebuild_budget=rebuild_budget,
            rebuild_window_s=rebuild_window_s,
            restore_interval_s=restore_interval_s)
        self._ready = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="cake-torch-serve")
        self._thread.start()
        t0 = now()
        while not self._ready.wait(POLL_S):
            if not self._thread.is_alive():
                break
            if now() - t0 > START_TIMEOUT_S:
                self._stop.set()
                raise RuntimeError(
                    f"serve engine did not start within {START_TIMEOUT_S}s "
                    "(the scheduler thread is still capturing its graphs)")
        if self.dead is not None or not self._thread.is_alive():
            self._thread.join(timeout=START_TIMEOUT_S)
            raise self.dead or RuntimeError(
                "serve engine's scheduler thread ended before it started")

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
            self.prefill = self.paged.prefill
            capacity = self.paged.max_blocks * self.paged.bt
        else:
            model = self.model
            layers = model.new_cache(n, kv_len=self.ctx)["layers"]
            self._layers = layers
            capacity = kv_capacity(model.cfg, {"layers": layers})
            self.prefill = model.prefill_graphs(
                lambda io, bucket, mode: model.prefill_chunk_into(
                    layers, io, bucket, mode), capacity, self.chunk)
        # the prefill programs captured at start (graphs.PrefillGraphs)
        self._prefill_keys = prefill_start_keys(self.chunk, capacity,
                                                self.model.max_cache_len)
        self.carries = DecodeCarries.build(n, self._vocab, RECENT_N, dev)
        self.spec = (SpecCarries.build(self.carries, self.spec_k)
                     if self.spec_drafter is not None else None)
        self._seq = 0                   # admissions so far: the key index

    def _decode_fn(self):
        """The in-place decode step over the pool that the graph captures."""
        model, c, paged = self.model, self.carries, self.paged
        if paged is not None:
            return lambda: model.decode_slots_paged_into(
                paged.pool, paged.rows, paged.tables, c)
        layers = self._layers
        return lambda: model.decode_slots_into(layers, c)

    def _verify_fn(self, filt: bool):
        """The in-place verify step over the pool that a graph captures."""
        model, c, paged = self.model, self.spec, self.paged
        if paged is not None:
            return lambda: model.spec_slots_paged_into(
                paged.pool, paged.rows, paged.tables, c, filt)
        layers = self._layers
        return lambda: model.spec_slots_into(layers, c, filt)

    def _reset_device_state(self):
        """Back to the state of a fresh engine, IN PLACE: every contiguous
        row, or every paged block, row and table entry, wiped, the block
        allocator fresh, every carry inactive. Nothing is rebound, so the
        decode graph and every prefill program go on reading the same
        addresses, and nothing is allocated."""
        if self.paged is not None:
            self.paged.reset()
        else:
            reset_layers(self._layers)
        self.carries.reset()
        if self.spec is not None:
            self.spec.reset()

    def _build_prefix_cache(self):
        """Mode-matched prefix cache, empty: the paged one pins pool blocks
        by refcount (a hit is a table remap, no KV copy) and is the
        allocator's under-pressure evictor; the contiguous one keeps
        private block copies."""
        capacity_mb = self._prefix_cache_mb
        if self.paged is not None:
            pc = PagedPrefixCache.build_paged(self.model, self.paged,
                                              self.chunk, capacity_mb)
            self.paged.evictor = pc.evict_for_pressure if pc else None
            return pc
        return PrefixCache.build(self.model, self.ctx, self.chunk,
                                 capacity_mb)

    def _sync_device(self):
        """Wait for the device on a card (a no-op on the CPU): a fault of
        the work queued so far surfaces here."""
        if self.model.device.type == "cuda":
            torch.cuda.synchronize(self.model.device)

    # -- client surface (any thread) ----------------------------------------

    def submit(self, prompt_ids: list[int], max_new_tokens: int = 256,
               sampling: SamplingConfig | None = None,
               request_id: str | None = None, qos: str = "interactive",
               tenant: str | None = None) -> ServeRequest:
        """Enqueue a generation under QoS class `qos` (admission lane,
        weighted-fair share, preemption rank; the API resolves it and the
        tenant's ceiling clamps it). Raises QueueFull when that class's
        lane is full (its Retry-After reflects the class's backlog),
        EngineDraining while shutting down, EngineDown when the scheduler
        died or while the engine is DOWN (rebuild budget exhausted),
        PoisonedRequest for a quarantined prompt, ValueError for prompts a
        slot can never hold."""
        if self.dead is not None or not self._thread.is_alive():
            raise self._down_error()
        if self.supervisor.is_down():
            raise self._down_error()
        if self._draining.is_set():
            raise EngineDraining()
        if self.supervisor.is_quarantined(prompt_ids):
            raise PoisonedRequest(
                "request fingerprint quarantined: an identical prompt was "
                "implicated in repeated engine crashes")
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
        req = ServeRequest(prompt_ids, max_new_tokens, sampling, request_id,
                           qos=qos, tenant=tenant)
        req._engine = self
        # the timeline opens and records the enqueue BEFORE the put: once
        # queued, the scheduler may admit the request at once, and its
        # admit event must find the timeline and follow the enqueue
        TIMELINES.begin(req.id)
        TIMELINES.event(req.id, "enqueue", depth=self.queue.depth() + 1,
                        qos=req.qos,
                        **({"tenant": req.tenant} if req.tenant else {}))
        try:
            # free slots extend the bound: a burst that fits the idle pool
            # is admitted even though the scheduler drains one per
            # iteration
            self.queue.put(req, allow_extra=self.pool.free_count)
        except QueueFull:
            TIMELINES.event(req.id, "error", type="QueueFull")
            raise
        self._wake.set()
        if self.dead is not None or self.supervisor.is_down():
            # the scheduler died (or went down) between the check above
            # and the put: its drain may have missed this request, so
            # release the waiter here (a second fail is harmless)
            self.queue.purge(lambda r: r is req)
            err = self._down_error()
            self._fail(req, err)
            raise err
        return req

    def _down_error(self) -> EngineDown:
        """The typed refusal of a dead engine, or of one DOWN (its
        Retry-After past the restore loop's next probe)."""
        if self.dead is not None or not self._thread.is_alive():
            return EngineDown(f"serve engine is down: {self.dead}",
                              retry_after_s=30)
        down = self.supervisor.down_info() or {}
        return EngineDown(
            f"serve engine down for {down.get('down_for_s', 0.0)}s "
            f"(rebuild budget exhausted: "
            f"{down.get('last_failure', 'unknown failure')}); restore loop "
            "probing", retry_after_s=self.supervisor.retry_after_s())

    def _orphan_check(self, req: ServeRequest) -> None:
        """A request whose scheduler thread is gone without finishing it
        fails with EngineDown here, so that no waiter waits for a thread
        that will never answer."""
        if not req.done.is_set() and not self._thread.is_alive():
            self._fail(req, self._down_error())

    def wait(self, req: ServeRequest, event: threading.Event | None = None
             ) -> None:
        """Wait until `event` (default: req.done) or req.done is set,
        checking every POLL_S that the scheduler thread still runs. A wait
        on req.done alone blocks between checks; a wait on another event
        looks at both every 20 ms."""
        if event is None or event is req.done:
            while not req.done.wait(POLL_S):
                self._orphan_check(req)
            return
        checked = now()
        while not (event.wait(0.02) or req.done.is_set()):
            if now() - checked >= POLL_S:
                self._orphan_check(req)
                checked = now()

    def stream(self, req: ServeRequest):
        """Iterator over the request's Tokens (blocking; each wait bounded
        by POLL_S and a check that the scheduler still runs). Closing it
        early cancels the request, freeing its slot. Raises the request's
        error, if any, after the last token."""
        req.streaming = True
        try:
            while True:
                try:
                    item = req.out_q.get(timeout=POLL_S)
                except queue_mod.Empty:
                    self._orphan_check(req)
                    continue
                if item is ServeRequest.DONE:
                    break
                yield item
        finally:
            req.streaming = False
            req.cancel()
        if "error" in req.result:
            raise req.result["error"]

    def health(self) -> dict:
        sup = self.supervisor
        h = {
            "alive": self.dead is None and self._thread.is_alive(),
            "slots": self.slots,
            "slots_busy": self.pool.busy_count,
            "queue_depth": self.queue.depth(),
            "queue_by_class": self.queue.depths(),
            "ctx_len": self.ctx,
            "prefill_chunk": self.chunk,
            "prefilling": len(self._prefills),
            "draining": self._draining.is_set(),
            "steps": self.steps,
            "last_step_age_s": round(now() - self.last_step, 3),
            "prefill_graphs": {"programs": len(self.prefill.graphs),
                               "replays": self.prefill.replays,
                               "capture_s": round(self.capture_s, 3)},
            # supervision: lifetime recovery counts and the live wedge flag
            "rebuilds": sup.rebuild_count,
            "wedged": sup.wedged(),
            "wedges": sup.wedge_count,
            "step_failures": dict(sup.failures),
        }
        lf = sup.last_failure()
        if lf is not None:
            h["last_failure"] = lf
        down = sup.down_info()
        if down is not None:
            h["down"] = down
        q = sup.quarantined_count()
        if q:
            h["quarantined"] = q
        if self.last_rebuild is not None:
            h["last_rebuild"] = dict(self.last_rebuild)
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
                            "preempted_slots": len(self._preempted),
                            "preempt_mode": self.preempt_mode,
                            "preemptions": dict(self.preemptions),
                            "replays": self.replays}
            if pc is not None:
                h["kv_pool"]["prefix_entries"] = len(pc._blocks)
                h["kv_pool"]["prefix_pinned_blocks"] = pc.pinned
        ks = self.kv_share
        if ks is not None:
            h["kvshare"] = ks.health_view()
        if self.spec_drafter is not None:
            h["spec"] = {"drafter": self.spec_drafter.name,
                         "k": self.spec_k, "mode": "batched",
                         "steps": self.spec_steps,
                         "proposed": self.spec_proposed,
                         "accepted": self.spec_accepted,
                         "degraded": self.spec_degraded,
                         "trimmed_blocks": self.spec_trimmed,
                         "verify_replays": sum(
                             g.steps for g in self.verify_graphs.values())}
        return h

    def begin_drain(self) -> None:
        self._draining.set()
        self._wake.set()

    def drain(self, timeout: float | None = None) -> bool:
        """Stop admission and wait for busy slots and queued requests to
        finish. True when the engine went idle within the timeout."""
        self.begin_drain()
        deadline = None if timeout is None else now() + timeout
        while self.pool.busy_count or self.queue.depth() or self._preempted:
            if self.dead is not None or not self._thread.is_alive():
                return False
            if deadline is not None and now() >= deadline:
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
            t0 = now()
            dev = self.model.device
            if dev.type == "cuda":
                gc.collect()    # one collection for every program below
            # captured with every row inactive (nothing admitted yet)
            self.graph = DecodeGraph(self._decode_fn(), dev, collect=False)
            if self.spec is not None:
                # one graph per filt, as the reference compiles one
                # executable per (bucket, k, filt); they never run at once
                # and share a memory pool
                pool = (torch.cuda.graph_pool_handle()
                        if dev.type == "cuda" else None)
                self.verify_graphs = {
                    filt: DecodeGraph(self._verify_fn(filt), dev, pool=pool,
                                      collect=False)
                    for filt in (False, True)}
            # each prefill program's warm-up writes nothing (valid_len 0)
            self.prefill.capture(self._prefill_keys, collect=False)
            self.capture_s = now() - t0
        except BaseException as e:
            log.exception("serve engine failed to capture its programs")
            self.dead = e
            return
        finally:
            self._ready.set()
        # the supervision shell (the reference's, engine.py:707-743): a
        # failure escaping `_run` goes to the supervisor's recovery state
        # machine (classify -> rebuild by replay -> budget -> DOWN); only
        # when the supervisor itself fails, or gives up, does the engine
        # fall to the terminal `dead` state
        while not self._stop.is_set():
            try:
                self._run()
                return                      # clean stop
            except BaseException as e:
                try:
                    recovered = self.supervisor.on_failure(e)
                except BaseException as sup_exc:
                    log.exception("serve supervisor failed")
                    self._die(sup_exc)      # supervisor bug: last resort
                    return
                if not recovered:
                    log.error("serve engine died: %r", e)
                    self._die(e)
                    if not isinstance(e, Exception):
                        raise
                    return

    def _run(self):
        sup = self.supervisor
        while not self._stop.is_set():
            if sup.is_down():
                self._down_cycle()
                continue
            worked = self._step()
            sup.disarm()
            self.last_step = now()
            if worked:
                self.steps += 1
                sup.note_ok()
            else:
                self._wake.wait(0.5)
                self._wake.clear()

    def _die(self, e: BaseException):
        """Terminal failure: every waiter is released, loudly."""
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

    # -- degraded mode (rebuild budget exhausted) ---------------------------

    def _down_cycle(self):
        """One turn of the restore loop while the engine is DOWN: shed
        whatever raced into the queue, wait restore_interval_s, then probe
        the device with a trial chunk. Success reopens admission; failure
        stays down for the next probe."""
        sup = self.supervisor
        for req in self.queue.drain():
            self._fail(req, self._down_error())
        if self._stop.wait(sup.restore_interval_s):
            return
        try:
            sup.arm("trial", (), grace=True)
            self._reset_device_state()
            if self.paged is not None:
                self.paged.reserve_range(0, 0, 1)
            self.prefill.run(0, [1], 0)
            self._release_row(0)
            # the replay above is asynchronous on a card: a broken device
            # surfaces its error here, inside the probe's try
            self._sync_device()
            sup.disarm()
        except Exception as e:
            sup.disarm()
            sup.note_probe_failure(e)
            return
        self._revive()

    def _revive(self):
        """The trial succeeded on the reset pool: a fresh prefix cache, and
        back to serving. The pool and every captured graph are the ones
        the engine started with (the reference reallocates both)."""
        self.prefix_cache = self._build_prefix_cache()
        self.supervisor.clear_down()
        log.warning("serve engine revived: trial chunk succeeded, pool "
                    "reset in place, admission reopened")

    def _step(self) -> bool:
        sup = self.supervisor
        # a crash in the host bookkeeping below must not implicate the
        # previous step's requests (the dispatches arm their own sets)
        sup.arm("step", ())
        # the KV-share mailbox FIRST, before the idle return: an idle
        # engine still serves blob jobs (a submit sets _wake, which lands
        # the loop here)
        ks = self.kv_share
        if ks is not None:
            ks.run_pending()
        busy = self.pool.busy()
        if not (busy or self.queue.depth() or self._preempted):
            return False
        with RECORDER.span("serve.step", cat="serve", slots=len(busy),
                           queued=self.queue.depth()):
            return self._iterate(busy)

    def _iterate(self, busy: list[int]) -> bool:
        """The body of one scheduler iteration (`_step`'s span)."""
        sup = self.supervisor
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
                      if e.req.cancelled.is_set() or e.req.done.is_set()]:
            self._preempted.remove(entry)
            self._fail(entry.req, None)
        for req in self.queue.purge(lambda r: r.cancelled.is_set()):
            self._fail(req, None)
        self._sweep_deadlines()
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
        self._cur_nd = {}
        pf_job = (self._prefills[self._rr % len(self._prefills)]
                  if self._prefills else None)
        if pf_job is not None and self.paged is not None:
            pf_job = self._prepare_prefill(pf_job)
        prefilling = {p.slot for p in self._prefills}
        active = [i for i in self.pool.busy()
                  if self._reqs[i] is not None and i not in prefilling]
        # the drafts are built on the host (the n-gram lookup) while the
        # previous iteration's chunk may still run on the card
        spec_job = (self._build_drafts(active)
                    if active and self.spec_drafter is not None else None)
        if self.paged is not None and active:
            active = self._ensure_decode_blocks(active, spec_job)
        # 4. one batched decode or verify step over the pool; armed BEFORE
        # the fault hook, so that an injected stall is seen by the
        # watchdog, and a crash here implicates every active request
        t0 = now()
        spec_acc0 = self.spec_accepted
        active_ids = tuple(self._reqs[i].id for i in active)
        if active:
            SERVE_BATCH_OCCUPANCY.observe(len(active))
            sup.arm("decode", active_ids)
            hook = faults.FAULT_HOOK
            if hook is not None:
                hook.on_decode([self._reqs[i] for i in active])
            if spec_job is not None:
                drafts, n_drafts = spec_job
                # no active slot filtering its vocabulary: the graph whose
                # accept rule skips the per-row sorts
                filt = any(config_has_filters(self._reqs[i].sampling)
                           for i in active)
                self.spec.load(drafts, n_drafts)
                self._open_span("spec.verify", now_us(), slots=len(active),
                                drafts=int(n_drafts.sum()))
                self.verify_graphs[filt].step()
            else:
                self.graph.step()
        # 5. advance the chosen admission by one chunk, queued on the
        # device behind the decode step (a preemption in 3 may have
        # requeued it since)
        if pf_job is not None and pf_job in self._prefills:
            idx = self._prefills.index(pf_job)
            self._rr = idx + 1 if self._advance_prefill(pf_job) else idx
        # 6. one fetch per iteration, then fan out. The fetch is where an
        # asynchronous device fault reaches the host: re-armed with the
        # decode set, so that it does not implicate the chunk's request
        if active:
            sup.arm("decode", active_ids)
            packed = (self.carries.packed if spec_job is None
                      else self.spec.packed).cpu().numpy()
            # the chunk queued before the fetch has run on the card by now
            self._close_spans()
            if spec_job is None:
                self._fanout(active, packed)
            else:
                self._fanout_spec(active, packed, *spec_job)
        self._close_spans()
        rec = {"occupancy": len(active),
               "dispatch_ms": round((now() - t0) * 1e3, 3)
               if active else 0.0,
               "queued": self.queue.depth(),
               "prefilling": len(self._prefills),
               "spec_accepted": self.spec_accepted - spec_acc0}
        if self.paged is not None:
            rec["kv_free"] = self.paged.alloc.free_count
            rec["kv_used"] = self.paged.alloc.used_count
        self.flight.record(**rec)
        return True

    def _sweep_deadlines(self) -> None:
        """The deadline sweeps (the reference's, engine.py:848-885): a
        request queued past queue_deadline_s fails with
        QueueDeadlineExceeded (503) instead of taking a slot for a client
        that gave up; an admitted (mid-prefill or decoding) or parked
        request older than request_deadline_s fails with
        RequestDeadlineExceeded (504) and frees its slot. Each expiry
        counts once."""
        if self.queue_deadline_s > 0:
            cutoff = now() - self.queue_deadline_s
            for req in self.queue.purge(lambda r: r.t_enqueue < cutoff):
                SERVE_QUEUE_TIMEOUTS.inc()
                self._fail(req, QueueDeadlineExceeded(now() - req.t_enqueue))
        if self.request_deadline_s > 0:
            cutoff = now() - self.request_deadline_s
            for i in self.pool.busy():
                req = self._reqs[i]
                if req is None or req.t_enqueue >= cutoff:
                    continue
                SERVE_REQUEST_TIMEOUTS.inc()
                err = RequestDeadlineExceeded(now() - req.t_enqueue,
                                              self.request_deadline_s)
                pf = next((p for p in self._prefills if p.slot == i), None)
                if pf is not None:
                    self._abort_prefill(pf, err)
                else:
                    req.result["error"] = err
                    self._finish(i, req, cancelled=True)
            for entry in [e for e in self._preempted
                          if e.req.t_enqueue < cutoff]:
                self._preempted.remove(entry)
                SERVE_REQUEST_TIMEOUTS.inc()
                self._fail(entry.req, RequestDeadlineExceeded(
                    now() - entry.req.t_enqueue, self.request_deadline_s))

    def _open_span(self, name: str, t0_us: int, **args) -> None:
        """A span over device work dispatched since t0_us: `_close_spans`
        ends it at the iteration's fetch (or where the iteration's host
        work ends), so it never waits on the card. A no-op with the
        recorder off."""
        if RECORDER.enabled:
            self._spans.append((name, t0_us, args))

    def _close_spans(self) -> None:
        if self._spans:
            t = now_us()
            for name, t0, args in self._spans:
                RECORDER.add(name, t0, t - t0, cat="serve", **args)
            self._spans.clear()

    # -- chunked admission --------------------------------------------------

    def _start_admission(self) -> bool:
        while True:
            req = self.queue.pop()
            if req is None:
                return False
            if not req.cancelled.is_set():
                break
            self._fail(req, None)
        SERVE_QUEUE_WAIT_SECONDS.observe(now() - req.t_enqueue)
        slot = self.pool.alloc()
        self._reqs[slot] = req
        req.slot = slot
        req.admitted.set()
        req.stats = {"queue_wait_s": now() - req.t_enqueue}
        TIMELINES.event(req.id, "admit", slot=slot, qos=req.qos,
                        queue_wait_ms=round(
                            req.stats["queue_wait_s"] * 1e3, 3))
        req.key = request_key(self._seed, self._seq)
        self._seq += 1
        self._begin_prefill(_Prefill(req, slot))
        SERVE_SLOTS_BUSY.set(self.pool.busy_count)
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
                TIMELINES.event(pf.req.id, "prefix_hit",
                                tokens=pf.hit_tokens)
        self._prefills.append(pf)

    def _advance_prefill(self, pf: _Prefill) -> bool:
        """Prefill one chunk into the slot's row (or its blocks), capture
        every prefix block the chunk completed, and on the last chunk
        sample the first token and activate the slot. True while in
        flight."""
        take = min(self.chunk, pf.n - pf.pos)
        ids = pf.ids[pf.pos:pf.pos + take]
        self.supervisor.arm("prefill", (pf.req.id,))
        hook = faults.FAULT_HOOK
        if hook is not None:
            hook.on_prefill(pf.req)
        t0 = now_us()
        try:
            logits = self.prefill.run(pf.slot, ids, pf.pos)
        except ValueError as e:
            # a request-scoped refusal (bounds): the admission dies alone.
            # Anything else may have poisoned the pool and goes on up to
            # the supervisor
            self._abort_prefill(pf, e)
            return False
        self._open_span("serve.prefill_chunk", t0, tokens=take, pos0=pf.pos,
                        slot=pf.slot, request_id=pf.req.id)
        pf.pos += take
        pf.chunks += 1
        TIMELINES.event(pf.req.id, "prefill_chunk", pos0=pf.pos - take,
                        tokens=take)
        pf.next_block = self._capture_blocks(pf.ids, pf.slot, pf.pos,
                                             pf.next_block, pf.keys)
        if pf.pos >= pf.n:
            self._complete_prefill(pf, logits)
            return False
        return True

    def _capture_blocks(self, ids: list[int], slot: int, pos: int,
                        next_block: int, keys: list[bytes]) -> int:
        """Insert every prefix block of `ids` that the chunk which just
        landed (the row now holds ids[:pos]) completed, at the boundary
        where the row holds exactly that prefix; returns the next block to
        capture. The block holding the final token is never cached (its
        logits must be computed live), hence the n-1 cap."""
        pc = self.prefix_cache
        if pc is None:
            return next_block
        while (next_block + 1) * self.chunk <= min(pos, len(ids) - 1):
            pc.insert(self._layers, slot, ids, next_block, keys)
            next_block += 1
        return next_block

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
        SERVE_PREFILL_CHUNKS.observe(max(pf.chunks, 1))
        TIMELINES.event(req.id, "prefill_done", chunks=pf.chunks,
                        hit_tokens=pf.hit_tokens)

    def _set_slot_sampling(self, slot: int, scfg: SamplingConfig):
        self.carries.set_sampling(
            slot, scfg.temperature, scfg.top_k or self._vocab,
            1.0 if scfg.top_p is None else scfg.top_p, scfg.repeat_penalty)

    def _abort_prefill(self, pf: _Prefill, error: BaseException | None):
        """Tear down a mid-prefill admission (cancel, deadline, a
        request-scoped refusal): release the waiter, free the slot, wipe
        the half-built row (paged: deref its blocks)."""
        self._prefills.remove(pf)
        self._reqs[pf.slot] = None
        self.pool.free(pf.slot)
        SERVE_SLOTS_BUSY.set(self.pool.busy_count)
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
        admission parked itself (every reclaimable block is held by
        higher-class work: it is requeued for a clean restart instead of
        evicting that work) or was failed: with every other occupant
        preempted or requeued the pool still cannot hold the chunk."""
        take = min(self.chunk, pf.n - pf.pos)
        got = self._reserve_blocks(pf.slot, pf.pos, take, requester=pf.req)
        if got == "self":
            self._requeue_admission(pf)
            return None
        if got:
            return pf
        self._abort_prefill(pf, KVPoolExhausted(
            f"KV pool exhausted admitting {pf.req.id}: the prompt needs "
            "more blocks than the pool can ever free"))
        return None

    def _reserve_blocks(self, slot: int, pos0: int, n: int,
                        requester: ServeRequest | None = None):
        """Back positions [pos0, pos0 + n) of `slot` with blocks, evicting
        prefix-cache LRU (inside the pool) and then preempting victims
        (the QoS policy of `_preempt_one`) until it fits. True = fits;
        "self" = only higher-class work holds blocks, so the caller must
        park itself; False = nothing left to reclaim."""
        while not self.paged.reserve_range(slot, pos0, n):
            got = self._preempt_one(exclude=slot, requester=requester)
            if got is not True:
                return got
        return True

    def _ensure_decode_blocks(self, active: list[int],
                              spec_job=None) -> list[int]:
        """Back every decoding slot's write reach before the dispatch: its
        write block for a decode step, its whole speculative frontier [wp,
        wp + n_draft] when it carries a draft window (the verify may
        commit up to n_draft + 1 positions; the reference's frontier
        reservation). A window that does not fit degrades to a plain
        step (its n_draft set to 0) before anyone is preempted.
        Exhaustion evicts prefix-cache LRU, then trims other slots'
        speculative tails, then preempts a victim; a slot that cannot
        grow with nothing left to reclaim fails typed. Returns the
        surviving active list."""
        n_drafts = spec_job[1] if spec_job is not None else None
        for i in active:
            req = self._reqs[i]
            if req is None:
                continue        # preempted by an earlier slot's ensure
            wp = self._frontier(req)
            if n_drafts is not None and n_drafts[i] and \
                    not self.paged.reserve_range(i, wp, 1 + int(n_drafts[i])):
                # speculation never costs anyone their blocks: the slot
                # drops its window to a plain decode step
                n_drafts[i] = 0
                self._cur_nd[i] = 0
                self.spec_degraded += 1
            got = self._reserve_blocks(i, wp, 1, requester=req)
            if got == "self":
                # the only reclaimable blocks are held by higher-class
                # work: this slot parks itself (it resumes bit-identical
                # when blocks free) instead of displacing that work
                self._preempt_slot(i, req)
            elif not got:
                req.result["error"] = KVPoolExhausted(
                    f"KV pool exhausted: request {req.id} cannot grow "
                    f"past {wp} tokens and nothing is left to reclaim")
                self._finish(i, req, cancelled=True)
        return [i for i in active if self._reqs[i] is not None]

    def _preempt_one(self, exclude: int,
                     requester: ServeRequest | None = None):
        """Free blocks: preempt a decoding victim (lowest class first,
        LIFO within a class: victim_rank), else send another in-flight
        admission back for a clean restart (it has emitted nothing;
        lowest class, youngest first). Neither may outrank `requester`'s
        class: when every candidate does, returns "self" and the caller
        parks itself (a batch decoder never displaces interactive work).
        True = blocks freed; False = nothing left to reclaim. Other slots'
        speculative tails go first: a pure rollback, nobody loses work."""
        if self.spec_drafter is not None and self._trim_spec_tails(exclude):
            return True

        def outranks(r):
            return requester is not None and \
                priority(class_of(r)) > priority(class_of(requester))
        prefilling = {p.slot for p in self._prefills}
        cands = [(i, self._reqs[i]) for i in self.pool.busy()
                 if i not in prefilling]
        victim = choose_victim(cands, exclude=exclude)
        others = [p for p in self._prefills if p.slot != exclude]
        pick = max(others, key=lambda p: victim_rank(p.req)) \
            if others else None
        # evict in policy order, but never strictly-higher-class work: a
        # protected victim falls through to the admission check (a
        # lower-class admission may still be requeued)
        if victim is not None and not outranks(victim[1]):
            self._preempt_slot(*victim)
            return True
        if pick is not None and not outranks(pick.req):
            self._requeue_admission(pick)
            return True
        if victim is not None or pick is not None:
            return "self"
        return False

    def _preempt_slot(self, slot: int, req: ServeRequest):
        """Evict one decoding slot to free its blocks. Runs before the
        iteration's decode dispatch, so the carries hold no unfetched
        sampled token. Swap: its blocks and carries go to host memory, and
        an unfetched first token (`_first_pending`) rides `toks` back in.
        Recompute: its blocks are released and resume replays its tokens;
        an unfetched first token is dropped and the request restarts from
        its prompt (it resamples the same token under the same key)."""
        wp = self._frontier(req)
        c = self.carries
        if self.preempt_mode == "swap":
            # only committed blocks ride the blob: the speculative tail
            # past the frontier goes back to the pool first
            self.spec_trimmed += self.paged.trim_to(slot, wp)
            blob = self.paged.swap_out(slot, (c.toks, c.pos, c.recents,
                                              c.keys, c.counters))
            entry = PreemptedSlot(req, "swap", wp, blob)
        else:
            self.paged.release_slot(slot)
            if not req.tokens:
                req._first_pending = False
            entry = PreemptedSlot(req, "recompute", wp)
        self.preemptions[entry.mode] += 1
        SERVE_PREEMPTIONS.inc(mode=entry.mode)
        TIMELINES.event(req.id, "preempt", mode=entry.mode, tokens=wp)
        req.stats.setdefault("preempted_at", []).append(len(req.tokens))
        self.pool.free(slot)
        self._reqs[slot] = None
        req.slot = None
        c.active[slot] = False
        c.toks[slot] = 0
        c.pos[slot] = 0
        self._preempted.append(entry)
        SERVE_SLOTS_BUSY.set(self.pool.busy_count)
        log.warning("preempted slot %d (%s, %d tokens): KV pool "
                    "exhausted", slot, entry.mode, wp)

    def _requeue_admission(self, pf: _Prefill):
        """Send a mid-prefill admission back to readmission to free its
        blocks (a clean restart, ahead of every queued request), labelled
        "recompute" as the reference labels it: it has emitted nothing,
        so its resume is a fresh prefill. Its resume gate is the whole
        prompt's blocks."""
        self._prefills.remove(pf)
        self.paged.release_slot(pf.slot)
        self.pool.free(pf.slot)
        self._reqs[pf.slot] = None
        pf.req.slot = None
        self.preemptions["recompute"] += 1
        SERVE_PREEMPTIONS.inc(mode="recompute")
        TIMELINES.event(pf.req.id, "preempt", mode="requeue", tokens=pf.pos)
        self._preempted.append(PreemptedSlot(pf.req, "recompute",
                                             max(pf.n - 1, 0)))
        SERVE_SLOTS_BUSY.set(self.pool.busy_count)
        log.warning("readmitting request %s: KV pool exhausted "
                    "mid-prefill", pf.req.id)

    def _resume_preempted(self):
        """Oldest-first resume: a swap entry gets fresh blocks and its
        bytes and carries back; a recompute entry, once the blocks of its
        frontier are free, replays its tokens (`_replay_slot`) or, having
        emitted none (a requeued admission, or a dropped first token),
        restarts its prefill. Stops at the first entry that does not fit
        yet (strict FIFO: a big parked request is not starved by smaller
        ones behind it)."""
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
                # a migrated stream the KV-share tier adopted enters HERE
                # without ever passing an admission: its API handler waits
                # on the admitted event (already set for a local preempt)
                if not req.admitted.is_set():
                    req.admitted.set()
                TIMELINES.event(req.id, "resume", mode="swap", slot=slot,
                                **({"kv_migrated": True}
                                   if req.stats.get("kv_migrated") else {}))
            else:
                if not self.paged.ensure_free(
                        self.paged.blocks_for(entry.tokens_at_preempt + 1)):
                    self._fail_unresumable(entry)
                    return
                slot = self.pool.alloc()
                self._preempted.pop(0)
                self._reqs[slot] = req
                req.slot = slot
                # stamped BEFORE the replay it triggers: the timeline
                # reads preempt -> resume -> replay
                TIMELINES.event(req.id, "resume", mode="recompute",
                                slot=slot)
                if not req.tokens:
                    self._begin_prefill(_Prefill(req, slot))
                else:
                    try:
                        self._replay_slot(req, slot)
                    except KVPoolExhausted as e:
                        req.result["error"] = e
                        self._finish(slot, req, cancelled=True)
                        continue
            SERVE_SLOTS_BUSY.set(self.pool.busy_count)
            log.warning("resumed preempted request %s into slot %d (%s)",
                        req.id, slot, entry.mode)

    def _replay_slot(self, req: ServeRequest, slot: int):
        """Replay a request's recorded tokens into a fresh slot and restore
        its decode carries (the reference's `_replay_slot`,
        engine.py:1580-1640): prompt + tokens[:-1] in chunks through the
        prefill programs (replays of their graphs on a card), after any
        cached prefix is spliced; every chunk's blocks are reserved first
        (a replay never preempts: a pool that cannot hold it raises
        KVPoolExhausted), and every prefix block it completes is captured.
        The carries: the last token at position n, the recent window from
        the tail of the tokens, the request's sampling settings, and a
        fresh key, request_key(seed, seq) with the next seq, its counter
        at 0 (the reference's fresh fold_in(base, seq)): a greedy stream
        resumes bit for bit, a sampled one on the new key."""
        ids = req.prompt_ids + req.tokens[:-1]
        n = len(ids)
        TIMELINES.event(req.id, "replay", tokens=n)
        t0 = now_us()
        pos = next_block = 0
        keys: list[bytes] = []
        pc = self.prefix_cache
        if pc is not None:
            keys = pc.chain_keys(ids)
            next_block = pc.match(ids, keys)
            if next_block:
                pc.splice(self._layers, slot, keys, next_block)
                pos = next_block * self.chunk
        req.stats["replay_hit_tokens"] = pos
        hook = faults.FAULT_HOOK
        while pos < n:
            take = min(self.chunk, n - pos)
            if self.paged is not None and \
                    not self.paged.reserve_range(slot, pos, take):
                raise KVPoolExhausted(f"KV pool exhausted replaying "
                                      f"{req.id}")
            # the recovery grace: a replay chunk may capture a program
            self.supervisor.arm("replay", (req.id,), grace=True)
            if hook is not None:
                hook.on_prefill(req)
            self.prefill.run(slot, ids[pos:pos + take], pos)
            pos += take
            next_block = self._capture_blocks(ids, slot, pos, next_block,
                                              keys)
        self._open_span("serve.replay", t0, slot=slot, tokens=n,
                        request_id=req.id)
        tail = req.tokens[-RECENT_N:]
        c = self.carries
        c.recents[slot] = -1
        c.recents[slot, RECENT_N - len(tail):] = torch.tensor(
            tail, dtype=torch.int32)
        c.toks[slot] = req.tokens[-1]
        c.pos[slot] = n
        c.keys[slot] = request_key(self._seed, self._seq)
        self._seq += 1
        c.counters[slot] = 0
        self._set_slot_sampling(slot, req.sampling)
        c.active[slot] = True
        self.replays += 1

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

    # -- crash recovery (called by the supervisor, scheduler thread) --------

    def _rebuild(self, suspects: frozenset = frozenset()):
        """Rebuild by replay after a step failure (the reference's
        `_rebuild`, engine.py:1503-1578): trust nothing on the device,
        reset it, then rebuild every live slot from its host-side token
        record by replaying prompt + generated[:-1] through the prefill
        programs. Greedy continuations are bit-identical afterwards: the
        position, the last token and the recent window all follow from
        the record. Requests that had emitted nothing restart admission;
        preempted entries survive (swap blobs are host memory, recompute
        entries replay from the host record either way). Suspects (the
        requests the failure implicated) replay LAST and one at a time: a
        poisoned request re-crashes on its own replay, which is how the
        supervisor attributes it.

        Where the reference reallocates the pool and reuses its compiled
        executables, the port resets the pool IN PLACE and replays through
        the graphs it captured at start: every graph reads the KV, the
        carries, the block tables and the prefill buffers at fixed
        addresses, so none of them is rebound. Two consequences: an oom
        rebuild allocates no second pool, so it cannot re-OOM on one; and
        `_fail_all` and `_revive` keep the pool and the graphs, where the
        reference drops and reallocates them."""
        t0 = now()
        self._spans.clear()             # the failed iteration's
        replays: list[ServeRequest] = []
        restarts: list[ServeRequest] = []
        for req in self._reqs:
            if req is None:
                continue
            if req.cancelled.is_set() or req.done.is_set():
                self._fail(req, None)       # no row left to wipe: gone
                continue
            if req.tokens:
                replays.append(req)
            else:
                req._first_pending = False  # an unfetched first token
                restarts.append(req)
        self._prefills.clear()
        self.pool = SlotPool(self.slots)
        self._reqs = [None] * self.slots
        self._reset_device_state()
        self.prefix_cache = self._build_prefix_cache()
        # register EVERY survivor before any device work: if a replay
        # crashes, the next rebuild's harvest must still see the ones that
        # had not replayed yet
        replays.sort(key=lambda r: r.id in suspects)    # innocents first
        for req in replays + restarts:
            slot = self.pool.alloc()
            self._reqs[slot] = req
            req.slot = slot
        chunks0 = self.prefill.replays
        for req in replays:
            self._replay_slot(req, req.slot)
            # each completed replay is the CONTRAST that lets a later
            # replay crash be attributed to its own request's data
            self.supervisor.note_replay_ok()
        for req in restarts:
            self._begin_prefill(_Prefill(req, req.slot))
        if replays:
            # wait for the replays on a card, so that their fault, if any,
            # surfaces inside the rebuild and implicates every replay
            self.supervisor.arm("replay", tuple(r.id for r in replays),
                                grace=True)
            self._sync_device()
        self._close_spans()
        SERVE_SLOTS_BUSY.set(self.pool.busy_count)
        self.last_rebuild = {
            "wall_ms": round((now() - t0) * 1e3, 3),
            # tokens each replay ran through the programs (its cached
            # prefix, spliced, is not counted)
            "replayed_tokens": [len(r.prompt_ids) + len(r.tokens) - 1
                                - r.stats["replay_hit_tokens"]
                                for r in replays],
            "replay_chunks": self.prefill.replays - chunks0,
            "restarted": len(restarts)}
        self._wake.set()
        log.warning("serve engine rebuilt in %.0f ms: %d slot(s) replayed "
                    "(%s tokens), %d admission(s) restarted, %d queued "
                    "untouched", self.last_rebuild["wall_ms"], len(replays),
                    self.last_rebuild["replayed_tokens"], len(restarts),
                    self.queue.depth())

    def _drop_poisoned(self, rid: str, err: PoisonedRequest) -> bool:
        """Fail ONE request (attributed poison) with its typed 500 and
        quarantine its fingerprint; the pool lives on for everyone else.
        Its row is not wiped: the caller is about to rebuild."""
        for i, req in enumerate(self._reqs):
            if req is None or req.id != rid:
                continue
            self._reqs[i] = None
            self.pool.free(i)
            self._prefills[:] = [p for p in self._prefills
                                 if p.req.id != rid]
            self.supervisor.quarantine(req.prompt_ids)
            SERVE_POISONED.inc()
            SERVE_SLOTS_BUSY.set(self.pool.busy_count)
            log.error("poisoned request %s dropped and quarantined: %s",
                      rid, err)
            self._fail(req, err)
            return True
        return False

    def _fail_all(self, err: EngineDown):
        """Budget exhausted: every live, parked and queued request is
        released with the typed down error (503 at the API, never a hang)
        and the bookkeeping resets. Host only: the pool and the graphs
        stay (the restore probe resets the pool in place), so a device
        whose every call fails still leaves the engine DOWN, not dead."""
        self._prefills.clear()
        while self._preempted:
            self._fail(self._preempted.pop(0).req, err)
        for req in self.queue.drain():
            self._fail(req, err)
        for i, req in enumerate(self._reqs):
            if req is not None:
                self._reqs[i] = None
                self._fail(req, err)
        self.pool = SlotPool(self.slots)
        self._spans.clear()
        if self.paged is not None:
            self.paged.evictor = None
        self.prefix_cache = None        # _revive builds it anew
        SERVE_SLOTS_BUSY.set(0)

    # -- speculative decoding (batched, accept-aware) -----------------------

    def _build_drafts(self, active: list[int]):
        """This iteration's draft windows (the reference's _build_drafts):
        the shared drafter proposes up to spec_k tokens per slot from the
        slot's own prompt and tokens. A slot whose first token the host
        has not fetched yet, one the drafter abstains on, and one without
        budget or context room get an empty window: a plain decode step
        inside the verify. Returns (drafts [B, k], n_drafts [B]) int32
        host arrays, or None when every window is empty (the decode
        graph runs instead)."""
        k = self.spec_k
        drafts = np.zeros((self.slots, k), np.int32)
        n_drafts = np.zeros((self.slots,), np.int32)
        for i in active:
            req = self._reqs[i]
            if req._first_pending:
                continue        # the newest token rides the next fetch
            ki = min(k, self.ctx - self._frontier(req) - 1,
                     max(req.budget, 0))
            if self.paged is not None and self.spec_reserve > 0:
                ki = min(ki, self.spec_reserve)
            if ki <= 0:
                continue
            d = list(self.spec_drafter.propose(req.prompt_ids + req.tokens,
                                               ki))[:ki]
            if d:
                drafts[i, :len(d)] = d
                n_drafts[i] = len(d)
                self._cur_nd[i] = len(d)
        return (drafts, n_drafts) if n_drafts.any() else None

    def _trim_spec_tails(self, exclude: int | None = None) -> bool:
        """Roll speculative frontier reservations back under pressure
        (the reference's _trim_spec_tails): blocks a slot maps past its
        committed tokens plus its pending window go back to the pool.
        True = at least one block freed."""
        freed = 0
        for i in self.pool.busy():
            req = self._reqs[i]
            if i == exclude or req is None:
                continue
            freed += self.paged.trim_to(
                i, self._frontier(req) + self._cur_nd.get(i, 0) + 1)
        self.spec_trimmed += freed
        return freed > 0

    def _fanout_spec(self, active: list[int], arr, drafts, n_drafts):
        """Fan one verify's packed ids out (the reference's _fanout_spec):
        row 0 is each slot's input token (a newly activated slot's
        unemitted first token), row 1 its accepted drafts, row 2 the
        correction or bonus token. The host knows the drafts, so n_acc +
        1 tokens per slot ride a fetch no larger than a decode step's.
        EOS or the budget inside the accepted prefix ends the request
        there."""
        for i in active:
            req = self._reqs[i]
            if req._first_pending:
                req._first_pending = False
                req.t_first = now()
                req.stats["ttft_s"] = req.t_first - req.t_enqueue
                TIMELINES.event(req.id, "first_token")
                first = int(arr[0, i])
                self._emit(req, first)
                if self.model.cfg.is_eos(first) or req.budget <= 0:
                    self._finish(i, req)
                    continue
            n_prop = int(n_drafts[i])
            n_acc, nxt = int(arr[1, i]), int(arr[2, i])
            if n_prop:
                self.spec_steps += 1
                self.spec_proposed += n_prop
                self.spec_accepted += n_acc
                record_step(n_prop, n_acc, bucket=self.slots)
                TIMELINES.event(req.id, "spec_verify", bucket=self.slots,
                                proposed=n_prop, accepted=n_acc)
            else:
                TIMELINES.event(req.id, "decode", bucket=self.slots)
            for t in [int(d) for d in drafts[i, :n_acc]] + [nxt]:
                req.budget -= 1
                self._emit(req, t)
                if self.model.cfg.is_eos(t) or req.budget <= 0:
                    self._finish(i, req)
                    break

    # -- batched decode fan-out ---------------------------------------------

    def _fanout(self, active: list[int], arr):
        """Row 0 of the packed ids is each slot's input token (a newly
        activated slot's unemitted first token), row 1 the sampled one."""
        for i in active:
            req = self._reqs[i]
            TIMELINES.event(req.id, "decode", bucket=self.slots)
            if req._first_pending:
                req._first_pending = False
                req.t_first = now()
                req.stats["ttft_s"] = req.t_first - req.t_enqueue
                TIMELINES.event(req.id, "first_token")
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
        dt = now() - req.t_first if req.t_first else 0.0
        ndec = max(len(req.tokens) - 1, 0)
        req.stats.update({"decode_tokens": ndec, "decode_s": dt,
                          "tok_per_s": ndec / dt if dt > 0 and ndec else 0.0})
        req.result["tokens"] = req.tokens
        req.result["stats"] = req.stats
        if cancelled and "error" not in req.result:
            req.result["cancelled"] = True
        if not cancelled and req.tokens:
            observe_generation(req.stats, len(req.tokens), "serve")
        # SLO and terminal event only for a request not already finalized
        # (close() may have released this waiter before), so that nothing
        # counts twice
        if not req.done.is_set():
            outcome = ("ok" if not cancelled else
                       "error" if "error" in req.result else "cancelled")
            self._observe_slo(req, outcome)
            TIMELINES.event(
                req.id, "finish", outcome=outcome, tokens=len(req.tokens),
                qos=req.qos,
                ttft_ms=round(req.stats.get("ttft_s", 0.0) * 1e3, 3),
                e2e_ms=round((now() - req.t_enqueue) * 1e3, 3),
                **({"tenant": req.tenant} if req.tenant else {}))
        SERVE_SLOTS_BUSY.set(self.pool.busy_count)
        req._deliver(ServeRequest.DONE)
        req.done.set()

    @staticmethod
    def _observe_slo(req: ServeRequest, outcome: str):
        """Per terminal request: the TTFT / mean ITL / e2e histograms by
        outcome (and TTFT / e2e by class), each observation carrying the
        request id as its exemplar, so a bad percentile links to one
        /api/v1/requests/<id> timeline."""
        t = now()
        SERVE_E2E_SECONDS.observe(t - req.t_enqueue, exemplar=req.id,
                                  outcome=outcome)
        SERVE_QOS_E2E_SECONDS.observe(t - req.t_enqueue, exemplar=req.id,
                                      qos=req.qos, outcome=outcome)
        if req.t_first:
            SERVE_TTFT_SECONDS.observe(req.t_first - req.t_enqueue,
                                       exemplar=req.id, outcome=outcome)
            SERVE_QOS_TTFT_SECONDS.observe(req.t_first - req.t_enqueue,
                                           exemplar=req.id, qos=req.qos,
                                           outcome=outcome)
            ndec = max(len(req.tokens) - 1, 0)
            if ndec:
                SERVE_ITL_SECONDS.observe((t - req.t_first) / ndec,
                                          exemplar=req.id, outcome=outcome)

    def _fail(self, req: ServeRequest, error: BaseException | None):
        if error is not None:
            req.result["error"] = error
        req.result.setdefault("tokens", req.tokens)
        req.result.setdefault("stats", req.stats)
        if not req.done.is_set():
            err = req.result.get("error")
            self._observe_slo(req, "error" if err is not None
                              else "cancelled")
            TIMELINES.event(req.id, "error",
                            type=type(err).__name__ if err is not None
                            else "cancelled")
        req._deliver(ServeRequest.DONE)
        req.done.set()


# the engine's shape from the environment: (kwarg, variable, cast,
# default), the reference's knobs and defaults (cake_tpu/knobs.py)
ENGINE_KNOBS = (
    ("slots", "CAKE_SERVE_SLOTS", int, DEFAULT_SLOTS),
    ("max_queue", "CAKE_MAX_QUEUE", int, DEFAULT_QUEUE),
    ("ctx_len", "CAKE_SERVE_CTX", int, DEFAULT_CTX),
    ("prefill_chunk", "CAKE_PREFILL_CHUNK", int, DEFAULT_CHUNK),
    ("prefix_cache_mb", "CAKE_PREFIX_CACHE_MB", float,
     DEFAULT_PREFIX_CACHE_MB),
    ("kv_blocks", "CAKE_KV_BLOCKS", int, 0),
    ("kv_block_tokens", "CAKE_KV_BLOCK_TOKENS", int,
     DEFAULT_KV_BLOCK_TOKENS),
    ("preempt_mode", "CAKE_PREEMPT_MODE", str, "swap"),
)


def engine_knobs(env, **given) -> dict:
    """The engine's shape: each kwarg of ENGINE_KNOBS from `given` when
    it is not None (an explicit flag wins), else from its CAKE_ variable
    when set and not empty, else the reference's default."""
    out = {}
    for kw, name, cast, default in ENGINE_KNOBS:
        if given.get(kw) is not None:
            out[kw] = cast(given[kw])
        elif env.get(name):
            out[kw] = cast(env[name])
        else:
            out[kw] = default
    return out


def maybe_engine(model, env=None, **kw) -> ServeEngine | None:
    """A serve engine for a model that can batch (the reference's
    maybe_engine): its shape from engine_knobs(env, **kw) (env: the
    process environment by default), the other kwargs passed through.
    None for a model that is not a TextModel, an offloaded one, or when
    the slots are 0 (CAKE_SERVE_SLOTS=0): the API then serves one request
    at a time under a lock (api/state.py)."""
    from ..models.common.text_model import TextModel
    shape = engine_knobs(os.environ if env is None else env,
                         **{k: kw.pop(k) for k, *_ in ENGINE_KNOBS
                            if k in kw})
    if (not isinstance(model, TextModel)
            or getattr(model, "expert_offload", False)
            or shape["slots"] <= 0):
        return None
    return ServeEngine(model, **shape, **kw)
