"""Per-request timelines: a bounded ring of typed lifecycle events (the
port's own copy of cake_tpu/obs/timeline.py: TimelineStore, EVENT_KINDS,
TRACE_HEADER).

The metrics registry answers "how is the server doing"; the span recorder
answers "where did wall time go inside this process". This store answers
"this one request was slow: where did its time go?". Every request
shares one id from the API handler to the scheduler (a client's
`X-Cake-Request-Id` becomes it, the engine keys its bookkeeping by it),
and the store records that id's lifecycle as typed events (received,
enqueue, admit, each prefill chunk, each decode iteration it rode,
preemption and resume, rebuild replay, finish or error) against
monotonic timestamps, bounded two ways:

  * the store keeps the last `capacity` request timelines (ring: oldest
    evicted first; CAKE_TRACE_REQUESTS under `cli serve`);
  * each timeline keeps at most `MAX_EVENTS` events (newest dropped,
    counted in `dropped`; terminal events always land, so a truncated
    timeline still says how the request ended).

`GET /api/v1/requests/<id>` serves a timeline as JSON. `to_chrome(rid)`
exports one timeline as Chrome-trace instant events on the SAME
perf_counter microsecond clock the span recorder uses, so a timeline
merges with a `RECORDER.export()` in Perfetto.

Recording is always on (one dict lookup and a list append per event, on
host values the scheduler already has), unlike the span recorder, which
buffers far more events and stays opt-in.
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict

from .spans import current_request_id

__all__ = ["EVENT_KINDS", "MAX_EVENTS", "TIMELINES", "TRACE_HEADER",
           "TimelineStore"]

# the reference's CAKE_TRACE_REQUESTS default
DEFAULT_TRACE_REQUESTS = 256

# the one header every tier propagates; the API adopts it as the request
# id, and responses echo it back to the client
TRACE_HEADER = "X-Cake-Request-Id"

# per-timeline event cap: newest events drop past this (counted), except
# terminal kinds, which always land
MAX_EVENTS = 512

# typed event vocabulary: event() rejects unknown kinds. The reference's
# table, cut to the kinds the port records (the fleet router's and the
# KV-share tier's among them)
EVENT_KINDS: dict[str, str] = {
    # API tier
    "received": "request reached the API handler",
    "kv_fetch": "fleet-shared KV tier: this replica tried to fetch a "
                "matching prefix blob from a warm peer before "
                "recomputing the prefill (`outcome` = hit | miss | "
                "timeout | error | mismatch, `tokens` installed on a "
                "hit, `peer`)",
    "kv_migrate": "fleet-shared KV tier: a live stream's swap blob "
                  "moved through the router's resume plane (`outcome` "
                  "= shipped | source_miss | ship_error, `from`, `to`)",
    # admission plane + serve engine tier
    "enqueue": "request entered the admission queue (`depth` behind it, "
               "`qos` class, `tenant` when set)",
    "admit": "slot assigned, chunked prefill opens (`slot`, "
             "`queue_wait_ms`, `qos`)",
    "prefix_hit": "prefix-cache splice skipped `tokens` prompt tokens",
    "prefill_chunk": "one chunk written into the slot's KV (`pos0`, "
                     "`tokens`)",
    "prefill_done": "prompt fully prefilled; first token sampled "
                    "(`chunks`, `hit_tokens`)",
    "first_token": "first token fetched to the host (client-visible "
                   "TTFT stamps here)",
    "decode": "one batched decode iteration this slot rode (`bucket` = "
              "the dispatch's slot count)",
    "spec_verify": "one batched speculative verify this slot "
                   "participated in (`bucket`, `proposed`, `accepted`)",
    "preempt": "slot evicted under KV-pool pressure (`mode` = "
               "swap | recompute | requeue, `tokens`)",
    "resume": "preempted request re-entered a slot (`mode`, `slot`)",
    "replay": "prompt+generated replayed through chunked prefill "
              "(crash rebuild or recompute resume; `tokens`)",
    "step_failure": "a scheduler step implicating this request failed "
                    "(`failure` = classified kind, `phase`)",
    # cluster tier (distributed master, per remote hop)
    "cluster_hop": "one remote-stage forward attributed to this request "
                   "(`worker`, `ms`)",
    # fleet router tier
    "route": "router accepted the request and ordered candidates "
             "(`candidates`, `stream`)",
    "attempt": "one outbound try against a replica (`replica`, "
               "`outcome`, `status`)",
    "retry": "failover: the next candidate gets the request",
    "hedge": "tail hedge fired a duplicate at the next-best replica",
    "shed": "router refused before any replica admitted (`reason`)",
    "commit": "first streamed byte relayed; the request is committed "
              "to `replica`",
    "stream_broken": "stream severed after commit (`replica`, `chunks` "
                     "relayed so far); the resume budget decides what "
                     "happens next",
    "stream_resume": "router began a transparent splice-resume of the "
                     "broken stream (`replica` that broke, `attempt`, "
                     "`sampled` when the rng-fold parity exception "
                     "applies)",
    "resume_spliced": "resumed replica's continuation reached the "
                      "client: first spliced chunk relayed on the same "
                      "socket (`replica`, `overlap_chars` stripped)",
    "done": "terminal: router relayed the final response (`status`)",
    "replica_partition_suspected": "membership ejected a replica on "
                                   "data-path/transport evidence while "
                                   "its probe path may still answer "
                                   "(`replica`, `reason`, `hold_s`); "
                                   "readmit now requires a data-path "
                                   "trial",
    "partition_healed": "a suspected-partition episode ended: the "
                        "replica passed a data-path trial and rejoined "
                        "routing (`replica`, `episode_s`)",
    "finish": "terminal: generation completed (`outcome`, `tokens`, "
              "`ttft_ms`, `e2e_ms`)",
    "error": "terminal: request failed or was cancelled (`type`)",
}

# terminal kinds bypass the per-timeline cap: a truncated timeline must
# still say how the request ended
_TERMINAL = frozenset({"finish", "error", "done"})


class _Timeline:
    __slots__ = ("rid", "tier", "start_unix", "t0_us", "events", "dropped")

    def __init__(self, rid: str, tier: str):
        self.rid = rid
        self.tier = tier
        self.start_unix = time.time()
        self.t0_us = time.perf_counter_ns() // 1000
        self.events: list[dict] = []
        self.dropped = 0


class TimelineStore:
    """Thread-safe bounded store. begin() opens a timeline (idempotent),
    event() appends to a known id (unknown ids are a cheap no-op: only
    requests a tier opened a timeline for keep events), alias() lets a
    second id (the OpenAI completion id) resolve to the same timeline."""

    def __init__(self, capacity: int = DEFAULT_TRACE_REQUESTS,
                 max_events: int = MAX_EVENTS):
        self.capacity = max(int(capacity), 1)
        self.max_events = max_events
        self._lock = threading.Lock()
        self._by_id: OrderedDict[str, _Timeline] = OrderedDict()
        self._aliases: dict[str, str] = {}

    # -- recording -----------------------------------------------------------

    def begin(self, rid: str, tier: str = "replica") -> None:
        with self._lock:
            if rid in self._by_id or rid in self._aliases:
                return
            self._by_id[rid] = _Timeline(rid, tier)
            while len(self._by_id) > self.capacity:
                old, _ = self._by_id.popitem(last=False)
                self._aliases = {a: r for a, r in self._aliases.items()
                                 if r != old}

    def alias(self, alias_id: str, rid: str) -> None:
        """Make alias_id resolve to rid's timeline (completion id to
        trace id). No-op when rid is unknown or the ids are equal."""
        if alias_id == rid:
            return
        with self._lock:
            if rid in self._by_id:
                self._aliases[alias_id] = rid

    def event(self, rid: str | None, kind: str, **attrs) -> None:
        """Append one typed event. rid=None reads the request-id
        contextvar. Unknown ids are dropped silently: recording is always
        on, so a caller that never opened a timeline (tests driving the
        engine directly) costs one dict lookup and nothing else."""
        if kind not in EVENT_KINDS:
            raise ValueError(f"unknown timeline event kind {kind!r}: add "
                             "it to obs.timeline.EVENT_KINDS")
        if rid is None:
            rid = current_request_id()
            if rid is None:
                return
        t_us = time.perf_counter_ns() // 1000
        with self._lock:
            tl = self._by_id.get(rid)
            if tl is None:
                canon = self._aliases.get(rid)
                tl = self._by_id.get(canon) if canon else None
            if tl is None:
                return
            if len(tl.events) >= self.max_events and kind not in _TERMINAL:
                tl.dropped += 1
                return
            ev = {"t_ms": round((t_us - tl.t0_us) / 1e3, 3), "kind": kind}
            if attrs:
                ev.update(attrs)
            tl.events.append(ev)

    # -- views ---------------------------------------------------------------

    def get(self, rid: str) -> dict | None:
        """JSON-shaped snapshot of one timeline (by id or alias). `t_ms` is
        milliseconds since the timeline opened; `start_unix` anchors the
        monotonic offsets to the wall clock."""
        with self._lock:
            tl = self._by_id.get(rid) or self._by_id.get(
                self._aliases.get(rid, ""))
            if tl is None:
                return None
            return {
                "request_id": tl.rid,
                "tier": tl.tier,
                "start_unix": round(tl.start_unix, 6),
                "events": [dict(e) for e in tl.events],
                "dropped": tl.dropped,
            }

    def ids(self) -> list[str]:
        """Known request ids, oldest first."""
        with self._lock:
            return list(self._by_id.keys())

    def to_chrome(self, rid: str) -> dict | None:
        """One timeline as Chrome-trace instant events on the span
        recorder's perf_counter-microsecond clock, so the export merges
        with RECORDER.export() in Perfetto."""
        with self._lock:
            tl = self._by_id.get(rid) or self._by_id.get(
                self._aliases.get(rid, ""))
            if tl is None:
                return None
            events = []
            for e in tl.events:
                args = {k: v for k, v in e.items() if k != "kind"}
                args["request_id"] = tl.rid
                args["tier"] = tl.tier
                events.append(
                    {"name": e["kind"], "cat": "request", "ph": "i",
                     "s": "t", "ts": int(tl.t0_us + e["t_ms"] * 1e3),
                     "pid": 0, "tid": 0, "args": args})
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def clear(self) -> None:
        with self._lock:
            self._by_id.clear()
            self._aliases.clear()


# process-global store: the API handlers and the serve engine record into
# this one ring
TIMELINES = TimelineStore()
