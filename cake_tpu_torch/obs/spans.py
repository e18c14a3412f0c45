"""Span recorder: request-scoped phase spans with Chrome-trace export (the
port's own copy of cake_tpu/obs/spans.py: SpanRecorder, the request-id
contextvar helpers, SPAN_CATALOG).

Hot paths record bounded complete ("X") events tagged with the current
request id, and the buffer exports as Perfetto-loadable Chrome-trace JSON
({"traceEvents": [...]}) on demand or into $CAKE_TRACE_DIR.

The recorder is off by default (a disabled span() is one attribute
check) and turns on explicitly (RECORDER.enable()), or through the
CAKE_TRACE_DIR variable where `cli serve` applies it (obs.configure).
Timestamps are monotonic microseconds (perf_counter_ns), so exported
events satisfy Perfetto's monotonic-ts rule.

The serve engine's spans never wait on the card: a span that covers
device work ends at the scheduler iteration's one existing fetch (or,
with nothing to fetch, where the iteration's host work ends), so the
recorder adds no synchronisation and nothing is recorded inside a graph
capture. The reference's `jax_trace` (the JAX profiler hook) has its
counterpart in obs/profile.py (`torch_trace`).
"""
from __future__ import annotations

import contextlib
import contextvars
import json
import os
import threading
import time
import uuid
from collections import deque

__all__ = ["RECORDER", "SPAN_CATALOG", "SpanRecorder", "current_request_id",
           "new_request_id", "request_scope", "set_request_id"]

# the reference's CAKE_TRACE_EVENTS default
DEFAULT_TRACE_EVENTS = 16384

# -- request-id propagation --------------------------------------------------

_request_id: contextvars.ContextVar[str | None] = contextvars.ContextVar(
    "cake_request_id", default=None)


def new_request_id() -> str:
    return uuid.uuid4().hex[:16]


def set_request_id(rid: str | None):
    _request_id.set(rid)


def current_request_id() -> str | None:
    return _request_id.get()


@contextlib.contextmanager
def request_scope(rid: str | None = None):
    """Bind a request id for the duration of the block (generates one when
    not given); spans recorded inside carry it in their args."""
    rid = rid or new_request_id()
    token = _request_id.set(rid)
    try:
        yield rid
    finally:
        _request_id.reset(token)


def now_us() -> int:
    """Microseconds on the perf_counter clock (the events' `ts`)."""
    return time.perf_counter_ns() // 1000


class SpanRecorder:
    """Bounded ring buffer of Chrome-trace complete events."""

    def __init__(self, max_events: int = DEFAULT_TRACE_EVENTS,
                 enabled: bool = False):
        self._events: deque = deque(maxlen=max_events)
        self._lock = threading.Lock()
        self._export_seq = 0
        self.enabled = enabled

    def enable(self):
        self.enabled = True

    def disable(self):
        self.enabled = False

    def resize(self, max_events: int) -> None:
        """A new ring capacity, keeping the newest events."""
        with self._lock:
            self._events = deque(self._events, maxlen=max_events)

    def clear(self):
        with self._lock:
            self._events.clear()

    def __len__(self) -> int:
        return len(self._events)

    # -- recording -----------------------------------------------------------

    def add(self, name: str, ts_us: int, dur_us: int, cat: str = "phase",
            **args):
        """Record a complete event from externally measured timestamps
        (microseconds on the perf_counter clock)."""
        if not self.enabled:
            return
        rid = _request_id.get()
        if rid is not None:
            args.setdefault("request_id", rid)
        ev = {"name": name, "cat": cat, "ph": "X", "ts": int(ts_us),
              "dur": max(int(dur_us), 0), "pid": os.getpid(),
              "tid": threading.get_ident()}
        if args:
            ev["args"] = args
        with self._lock:
            self._events.append(ev)

    @contextlib.contextmanager
    def span(self, name: str, cat: str = "phase", **args):
        """Record the wrapped block as one complete event. Disabled-path
        cost is a single attribute check."""
        if not self.enabled:
            yield
            return
        t0 = now_us()
        try:
            yield
        finally:
            self.add(name, t0, now_us() - t0, cat=cat, **args)

    def instant(self, name: str, cat: str = "mark", **args):
        if not self.enabled:
            return
        rid = _request_id.get()
        if rid is not None:
            args.setdefault("request_id", rid)
        ev = {"name": name, "cat": cat, "ph": "i", "ts": now_us(), "s": "t",
              "pid": os.getpid(), "tid": threading.get_ident()}
        if args:
            ev["args"] = args
        with self._lock:
            self._events.append(ev)

    # -- export --------------------------------------------------------------

    def events(self) -> list[dict]:
        with self._lock:
            return [dict(e) for e in self._events]

    def to_chrome_trace(self) -> dict:
        return {"traceEvents": self.events(), "displayTimeUnit": "ms"}

    def export(self, path: str | None = None) -> str:
        """Write the buffer as Chrome-trace JSON (open in Perfetto or
        chrome://tracing). Default path:
        $CAKE_TRACE_DIR/cake-trace-<pid>-<n>.json."""
        if path is None:
            trace_dir = os.environ.get("CAKE_TRACE_DIR") or "."
            os.makedirs(trace_dir, exist_ok=True)
            with self._lock:
                self._export_seq += 1
                seq = self._export_seq
            path = os.path.join(trace_dir,
                                f"cake-trace-{os.getpid()}-{seq}.json")
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f)
        return path


# process-global recorder: the API handlers and the serve engine record
# into this one buffer, so a single export shows the whole request path
RECORDER = SpanRecorder()

# span vocabulary: every name the port records into RECORDER, with the
# layer that records it (the reference's table, cut to the spans of the
# served path, plus the handler's prompt span, which the reference lacks)
SPAN_CATALOG: tuple[tuple[str, str], ...] = (
    ("serve.step", "serve engine: one scheduler iteration (args: slots, "
                   "queued), ending after the iteration's fetch"),
    ("serve.prefill_chunk", "serve engine: one chunked-admission prefill "
                            "dispatch, from the chunk's replay to the "
                            "iteration's fetch"),
    ("serve.replay", "serve engine: one slot's crash/preemption replay, "
                     "to the fetch or the rebuild's wait that follows it"),
    ("spec.verify", "speculative verify dispatch (generate path and "
                    "batched serve path; on the serve path from the "
                    "verify's replay to the iteration's fetch)"),
    ("api.chat_prompt", "chat handler: the chat template and the "
                        "tokenizer's encode of one request's prompt"),
    ("layers", "per-token transformer layers; a cluster master's stage "
               "hops carry kind/start/end/worker args"),
    ("recover", "cluster master: quarantine->reconnect->replay cycle "
                "after a stage failure"),
    ("replay_prefill", "cluster master: rebuild-by-replay prefill "
                       "reconstructing lost worker KV"),
)
