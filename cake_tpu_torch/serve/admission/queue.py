"""Bounded, class-aware admission queue with weighted-fair dequeue (the
port's own copy of cake_tpu/serve/admission/queue.py: AdmissionQueue,
QueueFull).

Items go into per-class deques and leave by DEFICIT ROUND ROBIN over the
class weights (Shreedhar & Varghese): each replenish round credits every
backlogged class with its weight, and pop() serves classes with credit
in priority order. Under saturation the service ratio converges to the
weight ratio (interactive chat drains ~8x faster than batch by default),
and batch still progresses every round (weights are validated > 0), so
neither side can starve the other. FIFO order holds WITHIN a class, so
single-class traffic behaves as the port's earlier single FIFO did.

Overflow is per class: a full batch lane sheds batch with a Retry-After
derived from the BATCH backlog and its service share, while interactive
admission stays open; the typed QueueFull carries the class so the
API's 429 can say which lane was full.

Thread-safe: producers are API handler threads, the consumer is the
engine's scheduler thread. Depth transitions publish into
cake_serve_queue_depth (total) and cake_serve_qos_queue_depth{qos} (per
class), summed across every live queue.
"""
from __future__ import annotations

import threading
import weakref
from collections import deque

from ...obs import SERVE_QOS_QUEUE_DEPTH, SERVE_QUEUE_DEPTH
from .classes import (QOS_CLASSES, class_bounds, class_of, class_weights,
                      merge_bounds, merge_weights, retry_after_for)

__all__ = ["AdmissionQueue", "QueueFull"]


class QueueFull(Exception):
    """Admission queue at capacity for the request's class;
    retry_after_s is the 429 hint, scaled by that class's backlog and
    service share."""

    def __init__(self, depth: int, retry_after_s: int = 1,
                 qos: str = "interactive"):
        super().__init__(
            f"admission queue full for class {qos!r} ({depth} waiting)")
        self.depth = depth
        self.retry_after_s = retry_after_s
        self.qos = qos


# every live AdmissionQueue, so depth transitions can publish the SUM
# (the reference's job queue shares the gauges with the request queue).
# Reentrant: a collected queue's finalizer republishes, and the collector
# may run it on a thread that is inside _publish already (with the
# reference's plain Lock that thread deadlocks on itself)
_BOARD_LOCK = threading.RLock()
_QUEUES: "weakref.WeakSet[AdmissionQueue]" = weakref.WeakSet()


def _publish():
    """Recompute and publish total + per-class depth across live
    queues. Called under no queue lock (depths are read racily — the
    gauges are monitoring, not bookkeeping; every transition republishes
    so they converge immediately)."""
    totals = {c: 0 for c in QOS_CLASSES}
    with _BOARD_LOCK:
        queues = list(_QUEUES)
    for q in queues:
        for c in QOS_CLASSES:
            totals[c] += q.depth_of(c)
    for c, n in totals.items():
        SERVE_QOS_QUEUE_DEPTH.set(n, qos=c)
    SERVE_QUEUE_DEPTH.set(sum(totals.values()))


class AdmissionQueue:
    """Class-aware bounded queue. `maxsize` is the default PER-CLASS
    bound (CAKE_QOS_BOUNDS overrides individual classes); `weights`
    override CAKE_QOS_WEIGHTS (tests)."""

    def __init__(self, maxsize: int = 64, weights: dict | None = None,
                 bounds: dict | None = None):
        if maxsize < 1:
            raise ValueError(f"queue maxsize must be >= 1, got {maxsize}")
        self.maxsize = maxsize
        # constructor overrides go through the SAME merge + validation
        # as the knob path: a partial dict fills from defaults, and a
        # non-positive weight is rejected here rather than hanging
        # pop() in an infinite zero-credit replenish loop (or KeyError-
        # killing the consumer thread on an unlisted class)
        self.weights = class_weights() if weights is None \
            else merge_weights(weights)
        self.bounds = class_bounds(maxsize) if bounds is None \
            else merge_bounds(maxsize, bounds)
        self._lock = threading.Lock()
        self._q: dict[str, deque] = {c: deque() for c in QOS_CLASSES}
        # DRR deficit credit per class; replenished one round at a time
        # when no backlogged class holds credit, reset when a class
        # empties (credit never accumulates across idle periods)
        self._deficit: dict[str, float] = {c: 0.0 for c in QOS_CLASSES}
        with _BOARD_LOCK:
            _QUEUES.add(self)
        # republish after this queue is collected, so a queue GC'd with
        # recently-counted depth cannot leave phantom backlog on the
        # gauges (finalizer holds no reference to self)
        weakref.finalize(self, _publish)
        _publish()

    # -- producers -----------------------------------------------------------

    def put(self, item, allow_extra: int = 0) -> None:
        """allow_extra raises the class bound transiently — the engine
        passes its free-slot count so a BURST against an idle pool is
        never 429ed just because arrivals outpace the one-admission-
        per-iteration drain (the bound counts requests waiting BEYOND
        available slots)."""
        qos = class_of(item)
        with self._lock:
            q = self._q[qos]
            if len(q) >= self.bounds[qos] + max(allow_extra, 0):
                raise QueueFull(
                    len(q), qos=qos,
                    retry_after_s=retry_after_for(len(q), qos,
                                                  self.weights))
            q.append(item)
        _publish()

    # -- consumer (weighted-fair) --------------------------------------------

    def pop(self):
        """Weighted-fair pop; None when empty. Classes holding deficit
        credit are served in priority order (FIFO within a class); when
        no backlogged class holds credit, one replenish round adds each
        backlogged class's weight — so over any saturated window the
        dequeue counts converge to the weight ratio, and every class
        with positive weight is served at least once per round (no
        starvation)."""
        with self._lock:
            if not any(self._q[c] for c in QOS_CLASSES):
                return None
            while True:
                for c in QOS_CLASSES:
                    if not self._q[c]:
                        # empty classes hold no credit: an idle class
                        # must not bank a burst allowance (DRR's
                        # reset-on-empty rule)
                        self._deficit[c] = 0.0
                        continue
                    if self._deficit[c] >= 1.0:
                        self._deficit[c] -= 1.0
                        item = self._q[c].popleft()
                        break
                else:
                    # nobody had credit: one replenish round
                    for c in QOS_CLASSES:
                        if self._q[c]:
                            self._deficit[c] += self.weights[c]
                    continue
                break
        _publish()
        return item

    # -- views / sweeps ------------------------------------------------------

    def depth(self) -> int:
        return sum(len(q) for q in self._q.values())

    def depth_of(self, qos: str) -> int:
        return len(self._q.get(qos, ()))

    def depths(self) -> dict:
        """{class: waiting} snapshot (health / Retry-After surfaces)."""
        return {c: len(self._q[c]) for c in QOS_CLASSES}

    def purge(self, pred) -> list:
        """Remove and return every queued item matching pred — the
        scheduler's per-iteration sweep of requests whose client
        vanished while waiting, so abandoned entries stop pinning queue
        capacity (and 429ing live clients) until they reach the head."""
        dropped = []
        with self._lock:
            for c in QOS_CLASSES:
                hit = [it for it in self._q[c] if pred(it)]
                if hit:
                    dropped.extend(hit)
                    self._q[c] = deque(it for it in self._q[c]
                                       if not pred(it))
        if dropped:
            _publish()
        return dropped

    def drain(self) -> list:
        """Remove and return everything queued (engine shutdown/crash),
        highest class first, FIFO within class."""
        with self._lock:
            items = []
            for c in QOS_CLASSES:
                items.extend(self._q[c])
                self._q[c].clear()
        _publish()
        return items
