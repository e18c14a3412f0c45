"""Engine flight recorder: a bounded ring of recent scheduler iterations
(the port's own copy of cake_tpu/serve/flight.py: FlightRecorder).

When the watchdog flags a wedge or the rebuild budget puts the engine
DOWN, the evidence of what the engine did in the seconds before is this
ring: every completed scheduler iteration appends one small record
(occupancy, dispatch + fetch wall ms, queue depth, admissions in flight,
and the paged pool's free and used blocks) into a ring of the last
`CAKE_FLIGHT_RECORDER` iterations (default 256), and the supervisor
dumps it to `CAKE_TRACE_DIR` as JSON.

Recording is a dict append under a lock per iteration. Dumping is the
slow path and only happens on the two failure classifications.
"""
from __future__ import annotations

import json
import logging
import os
import threading
import time
from collections import deque

__all__ = ["FlightRecorder"]

log = logging.getLogger("cake_tpu_torch.serve.flight")

DEFAULT_CAPACITY = 256      # the reference's CAKE_FLIGHT_RECORDER default


class FlightRecorder:
    """Thread-safe iteration ring + dump to disk. The scheduler thread
    records; the watchdog thread and the supervisor dump."""

    def __init__(self, capacity: int | None = None):
        if capacity is None:
            capacity = int(os.environ.get("CAKE_FLIGHT_RECORDER",
                                          DEFAULT_CAPACITY))
        self.capacity = max(int(capacity), 1)
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=self.capacity)
        self._seq = 0

    def record(self, **fields) -> None:
        """Append one iteration record; `t` (monotonic seconds) and a
        process-lifetime sequence number are stamped here."""
        with self._lock:
            self._seq += 1
            rec = {"seq": self._seq, "t": round(time.perf_counter(), 6)}
            rec.update(fields)
            self._ring.append(rec)

    def snapshot(self) -> list[dict]:
        with self._lock:
            return [dict(r) for r in self._ring]

    def dump(self, reason: str, extra: dict | None = None) -> str | None:
        """Write the ring to CAKE_TRACE_DIR as JSON. Returns the path, or
        None when no trace dir is set (the ring still lives in memory,
        snapshot()). Never raises: the dump runs inside failure handling,
        and a full disk must not turn a wedge flag into a supervisor
        crash."""
        trace_dir = os.environ.get("CAKE_TRACE_DIR")
        if not trace_dir:
            return None
        try:
            os.makedirs(trace_dir, exist_ok=True)
            with self._lock:
                seq = self._seq
                body = {"reason": reason, "pid": os.getpid(),
                        "iterations": [dict(r) for r in self._ring]}
            if extra:
                body.update(extra)
            path = os.path.join(
                trace_dir, f"cake-flight-{os.getpid()}-{seq}-{reason}.json")
            with open(path, "w") as f:
                json.dump(body, f)
            log.warning("flight recorder dumped %d iteration(s) to %s "
                        "(%s)", len(body["iterations"]), path, reason)
            return path
        except Exception:
            log.exception("flight recorder dump failed (%s)", reason)
            return None
