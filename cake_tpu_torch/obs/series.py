"""In-process time-series rings: the telemetry plane's storage primitive
(the port's own copy of cake_tpu/obs/series.py).

The fleet telemetry rollup (fleet/telemetry.py) needs signals *over
time* — burn rates are windowed deltas of cumulative counters, headroom
is a windowed token rate — but this project deliberately has no external
TSDB. A `Series` is the smallest thing that works instead: a fixed
window of (t, value) samples in a deque, appended once per router probe
cycle, pruned by age on every append, and bounded by a hard sample cap
so a misconfigured window can never grow memory without limit.

Two read idioms cover every consumer:

- gauges (queue depth, occupancy, headroom): `latest()` / `values()`;
- cumulative counters (request totals, token totals, SLO-violation
  counts): `increase(window_s)` — the sum of positive deltas across the
  window, which is Prometheus `increase()` semantics and therefore
  survives a replica restart resetting its counters to zero mid-window
  (the drop is ignored; counting resumes from the new baseline).

The clock is injectable (defaults to obs.now, the monotonic perf
counter) so the burn-rate / rollup math is unit-testable with a fake
clock — no sleeps in tier-1.
"""
from __future__ import annotations

import threading
from collections import deque

from .timing import now

__all__ = ["Series", "SeriesBank"]


class Series:
    """One signal's fixed-window ring of (t, value) samples.

    Thread-safe: the router's probe loop appends and HTTP handlers read,
    and nothing here assumes they share an event loop.
    """

    def __init__(self, name: str, window_s: float, max_samples: int = 4096,
                 clock=now):
        self.name = name
        self.window_s = float(window_s)
        self._clock = clock
        self._lock = threading.Lock()
        # ring of (t, value); guarded-by: self._lock
        self._ring: deque = deque(maxlen=max(int(max_samples), 2))

    def record(self, value: float, t: float | None = None) -> None:
        """Append one sample and prune everything older than the window."""
        t = self._clock() if t is None else float(t)
        with self._lock:
            self._ring.append((t, float(value)))
            cutoff = t - self.window_s
            while len(self._ring) > 1 and self._ring[0][0] < cutoff:
                self._ring.popleft()

    def samples(self) -> list[tuple[float, float]]:
        with self._lock:
            return list(self._ring)

    def values(self, window_s: float | None = None) -> list[float]:
        """Sample values inside the trailing window (newest-clock-relative)."""
        with self._lock:
            if not self._ring:
                return []
            cutoff = self._ring[-1][0] - (self.window_s if window_s is None
                                          else float(window_s))
            return [v for t, v in self._ring if t >= cutoff]

    def latest(self) -> float | None:
        with self._lock:
            return self._ring[-1][1] if self._ring else None

    def latest_t(self) -> float | None:
        with self._lock:
            return self._ring[-1][0] if self._ring else None

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def increase(self, window_s: float | None = None) -> float:
        """Prometheus-style increase of a cumulative counter over the
        trailing window: the sum of positive sample-to-sample deltas,
        starting from the last sample at or before the window boundary
        (so the full span counts). Negative deltas — a replica restart
        resetting its counter — contribute nothing instead of poisoning
        the sum."""
        win = self.window_s if window_s is None else float(window_s)
        with self._lock:
            ring = list(self._ring)
        if len(ring) < 2:
            return 0.0
        cutoff = ring[-1][0] - win
        # baseline: last sample at/before the cutoff, else the oldest
        base_i = 0
        for i, (t, _) in enumerate(ring):
            if t <= cutoff:
                base_i = i
            else:
                break
        total = 0.0
        prev = ring[base_i][1]
        for _, v in ring[base_i + 1:]:
            if v > prev:
                total += v - prev
            prev = v
        return total

    def rate(self, window_s: float | None = None) -> float:
        """increase() divided by the actual covered span (0.0 until two
        samples exist)."""
        win = self.window_s if window_s is None else float(window_s)
        with self._lock:
            ring = list(self._ring)
        if len(ring) < 2:
            return 0.0
        span = min(win, ring[-1][0] - ring[0][0])
        if span <= 0:
            return 0.0
        return self.increase(win) / span


class SeriesBank:
    """Lazily-created named Series sharing one window/cap/clock — the
    telemetry plane keys these by signal name (and per-replica signals
    by "signal/replica")."""

    def __init__(self, window_s: float, max_samples: int = 4096, clock=now):
        self.window_s = float(window_s)
        self.max_samples = int(max_samples)
        self._clock = clock
        self._lock = threading.Lock()
        # name -> Series; guarded-by: self._lock
        self._series: dict[str, Series] = {}

    def series(self, name: str) -> Series:
        with self._lock:
            s = self._series.get(name)
            if s is None:
                s = self._series[name] = Series(
                    name, self.window_s, self.max_samples, self._clock)
            return s

    def record(self, name: str, value: float, t: float | None = None) -> None:
        self.series(name).record(value, t)

    def get(self, name: str) -> Series | None:
        with self._lock:
            return self._series.get(name)

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._series)

    def drop(self, prefix: str) -> None:
        """Forget every series whose name starts with `prefix` — used
        when a replica is removed so its per-replica signals don't
        linger in the bank forever."""
        with self._lock:
            for k in [k for k in self._series if k.startswith(prefix)]:
                del self._series[k]
