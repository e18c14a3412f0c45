"""Wall-clock helpers for hot paths (the port's own copy of
cake_tpu/obs/timing.py: now, PhaseTimer).

Every monotonic delta the serve engine and its supervisor take goes
through now(); phase accounting goes through PhaseTimer, which also
feeds the span recorder, so one `with timer("fwd"):` yields the rolling
total and a trace event.
"""
from __future__ import annotations

import contextlib
import time

from .spans import RECORDER


def now() -> float:
    """Monotonic seconds (perf_counter): the one clock hot-path deltas
    use."""
    return time.perf_counter()


class PhaseTimer:
    """Accumulating phase timer for hot loops.

        t = PhaseTimer()
        with t("embed"): ...
        with t("layers"): ...
        log.debug("%s", t)          # embed=0.2ms layers=8.1ms

    Each timed phase is also recorded as a span in the global RECORDER
    (when enabled), so the same instrumentation produces both the rolling
    log line and the Chrome-trace event.
    """

    def __init__(self, recorder=None):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}
        self._rec = RECORDER if recorder is None else recorder

    @contextlib.contextmanager
    def __call__(self, name: str, **span_args):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.add(name, dt, _span=False)
            if self._rec.enabled:
                self._rec.add(name, int(t0 * 1e6), int(dt * 1e6),
                              **span_args)

    def add(self, name: str, dt: float, t0: float | None = None,
            _span: bool = True):
        """Accumulate an externally measured duration (seconds). t0: the
        phase's real start on the perf_counter clock; without it the span
        is back-dated from now, which lays phases logged together on top
        of each other in the exported trace, so pass t0 whenever it is
        known."""
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1
        if _span and self._rec.enabled:
            if t0 is None:
                t0 = time.perf_counter() - dt
            self._rec.add(name, int(t0 * 1e6), int(dt * 1e6))

    def reset(self):
        self.totals.clear()
        self.counts.clear()

    def __str__(self):
        return " ".join(f"{k}={v * 1000:.1f}ms"
                        for k, v in self.totals.items())

    def report(self) -> dict[str, dict]:
        return {k: {"total_ms": round(v * 1000, 3),
                    "count": self.counts[k],
                    "avg_ms": round(v * 1000 / max(self.counts[k], 1), 3)}
                for k, v in self.totals.items()}
