"""Metrics registry: counters, gauges and histograms with labels and
Prometheus text exposition, format 0.0.4 (the port's own copy of
cake_tpu/obs/metrics.py: Counter, Gauge, Histogram, MetricsRegistry,
LATENCY_BUCKETS).

Instruments are process-global, cheap to update from hot loops (one dict
lookup and a float add under a lock), thread-safe (client threads and the
scheduler thread both record), and rendered on demand by the API's
/metrics route. The same operations render the same text as the
reference's registry, so a dashboard written for it reads the port.
"""
from __future__ import annotations

import threading

# latency buckets in seconds: sub-ms kernel dispatch through multi-minute
# cluster setup — shared by the TTFT / per-token / hop histograms
LATENCY_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0)


def _fmt(v: float) -> str:
    """Prometheus sample value formatting: integers without the '.0'."""
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _fmt_le(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    return _fmt(v)


def _escape(s: str) -> str:
    return s.replace("\\", "\\\\").replace("\n", "\\n").replace('"', '\\"')


class _Metric:
    typ = "untyped"

    def __init__(self, name: str, help: str, labelnames: tuple[str, ...],
                 lock: threading.RLock):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = lock
        self._values: dict[tuple, object] = {}

    def _key(self, labels: dict) -> tuple:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: labels {sorted(labels)} != declared "
                f"{sorted(self.labelnames)}")
        return tuple(str(labels[k]) for k in self.labelnames)

    def _label_str(self, key: tuple, extra: str = "") -> str:
        parts = [f'{n}="{_escape(v)}"' for n, v in zip(self.labelnames, key)]
        if extra:
            parts.append(extra)
        return "{" + ",".join(parts) + "}" if parts else ""

    def clear(self):
        with self._lock:
            self._values.clear()

    def remove(self, **labels) -> bool:
        """Delete one labelset's samples (Prometheus client `remove()`
        semantics): a retracted series disappears from scrapes instead of
        freezing at its last value. Returns whether the labelset
        existed."""
        key = self._key(labels)
        with self._lock:
            return self._values.pop(key, None) is not None

    def labelsets(self) -> list[dict]:
        """The label combinations observed so far (empty dict for an
        unlabeled metric with samples) — lets JSON surfaces enumerate a
        metric's series without reaching into _values."""
        with self._lock:
            return [dict(zip(self.labelnames, k)) for k in self._values]

    def samples(self) -> list[str]:
        raise NotImplementedError


class Counter(_Metric):
    typ = "counter"

    def inc(self, amount: float = 1.0, **labels):
        if amount < 0:
            raise ValueError(f"{self.name}: counters only go up")
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        return float(self._values.get(self._key(labels), 0.0))

    def samples(self) -> list[str]:
        with self._lock:
            items = sorted(self._values.items())
        return [f"{self.name}{self._label_str(k)} {_fmt(v)}"
                for k, v in items]


class Gauge(_Metric):
    typ = "gauge"

    def set(self, value: float, **labels):
        key = self._key(labels)
        with self._lock:
            self._values[key] = float(value)

    def inc(self, amount: float = 1.0, **labels):
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def dec(self, amount: float = 1.0, **labels):
        self.inc(-amount, **labels)

    def value(self, **labels) -> float:
        return float(self._values.get(self._key(labels), 0.0))

    def samples(self) -> list[str]:
        with self._lock:
            items = sorted(self._values.items())
        return [f"{self.name}{self._label_str(k)} {_fmt(v)}"
                for k, v in items]


class Histogram(_Metric):
    typ = "histogram"

    def __init__(self, name, help, labelnames, lock,
                 buckets=LATENCY_BUCKETS):
        super().__init__(name, help, labelnames, lock)
        bs = sorted(float(b) for b in buckets)
        if not bs:
            raise ValueError(f"{name}: histogram needs at least one bucket")
        self.buckets = tuple(bs)
        # per-labelset, per-bucket sampled exemplar: the LAST observation
        # that landed in each bucket, as (exemplar_id, value) — a bad
        # percentile in a scrape links to one concrete request id whose
        # timeline (/api/v1/requests/<id>) explains it. Bounded by
        # labelsets x buckets; exposed via exemplars(), not the
        # Prometheus text format (0.0.4 has no exemplar syntax)
        self._exemplars: dict[tuple, dict[int, tuple[str, float]]] = {}

    def observe(self, value: float, exemplar: str | None = None, **labels):
        key = self._key(labels)
        v = float(value)
        with self._lock:
            slot = self._values.get(key)
            if slot is None:
                # per-bucket counts (non-cumulative) + sum + count
                slot = self._values[key] = [[0] * (len(self.buckets) + 1),
                                            0.0, 0]
            counts, _, _ = slot
            idx = len(self.buckets)
            for i, b in enumerate(self.buckets):
                if v <= b:
                    idx = i
                    break
            counts[idx] += 1
            slot[1] += v
            slot[2] += 1
            if exemplar is not None:
                self._exemplars.setdefault(key, {})[idx] = (str(exemplar), v)

    def exemplars(self, **labels) -> dict:
        """{bucket_le: {"exemplar": id, "value": v}} for one labelset —
        each bucket's most recent exemplar-carrying observation."""
        key = self._key(labels)
        edges = [*self.buckets, float("inf")]
        with self._lock:
            ex = dict(self._exemplars.get(key, {}))
        return {_fmt_le(edges[i]): {"exemplar": rid, "value": v}
                for i, (rid, v) in sorted(ex.items())}

    def clear(self):
        with self._lock:
            self._values.clear()
            self._exemplars.clear()

    def remove(self, **labels) -> bool:
        key = self._key(labels)
        with self._lock:
            self._exemplars.pop(key, None)
            return self._values.pop(key, None) is not None

    def count(self, **labels) -> int:
        slot = self._values.get(self._key(labels))
        return 0 if slot is None else int(slot[2])

    def sum(self, **labels) -> float:
        slot = self._values.get(self._key(labels))
        return 0.0 if slot is None else float(slot[1])

    def samples(self) -> list[str]:
        with self._lock:
            items = sorted((k, ([*c], s, n))
                           for k, (c, s, n) in self._values.items())
        out = []
        edges = [*self.buckets, float("inf")]
        for key, (counts, total, n) in items:
            cum = 0
            for edge, c in zip(edges, counts):
                cum += c
                le = f'le="{_fmt_le(edge)}"'
                out.append(f"{self.name}_bucket"
                           f"{self._label_str(key, le)} {cum}")
            out.append(f"{self.name}_sum{self._label_str(key)} {_fmt(total)}")
            out.append(f"{self.name}_count{self._label_str(key)} {n}")
        return out


class MetricsRegistry:
    """Named-instrument registry. Registration is idempotent: asking again
    for the same (name, type, labels) returns the existing instrument, so
    modules can declare their instruments at import time in any order."""

    def __init__(self):
        self._lock = threading.RLock()
        self._metrics: dict[str, _Metric] = {}

    def _get(self, cls, name, help, labelnames, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if type(m) is not cls or m.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name!r} re-registered as {cls.typ} with "
                        f"labels {tuple(labelnames)}, was {m.typ} "
                        f"with {m.labelnames}")
                return m
            m = cls(name, help, tuple(labelnames), self._lock, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "",
                labelnames: tuple[str, ...] = ()) -> Counter:
        return self._get(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: tuple[str, ...] = ()) -> Gauge:
        return self._get(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: tuple[str, ...] = (),
                  buckets=LATENCY_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help, labelnames, buckets=buckets)

    def render(self) -> str:
        """Prometheus text exposition (0.0.4) of every instrument."""
        with self._lock:
            metrics = list(self._metrics.values())
        lines = []
        for m in metrics:
            if m.help:
                lines.append(f"# HELP {m.name} {_escape(m.help)}")
            lines.append(f"# TYPE {m.name} {m.typ}")
            lines.extend(m.samples())
        return "\n".join(lines) + "\n"

    def reset(self):
        """Zero every instrument's samples (registrations survive, so
        module-level instrument handles stay valid) — test isolation."""
        with self._lock:
            for m in self._metrics.values():
                m.clear()


# process-global default registry: hot paths update module-level instruments
# bound to it; the API /metrics endpoint renders it
REGISTRY = MetricsRegistry()
