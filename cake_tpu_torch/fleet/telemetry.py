"""Fleet telemetry plane: time-series rollups the autoscaler will consume
(the port's own copy of cake_tpu/fleet/telemetry.py: the same rollup,
scraped through the standard-library client of fleet/http.py).

The router's probe loop already sees every replica every cycle; this
module turns that stream into DECISION-GRADE signals instead of raw
mirrors. Once per cycle the router scrapes each replica's Prometheus
`/metrics` text (the SLO histograms live there with their buckets —
/api/v1/slo renders counts and exemplars but not bucket boundaries),
parses out the handful of families the rollup needs, and feeds
fixed-window rings (obs/series.py). On top of the rings it computes:

  * fleet-level SLO percentiles — bucket-wise SUMS of the per-replica
    cake_serve_{ttft,itl,e2e}_seconds histograms (identical boundaries:
    every replica registers them with LATENCY_BUCKETS) interpolated the
    histogram_quantile way;
  * multi-window BURN RATES — the windowed bad-request fraction (TTFT
    over CAKE_SLO_TTFT_MS, or outcome=error) divided by the
    CAKE_SLO_ERR_RATE budget, over a fast (~5m, page-worthy) and a slow
    (~1h, ticket-worthy) window — the Google SRE multi-window
    multi-burn-rate alert shape;
  * capacity HEADROOM — per replica, the observed per-slot token rate x
    free slots x KV-free fraction, summed over live replicas: an
    estimate in tokens/s of how much more decode the fleet could absorb
    right now;
  * per-replica ANOMALIES — a replica whose windowed TTFT p95 or error
    rate sits more than CAKE_TELEM_OUTLIER_K robust standard deviations
    (MAD-scaled) from the fleet median is flagged `outlier` in /fleet
    WITHOUT being ejected (the gray-failure detector generalized from
    RTT to every signal; ejection stays the membership machine's call).
    An unreachable (stale) replica is the degenerate outlier and is
    flagged immediately.

Stale replicas (last probe failed) are EXCLUDED from every rollup — the
registry retracts their mirrored gauges (see Replica.observe_health), so
a dead replica's frozen numbers can never average into fleet signals.

Everything is pure-math testable: `ingest()` takes raw scrape texts and
an optional timestamp, the clock is injectable, and the network lives
only in `collect()`. docs/telemetry.md is the operator guide.
"""
from __future__ import annotations

import asyncio
import re
from collections import deque

from . import knobs
from .http import request
from ..obs import (FLEET_HEADROOM_TOKENS, FLEET_SHEDS, FLEET_SLO_BURN_RATE,
                   SeriesBank, now)

__all__ = ["FleetTelemetry", "parse_prom_text", "replica_signals",
           "merge_histograms", "bucket_quantile", "detect_outliers"]

# robust-scale floors: with a homogeneous fleet the MAD is ~0 and any
# jitter would divide by nothing — the scale never drops below these
# (TTFT also keeps a 10%-of-median relative floor), so only divergence
# an operator would call real trips the flag
_TTFT_SCALE_FLOOR_S = 0.005
_ERR_SCALE_FLOOR = 0.02

# rollup-overhead ring length (the < 5ms bench gate averages these)
_OVERHEAD_SAMPLES = 128


# -- Prometheus text parsing -------------------------------------------------

# one compiled pass over the label block: quoted values may hold commas
# and escaped quotes, which rules out a naive split — this parser runs
# per scrape line per replica per probe cycle, so it has to be cheap
_LABEL_RE = re.compile(r'([A-Za-z_][A-Za-z0-9_:]*)="((?:\\.|[^"\\])*)"')


def parse_prom_text(text: str, prefix="cake_"):
    """Minimal Prometheus 0.0.4 sample parser: yields
    (name, labels_dict, value) for every sample line whose metric name
    starts with `prefix` (a str or tuple of strs). Tolerates anything it
    cannot parse (a replica mid rolling-upgrade must not break the
    whole rollup)."""
    out = []
    append = out.append
    for line in text.splitlines():
        if not line or line[0] == "#" or not line.startswith(prefix):
            continue
        try:
            brace = line.find("{")
            if brace >= 0:
                labelstr, _, valstr = line[brace + 1:].rpartition("}")
                name = line[:brace]
                labels = {}
                for k, v in _LABEL_RE.findall(labelstr):
                    if "\\" in v:
                        v = v.replace('\\"', '"').replace("\\n", "\n") \
                             .replace("\\\\", "\\")
                    labels[k] = v
            else:
                name, _, valstr = line.partition(" ")
                labels = {}
            append((name, labels, float(valstr)))
        except (ValueError, IndexError):
            continue
    return out


def _le(v: str) -> float:
    return float("inf") if v == "+Inf" else float(v)


def replica_signals(text: str) -> dict:
    """Reduce one replica's /metrics text to the signal dict the rollup
    consumes:

      hist[sem]     = (edges, cumulative_counts) for outcome=ok of
                      cake_serve_{sem}_seconds, sem in ttft/itl/e2e
      requests      = total finished requests (e2e _count, all outcomes)
      errors        = finished requests with outcome=error
      tokens        = cake_generated_tokens_total summed over paths
      queue_depth / slots_busy / kv_free / kv_used   = gauges (or None)
      spec_proposed / spec_accepted                  = counters
      qos_depth     = {class: queued depth} from the admission plane
                      (the autoscaler's QoS view: batch backlog is
                      visible but deliberately not a scale trigger)
    """
    sig = {"hist": {}, "requests": 0.0, "errors": 0.0, "tokens": 0.0,
           "queue_depth": None, "slots_busy": None,
           "kv_free": None, "kv_used": None,
           "spec_proposed": 0.0, "spec_accepted": 0.0,
           "qos_depth": {}}
    buckets: dict[str, dict[float, float]] = {}
    # only two families feed the rollup — skipping the rest at the
    # startswith check keeps the per-cycle parse cost flat no matter how
    # many instrument families a replica exports
    for name, labels, value in parse_prom_text(
            text, prefix=("cake_serve_", "cake_generated_tokens_total")):
        if name.startswith("cake_serve_") and name.endswith("_seconds_bucket"):
            sem = name[len("cake_serve_"):-len("_seconds_bucket")]
            if sem in ("ttft", "itl", "e2e") \
                    and labels.get("outcome") == "ok":
                buckets.setdefault(sem, {})[_le(labels["le"])] = value
        elif name == "cake_serve_e2e_seconds_count":
            sig["requests"] += value
            if labels.get("outcome") == "error":
                sig["errors"] += value
        elif name == "cake_generated_tokens_total":
            sig["tokens"] += value
        elif name == "cake_serve_queue_depth":
            sig["queue_depth"] = value
        elif name == "cake_serve_qos_queue_depth":
            cls = labels.get("qos") or "?"
            sig["qos_depth"][cls] = sig["qos_depth"].get(cls, 0.0) + value
        elif name == "cake_serve_slots_busy":
            sig["slots_busy"] = value
        elif name == "cake_serve_kv_blocks_free":
            sig["kv_free"] = value
        elif name == "cake_serve_kv_blocks_used":
            sig["kv_used"] = value
        elif name == "cake_serve_spec_proposed_total":
            sig["spec_proposed"] += value
        elif name == "cake_serve_spec_accepted_total":
            sig["spec_accepted"] += value
    for sem, by_le in buckets.items():
        edges = tuple(sorted(by_le))
        sig["hist"][sem] = (edges, tuple(by_le[e] for e in edges))
    return sig


# -- histogram math ----------------------------------------------------------

def merge_histograms(hists) -> tuple[tuple, tuple] | None:
    """Bucket-wise sum of cumulative histograms sharing identical
    boundaries. Histograms with mismatched edges are SKIPPED (and the
    caller reports how many) — summing misaligned buckets silently
    produces garbage percentiles."""
    ref = None
    acc = None
    for edges, counts in hists:
        if ref is None:
            ref = edges
            acc = list(counts)
        elif edges == ref:
            for i, c in enumerate(counts):
                acc[i] += c
        else:
            continue
    if ref is None:
        return None
    return ref, tuple(acc)


def bucket_quantile(edges, cum_counts, q: float) -> float | None:
    """histogram_quantile over one cumulative histogram: find the bucket
    the q-th observation falls in and interpolate linearly inside it.
    The +Inf bucket clamps to the last finite edge (there is no upper
    boundary to interpolate toward). None when the histogram is empty."""
    if not cum_counts:
        return None
    total = cum_counts[-1]
    if total <= 0:
        return None
    target = q * total
    lo = 0.0
    prev_cum = 0.0
    for edge, cum in zip(edges, cum_counts):
        if cum >= target:
            if edge == float("inf"):
                # clamp: the observation is beyond the last finite edge
                return lo
            in_bucket = cum - prev_cum
            if in_bucket <= 0:
                return edge
            frac = (target - prev_cum) / in_bucket
            return lo + (edge - lo) * frac
        lo = edge if edge != float("inf") else lo
        prev_cum = cum
    return lo


def ttft_over_slo(edges, cum_counts, slo_s: float) -> float:
    """How many of the histogram's observations exceeded the objective,
    at bucket resolution: total minus the cumulative count at the first
    edge >= slo_s (conservative — an observation in the straddling
    bucket counts as GOOD, so a bucket boundary sitting exactly on the
    objective behaves like Prometheus `le`)."""
    if not cum_counts:
        return 0.0
    total = cum_counts[-1]
    for edge, cum in zip(edges, cum_counts):
        if edge >= slo_s:
            return max(total - cum, 0.0)
    return 0.0


def detect_outliers(stats: dict, k: float, min_n: int) -> dict:
    """name -> reason for replicas whose TTFT p95 or error rate diverges
    > k robust standard deviations (1.4826 x MAD, floored) from the
    fleet median. Needs >= min_n replicas reporting the signal — a
    median over two cannot say which one is wrong."""
    flags: dict[str, str] = {}
    for key, reason, floor_abs, floor_rel in (
            ("ttft_p95_s", "ttft_p95", _TTFT_SCALE_FLOOR_S, 0.1),
            ("err_rate", "err_rate", _ERR_SCALE_FLOOR, 0.0)):
        pts = [(name, s[key]) for name, s in stats.items()
               if s.get(key) is not None]
        if len(pts) < max(min_n, 2):
            continue
        values = sorted(v for _, v in pts)
        med = _median(values)
        mad = _median(sorted(abs(v - med) for v in values))
        scale = max(1.4826 * mad, floor_abs, floor_rel * abs(med))
        for name, v in pts:
            if abs(v - med) > k * scale:
                flags.setdefault(name, reason)
    return flags


def _median(sorted_values) -> float:
    n = len(sorted_values)
    mid = n // 2
    if n % 2:
        return float(sorted_values[mid])
    return (sorted_values[mid - 1] + sorted_values[mid]) / 2.0


def _counter_total(metric) -> float:
    """Sum a labeled counter across every labelset (router-local sheds
    feed the dashboard's sheds/s)."""
    return sum(metric.value(**ls) for ls in metric.labelsets())


class _HistRing:
    """Fixed-window ring of one replica histogram's CUMULATIVE bucket
    vectors, so the rollup can compute windowed bucket deltas (what the
    fleet percentile is actually over). Counter resets (replica restart)
    are handled the Prometheus-increase way: a drop in the total count
    starts a fresh baseline instead of producing negative buckets.
    Event-loop-confined like the telemetry plane that owns it."""

    def __init__(self, window_s: float, max_samples: int, clock):
        self.window_s = float(window_s)
        self._clock = clock
        self._ring: deque = deque(maxlen=max(int(max_samples), 2))
        self.edges: tuple = ()

    def record(self, edges, cum_counts, t: float | None = None) -> None:
        t = self._clock() if t is None else float(t)
        if edges != self.edges:
            # boundary change = replica upgrade: old vectors are
            # incomparable, start over
            self._ring.clear()
            self.edges = tuple(edges)
        self._ring.append((t, tuple(cum_counts)))
        cutoff = t - self.window_s
        while len(self._ring) > 1 and self._ring[0][0] < cutoff:
            self._ring.popleft()

    def window_delta(self, window_s: float) -> tuple[tuple, tuple] | None:
        """(edges, windowed cumulative-count deltas) over the trailing
        window, reset-safe; None before the first sample."""
        if not self._ring:
            return None
        ring = list(self._ring)
        cutoff = ring[-1][0] - float(window_s)
        base_i = 0
        for i, (t, _) in enumerate(ring):
            if t <= cutoff:
                base_i = i
            else:
                break
        # fast path: no counter reset inside the window (the running
        # totals are monotone), so the windowed delta is simply
        # last - baseline per bucket — O(samples) on one scalar instead
        # of O(samples x buckets)
        base = ring[base_i][1]
        last = ring[-1][1]
        prev_total = base[-1] if base else 0.0
        reset = False
        for _, counts in ring[base_i + 1:]:
            if counts[-1] < prev_total:
                reset = True
                break
            prev_total = counts[-1]
        if not reset:
            acc = [max(c - b, 0.0) for c, b in zip(last, base)]
        else:
            acc = [0.0] * len(base)
            prev = base
            for _, counts in ring[base_i + 1:]:
                if counts[-1] < prev[-1]:   # reset: restart from zero
                    prev = tuple(0.0 for _ in counts)
                for i, c in enumerate(counts):
                    d = c - prev[i]
                    if d > 0:
                        acc[i] += d
                prev = counts
        if base_i == 0 and len(ring) >= 1 and sum(acc) == 0.0:
            # nothing but the first sample in the window: its cumulative
            # counts ARE the delta from the implicit zero baseline
            acc = list(ring[-1][1])
        return self.edges, tuple(acc)


# -- the plane ---------------------------------------------------------------

class FleetTelemetry:
    """The router's telemetry plane. `collect()` scrapes (async, network),
    `ingest()` is the pure rollup (sync, fake-clock testable), and
    `snapshot()` is what GET /api/v1/fleet/telemetry returns. All state
    is event-loop-confined to the router loop, matching the router's own
    handler state; the Series rings underneath carry their own locks."""

    def __init__(self, registry, *, clock=now,
                 fast_window_s: float | None = None,
                 slow_window_s: float | None = None,
                 slo_ttft_ms: float | None = None,
                 slo_err_rate: float | None = None,
                 outlier_k: float | None = None,
                 outlier_min_n: int | None = None,
                 ring: int | None = None):
        self.registry = registry
        self._clock = clock
        self.fast_window_s = fast_window_s if fast_window_s is not None \
            else knobs.get("CAKE_TELEM_FAST_WINDOW_S")
        self.slow_window_s = slow_window_s if slow_window_s is not None \
            else knobs.get("CAKE_TELEM_SLOW_WINDOW_S")
        self.slo_ttft_ms = slo_ttft_ms if slo_ttft_ms is not None \
            else knobs.get("CAKE_SLO_TTFT_MS")
        self.slo_err_rate = slo_err_rate if slo_err_rate is not None \
            else knobs.get("CAKE_SLO_ERR_RATE")
        self.outlier_k = outlier_k if outlier_k is not None \
            else knobs.get("CAKE_TELEM_OUTLIER_K")
        self.outlier_min_n = outlier_min_n if outlier_min_n is not None \
            else knobs.get("CAKE_TELEM_OUTLIER_MIN_N")
        ring = ring if ring is not None else knobs.get("CAKE_TELEM_RING")
        # rings retain the slow window: the slow burn rate needs it, and
        # everything faster reads a sub-window of the same samples
        self.bank = SeriesBank(self.slow_window_s, ring, clock)
        self._hists: dict[tuple[str, str], _HistRing] = {}
        self._per_slot: dict[str, float] = {}   # tok/s per busy slot
        self._overhead_ms: deque = deque(maxlen=_OVERHEAD_SAMPLES)
        self._last: dict = {}
        self._cycles = 0

    # -- scrape (network) ----------------------------------------------------

    async def collect(self, timeout_s: float = 2.0) -> dict:
        """Scrape every registered replica's /metrics concurrently.
        name -> text, or None when the replica was unreachable."""
        tmo = max(timeout_s, 0.2)

        async def fetch(rep):
            async with await request("GET", rep.base_url + "/metrics",
                                     connect_timeout=tmo) as r:
                if r.status != 200:
                    return None
                return (await r.read()).decode("utf-8", "replace")

        async def scrape(rep):
            try:
                return rep.name, await asyncio.wait_for(fetch(rep), tmo)
            except asyncio.CancelledError:
                raise
            except Exception:
                return rep.name, None
        pairs = await asyncio.gather(
            *(scrape(r) for r in self.registry.replicas()))
        return dict(pairs)

    async def step(self) -> None:
        """One probe-cycle turn: scrape, then roll up."""
        self.ingest(await self.collect())

    # -- rollup (pure) -------------------------------------------------------

    def ingest(self, scrapes: dict, t: float | None = None) -> dict:
        """Fold one cycle of raw scrape texts ({name: text|None}) into
        the rings and recompute every rollup. Returns (and caches) the
        snapshot body. Pure math on its inputs — tests drive it with
        synthetic texts and a fake clock."""
        t0 = now()
        t = self._clock() if t is None else float(t)
        self._cycles += 1
        live: dict[str, dict] = {}
        for name, text in scrapes.items():
            if text is None:
                continue
            sig = replica_signals(text)
            live[name] = sig
            self.bank.record(f"req/{name}", sig["requests"], t)
            self.bank.record(f"tok/{name}", sig["tokens"], t)
            self.bank.record(f"spec_prop/{name}", sig["spec_proposed"], t)
            self.bank.record(f"spec_acc/{name}", sig["spec_accepted"], t)
            if sig["slots_busy"] is not None:
                self.bank.record(f"busy/{name}", sig["slots_busy"], t)
            bad = sig["errors"]
            h = sig["hist"].get("ttft")
            if h is not None:
                bad += ttft_over_slo(*h, self.slo_ttft_ms / 1000.0)
            self.bank.record(f"bad/{name}", bad, t)
            for sem, (edges, counts) in sig["hist"].items():
                ring = self._hists.get((name, sem))
                if ring is None:
                    ring = self._hists[(name, sem)] = _HistRing(
                        self.slow_window_s, self.bank.max_samples,
                        self._clock)
                ring.record(edges, counts, t)

        body = self._rollup(scrapes, live, t)
        ms = (now() - t0) * 1000.0
        self._overhead_ms.append(ms)
        body["rollup_ms"] = {
            "last": round(ms, 3),
            "mean": round(sum(self._overhead_ms)
                          / len(self._overhead_ms), 3),
            "max": round(max(self._overhead_ms), 3)}
        self._last = body
        return body

    def _rollup(self, scrapes: dict, live: dict, t: float) -> dict:
        reps = {r.name: r for r in self.registry.replicas()}
        snaps = {name: rep.snapshot() for name, rep in reps.items()}
        # stale = this cycle's scrape failed OR the probe side already
        # marked it (either way its numbers must not enter the rollup)
        stale = {name for name in reps
                 if scrapes.get(name) is None or snaps[name].get("stale")}
        # ejected replicas drop out of the rollup like dead ones even
        # when their scrape/probe path still answers — the asymmetric
        # partition case (probe-alive, data-dead) would otherwise keep
        # contributing headroom the router cannot actually route to
        ejected = {name for name in reps
                   if snaps[name].get("state") == "ejected"}
        usable = [n for n in live if n not in stale and n not in ejected]

        # fleet percentiles: bucket-wise sums of windowed deltas
        percentiles: dict[str, dict] = {}
        skipped_mismatched = 0
        for sem in ("ttft", "itl", "e2e"):
            deltas, ref_edges = [], None
            for name in usable:
                ring = self._hists.get((name, sem))
                d = ring.window_delta(self.fast_window_s) if ring else None
                if d is None:
                    continue
                if ref_edges is None:
                    ref_edges = d[0]
                elif d[0] != ref_edges:
                    skipped_mismatched += 1
                    continue
                deltas.append(d)
            merged = merge_histograms(deltas)
            if merged is None:
                continue
            edges, counts = merged
            percentiles[sem] = {
                "p50": bucket_quantile(edges, counts, 0.50),
                "p95": bucket_quantile(edges, counts, 0.95),
                "p99": bucket_quantile(edges, counts, 0.99),
                "count": counts[-1] if counts else 0}

        # burn rates: windowed bad fraction / error budget
        burn = {}
        for label, win in (("fast", self.fast_window_s),
                           ("slow", self.slow_window_s)):
            req = bad = 0.0
            for name in usable:
                s_req = self.bank.get(f"req/{name}")
                s_bad = self.bank.get(f"bad/{name}")
                if s_req is not None:
                    req += s_req.increase(win)
                if s_bad is not None:
                    bad += s_bad.increase(win)
            frac = (bad / req) if req > 0 else 0.0
            burn[label] = round(frac / max(self.slo_err_rate, 1e-9), 4)
            FLEET_SLO_BURN_RATE.set(burn[label], window=label)

        # headroom: per-slot token rate x free slots x KV-free fraction
        headroom = 0.0
        replicas_out: dict[str, dict] = {}
        per_rep_stats: dict[str, dict] = {}
        for name, rep in reps.items():
            snap = snaps[name]
            sig = live.get(name)
            row = {"state": snap["state"],
                   "stale": name in stale,
                   "queue_depth": snap["queue_depth"],
                   "occupancy": snap["occupancy"],
                   "inflight": snap["inflight"],
                   "eject_evidence": snap.get("eject_evidence"),
                   "partition_s": snap.get("partition_s"),
                   "ttft_p95_ms": None, "err_rate": None,
                   "tokens_per_s": None, "accept_rate": None,
                   "headroom_tokens_per_s": 0.0}
            if sig is not None and name not in stale \
                    and name not in ejected:
                tok = self.bank.get(f"tok/{name}")
                rate = tok.rate(self.fast_window_s) if tok else 0.0
                row["tokens_per_s"] = round(rate, 3)
                busy_s = self.bank.get(f"busy/{name}")
                busy_vals = busy_s.values(self.fast_window_s) \
                    if busy_s else []
                busy_avg = (sum(busy_vals) / len(busy_vals)) \
                    if busy_vals else 0.0
                if rate > 0 and busy_avg > 0:
                    self._per_slot[name] = rate / max(busy_avg, 1.0)
                slots = reps[name].weight()    # probed engine slots
                busy_now = sig["slots_busy"] or 0.0
                free_slots = max(slots - busy_now, 0.0)
                if sig["kv_free"] is not None and sig["kv_used"] is not None \
                        and (sig["kv_free"] + sig["kv_used"]) > 0:
                    kv_free_frac = sig["kv_free"] / (sig["kv_free"]
                                                     + sig["kv_used"])
                else:
                    kv_free_frac = max(1.0 - snap["occupancy"], 0.0)
                hr = self._per_slot.get(name, 0.0) * free_slots \
                    * kv_free_frac
                row["headroom_tokens_per_s"] = round(hr, 3)
                headroom += hr
                # windowed per-replica SLO stats for the outlier detector
                ring = self._hists.get((name, "ttft"))
                d = ring.window_delta(self.fast_window_s) if ring else None
                p95 = bucket_quantile(*d, 0.95) if d else None
                if p95 is not None:
                    row["ttft_p95_ms"] = round(p95 * 1000.0, 3)
                s_req = self.bank.get(f"req/{name}")
                s_bad = self.bank.get(f"bad/{name}")
                inc_req = s_req.increase(self.fast_window_s) \
                    if s_req else 0.0
                inc_bad = s_bad.increase(self.fast_window_s) \
                    if s_bad else 0.0
                err = (inc_bad / inc_req) if inc_req > 0 else None
                if err is not None:
                    row["err_rate"] = round(err, 4)
                sp = self.bank.get(f"spec_prop/{name}")
                sa = self.bank.get(f"spec_acc/{name}")
                inc_p = sp.increase(self.fast_window_s) if sp else 0.0
                inc_a = sa.increase(self.fast_window_s) if sa else 0.0
                if inc_p > 0:
                    row["accept_rate"] = round(inc_a / inc_p, 4)
                per_rep_stats[name] = {"ttft_p95_s": p95, "err_rate": err}
            replicas_out[name] = row
        FLEET_HEADROOM_TOKENS.set(headroom)

        # anomalies: statistical outliers among the live, plus every
        # stale replica (unreachable is the degenerate outlier)
        flags = detect_outliers(per_rep_stats, self.outlier_k,
                                self.outlier_min_n)
        for name in stale:
            flags.setdefault(name, "stale")
        for name, rep in reps.items():
            reason = flags.get(name)
            rep.set_outlier(reason is not None, reason)
            replicas_out[name]["outlier"] = reason is not None
            replicas_out[name]["outlier_reason"] = reason

        # per-class backlog across usable replicas: the autoscaler reads
        # this for its decision detail — batch backlog is VISIBLE here but
        # never a scale trigger (interactive burn/headroom are; a deep
        # batch queue is exactly what the batch class is for)
        qos_backlog: dict[str, float] = {}
        for name in usable:
            sig = live.get(name)
            for cls, depth in (sig.get("qos_depth") or {}).items():
                qos_backlog[cls] = qos_backlog.get(cls, 0.0) + depth

        # fleet-level rings for dashboards (`cake top` sparklines)
        fleet_depth = sum(s["queue_depth"] for n, s in snaps.items()
                          if n not in stale)
        self.bank.record("fleet/headroom", headroom, t)
        self.bank.record("fleet/burn_fast", burn["fast"], t)
        self.bank.record("fleet/burn_slow", burn["slow"], t)
        self.bank.record("fleet/queue_depth", fleet_depth, t)
        self.bank.record("fleet/sheds", _counter_total(FLEET_SHEDS), t)
        sheds_s = self.bank.series("fleet/sheds").rate(self.fast_window_s)

        series = {}
        for key in ("fleet/headroom", "fleet/burn_fast",
                    "fleet/burn_slow", "fleet/queue_depth"):
            s = self.bank.get(key)
            if s is not None:
                # ages relative to now: the monotonic clock means
                # nothing across processes, an age does
                series[key] = [[round(t - st, 3), round(v, 4)]
                               for st, v in s.samples()]

        return {
            "cycles": self._cycles,
            "slo": {"ttft_ms": self.slo_ttft_ms,
                    "err_rate": self.slo_err_rate},
            "windows": {"fast_s": self.fast_window_s,
                        "slow_s": self.slow_window_s},
            "burn_rate": burn,
            "headroom_tokens_per_s": round(headroom, 3),
            "sheds_per_s": round(sheds_s, 4),
            "fleet_queue_depth": fleet_depth,
            "qos_backlog": {c: round(v, 1)
                            for c, v in sorted(qos_backlog.items())},
            "percentiles": percentiles,
            "mismatched_histograms_skipped": skipped_mismatched,
            "stale": sorted(stale),
            "outliers": {n: r for n, r in sorted(flags.items())},
            "replicas": replicas_out,
            "series": series,
        }

    # -- views ---------------------------------------------------------------

    def snapshot(self) -> dict:
        """Last rollup (what /api/v1/fleet/telemetry returns); an empty
        body with the configuration before the first cycle."""
        if self._last:
            return self._last
        return {"cycles": 0,
                "slo": {"ttft_ms": self.slo_ttft_ms,
                        "err_rate": self.slo_err_rate},
                "windows": {"fast_s": self.fast_window_s,
                            "slow_s": self.slow_window_s},
                "burn_rate": {"fast": 0.0, "slow": 0.0},
                "headroom_tokens_per_s": 0.0, "sheds_per_s": 0.0,
                "fleet_queue_depth": 0, "qos_backlog": {},
                "percentiles": {}, "stale": [],
                "outliers": {}, "replicas": {}, "series": {},
                "rollup_ms": {"last": 0.0, "mean": 0.0, "max": 0.0}}
