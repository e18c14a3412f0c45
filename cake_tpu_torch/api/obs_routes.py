"""Observability routes (the port's own copy of cake_tpu/api/obs_routes.py:
/metrics, /health, /api/v1/trace, /api/v1/requests[/<id>], /api/v1/slo,
/api/v1/flight), for the standard-library handler in server.py.

Each route returns (status, body, content type or None for JSON); the
handler sends it. /metrics renders the process-wide registry as text
exposition 0.0.4; /health keeps the engine block and status rules the
port's server answered before, plus the reference's `device` block (on
a card `torch.cuda.mem_get_info` and the caching allocator's counters in
place of JAX's memory_stats(); `{"platform": "cpu"}` on the CPU).
"""
from __future__ import annotations

import torch

from ..obs import (RECORDER, REGISTRY, SERVE_E2E_SECONDS, SERVE_ITL_SECONDS,
                   SERVE_TTFT_SECONDS, TIMELINES, now)

PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

# the coarse wedge fallback for an engine without a watchdog: work pending
# and no scheduler iteration for this long (the reference's)
ENGINE_WEDGED_S = 120.0

# process-start anchor on the monotonic clock: /health's
# started_at_age_s counts from here, so a watcher that sees it move
# backward knows a new process answers behind the same URL
_STARTED_AT = now()


def metrics(state, query) -> tuple:
    return 200, REGISTRY.render(), PROM_CONTENT_TYPE


def device_health(model) -> dict:
    """The model's accelerator: free and total bytes from
    `torch.cuda.mem_get_info`, in use and peak from the caching
    allocator. {"platform": "cpu"} for a model on the CPU."""
    dev = getattr(model, "device", None)
    if dev is None or dev.type != "cuda":
        return {"platform": "cpu"}
    try:
        free, total = torch.cuda.mem_get_info(dev)
        used = torch.cuda.memory_allocated(dev)
        return {"platform": "gpu", "device": torch.cuda.get_device_name(dev),
                "bytes_in_use": int(used), "bytes_limit": int(total),
                "bytes_free": int(free),
                "peak_bytes_in_use": int(torch.cuda.max_memory_allocated(dev)),
                "hbm_used_frac": round(used / total, 4) if total else 0.0}
    except Exception:
        return {"platform": "gpu"}


def health(state, query) -> tuple:
    """The engine's health, with its `prefix_cache`, in paged mode its
    `kv_pool`, and the supervisor's counts; 503 "degraded" while the
    engine is dead, wedged or DOWN, 503 "unavailable" while draining.
    With no engine (the locked path) the device block and the status,
    as the reference answers without one."""
    if state.engine is None:
        status = "unavailable" if state.draining else "ok"
        body = {"status": status,
                "started_at_age_s": round(now() - _STARTED_AT, 3),
                "device": device_health(state.model)}
        if state.draining:
            body["draining"] = True
        if state.plane is not None:
            body["admission"] = state.plane.health()
        return (200 if status == "ok" else 503), body, None
    h = state.engine.health()
    busy = h["slots_busy"] or h["queue_depth"]
    h["wedged"] = bool(h["wedged"]) or bool(
        busy and h["last_step_age_s"] > ENGINE_WEDGED_S)
    degraded = not h["alive"] or h["wedged"] or "down" in h
    status = ("degraded" if degraded
              else "unavailable" if h["draining"] else "ok")
    body = {"status": status, "engine": h,
            "started_at_age_s": round(now() - _STARTED_AT, 3),
            "device": device_health(state.model)}
    if state.plane is not None:
        body["admission"] = state.plane.health()
    return (200 if status == "ok" else 503), body, None


def trace(state, query) -> tuple:
    """Chrome-trace JSON of the span ring (open in Perfetto). ?clear=1
    drains the ring after the snapshot. 409 while the recorder is off
    (CAKE_TRACE_DIR turns it on)."""
    if not RECORDER.enabled:
        return 409, {"error": "span recorder disabled (set "
                              "CAKE_TRACE_DIR)"}, None
    body = RECORDER.to_chrome_trace()
    if query.get("clear", [""])[0] in ("1", "true"):
        RECORDER.clear()
    return 200, body, None


def request_index(state, query) -> tuple:
    """Recent request ids with retrievable timelines, oldest first."""
    return 200, {"requests": TIMELINES.ids()}, None


def request_timeline(state, query, rid: str) -> tuple:
    """One request's typed lifecycle timeline (by trace id or completion
    id); ?format=perfetto gives the same events as Chrome-trace instant
    events on the span recorder's clock."""
    if query.get("format", [""])[0] == "perfetto":
        body = TIMELINES.to_chrome(rid)
    else:
        body = TIMELINES.get(rid)
    if body is None:
        return 404, {"error": f"no timeline for request {rid!r} (evicted "
                              "from the ring, or never traced by this "
                              "process)"}, None
    return 200, body, None


def slo(state, query) -> tuple:
    """The TTFT / inter-token / e2e histograms by outcome, each bucket
    carrying its sampled exemplar request id."""
    out = {}
    for h in (SERVE_TTFT_SECONDS, SERVE_ITL_SECONDS, SERVE_E2E_SECONDS):
        series = []
        for labels in h.labelsets():
            n = h.count(**labels)
            series.append({
                "labels": labels,
                "count": n,
                "sum_s": round(h.sum(**labels), 6),
                "mean_s": round(h.sum(**labels) / n, 6) if n else 0.0,
                "exemplars": h.exemplars(**labels),
            })
        out[h.name] = {"help": h.help, "series": series}
    return 200, out, None


def flight(state, query) -> tuple:
    """The engine's flight-recorder ring on demand (?n=K for the last K
    iterations), a read-only snapshot under the recorder's own lock. 409
    without an engine or a recorder."""
    recorder = getattr(state.engine, "flight", None)
    if recorder is None:
        return 409, {"error": "no serve engine (or flight recorder) in "
                              "this process"}, None
    iterations = recorder.snapshot()
    n = query.get("n", [None])[0]
    if n is not None:
        try:
            iterations = iterations[-max(int(n), 0):]
        except ValueError:
            pass
    return 200, {"capacity": recorder.capacity, "count": len(iterations),
                 "iterations": iterations}, None


# exact GET paths -> route (the reference's canonical route patterns)
GET_ROUTES = {"/metrics": metrics, "/health": health, "/api/v1/trace": trace,
              "/api/v1/requests": request_index, "/api/v1/slo": slo,
              "/api/v1/flight": flight}
REQUEST_PREFIX = "/api/v1/requests/"
