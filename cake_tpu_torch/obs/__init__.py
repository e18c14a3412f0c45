"""Observability for the port: the metrics registry, the span recorder,
request-id propagation, per-request timelines and the serving instruments
(the port's own copy of cake_tpu/obs/__init__.py, cut to what the served
path records).

One import gives a hot path everything it may record into:

    from ..obs import RECORDER, SERVE_TTFT_SECONDS, TIMELINES, now

Instruments are process-global and keep the reference's names, labels
and buckets, so a dashboard written for the reference reads the port:
the API server's /metrics renders REGISTRY, /api/v1/trace the RECORDER,
/api/v1/requests/<id> TIMELINES. Recording reads host values the caller
already has; none of it touches the card.

Not here yet: the speculative, cluster, fleet, worker and hop
instruments, the jobs gauge, and the reference's obs/series.py and
obs/catalog.py (they come with the modules that record them).
"""
from __future__ import annotations

from .metrics import (LATENCY_BUCKETS, REGISTRY, Counter, Gauge, Histogram,
                      MetricsRegistry)
from .spans import (DEFAULT_TRACE_EVENTS, RECORDER, SPAN_CATALOG,
                    SpanRecorder, current_request_id, new_request_id,
                    now_us, request_scope, set_request_id)
from .timeline import (DEFAULT_TRACE_REQUESTS, EVENT_KINDS, TIMELINES,
                       TRACE_HEADER, TimelineStore)
from .timing import PhaseTimer, now


def configure(env) -> None:
    """Apply the reference's trace variables from `env` to the process-wide
    RECORDER and TIMELINES (the one place the port reads them; `cli serve`
    calls it): CAKE_TRACE_DIR (set: the recorder records),
    CAKE_TRACE_EVENTS (its ring, 16384) and CAKE_TRACE_REQUESTS (the
    timelines kept, 256). Unset variables keep those defaults."""
    RECORDER.resize(int(env.get("CAKE_TRACE_EVENTS")
                        or DEFAULT_TRACE_EVENTS))
    if env.get("CAKE_TRACE_DIR"):
        RECORDER.enable()
    TIMELINES.capacity = max(int(env.get("CAKE_TRACE_REQUESTS")
                                 or DEFAULT_TRACE_REQUESTS), 1)


# -- serving instruments ------------------------------------------------------
# Declared once here so every layer shares the same series; registration is
# idempotent, so import order never matters.

TTFT_SECONDS = REGISTRY.histogram(
    "cake_ttft_seconds",
    "Time to first token per generation (prefill + first sample + fetch)")

DECODE_TOKEN_SECONDS = REGISTRY.histogram(
    "cake_decode_token_seconds",
    "Mean per-token decode latency per generation")

GENERATED_TOKENS = REGISTRY.counter(
    "cake_generated_tokens_total",
    "Tokens emitted by completed generations",
    labelnames=("path",))           # local | cluster | offload



def observe_generation(stats: dict, n_out: int, path: str) -> None:
    """A completed generation's TTFT, mean per-token decode time and
    emitted tokens (the reference's text_model._observe_generation):
    path "serve" for the engine, "offload" for an offloaded model."""
    TTFT_SECONDS.observe(stats["ttft_s"])
    ntok = stats.get("decode_tokens") or 0
    if ntok and stats.get("decode_s", 0) > 0:
        DECODE_TOKEN_SECONDS.observe(stats["decode_s"] / ntok)
    GENERATED_TOKENS.inc(n_out, path=path)


GENERATIONS = REGISTRY.counter(
    "cake_generations_total",
    "Completed generations by workload kind",
    labelnames=("kind", "status"))  # text | image | audio; ok | error

API_REQUESTS = REGISTRY.counter(
    "cake_api_requests_total",
    "HTTP requests served",
    labelnames=("endpoint", "status"))

API_REQUEST_SECONDS = REGISTRY.histogram(
    "cake_api_request_seconds",
    "HTTP request wall time",
    labelnames=("endpoint",))

SERVE_QUEUE_DEPTH = REGISTRY.gauge(
    "cake_serve_queue_depth",
    "Requests waiting in the continuous-batching admission queue")

SERVE_SLOTS_BUSY = REGISTRY.gauge(
    "cake_serve_slots_busy",
    "KV-cache slots currently decoding in the serve engine")

SERVE_QUEUE_WAIT_SECONDS = REGISTRY.histogram(
    "cake_serve_queue_wait_seconds",
    "Admission-queue wait per request (enqueue to slot assignment)")

SERVE_BATCH_OCCUPANCY = REGISTRY.histogram(
    "cake_serve_batch_occupancy",
    "Occupied slots per batched decode iteration",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128))

SERVE_PREFILL_CHUNKS = REGISTRY.histogram(
    "cake_serve_prefill_chunks",
    "Prefill chunks per admission (chunked-admission scheduling; 1 = the "
    "whole prompt fit one chunk)",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128))

SERVE_PREFIX_HITS = REGISTRY.counter(
    "cake_serve_prefix_cache_hits_total",
    "Admissions that spliced at least one cached prefix block")

SERVE_PREFIX_MISSES = REGISTRY.counter(
    "cake_serve_prefix_cache_misses_total",
    "Admissions that found no reusable prefix block")

SERVE_PREFIX_EVICTIONS = REGISTRY.counter(
    "cake_serve_prefix_cache_evictions_total",
    "Prefix blocks evicted (LRU) to stay under CAKE_PREFIX_CACHE_MB")

SERVE_PREFIX_BYTES = REGISTRY.gauge(
    "cake_serve_prefix_cache_bytes",
    "Device bytes held by cached prefix blocks")

SERVE_TTFT_SECONDS = REGISTRY.histogram(
    "cake_serve_ttft_seconds",
    "Serve-engine time to first token (enqueue to the first token "
    "FETCHED on the host), by request outcome",
    labelnames=("outcome",))        # ok | cancelled | error

SERVE_ITL_SECONDS = REGISTRY.histogram(
    "cake_serve_itl_seconds",
    "Serve-engine mean inter-token latency per request (decode wall "
    "time / decoded tokens), by request outcome",
    labelnames=("outcome",))

SERVE_E2E_SECONDS = REGISTRY.histogram(
    "cake_serve_e2e_seconds",
    "Serve-engine end-to-end request latency (enqueue to terminal "
    "delivery, including queue wait and any preemption/replay), by "
    "request outcome",
    labelnames=("outcome",))

SERVE_QUEUE_TIMEOUTS = REGISTRY.counter(
    "cake_serve_queue_timeouts_total",
    "Requests expired in the admission queue past CAKE_QUEUE_DEADLINE_S "
    "(answered 503 instead of occupying a slot for a client that gave up)")

SERVE_STEP_FAILURES = REGISTRY.counter(
    "cake_serve_step_failures_total",
    "Classified serve-engine step failures handled by the supervisor",
    labelnames=("kind",))           # wedge | device | poison | oom |
                                    # internal

SERVE_ENGINE_REBUILDS = REGISTRY.counter(
    "cake_serve_engine_rebuilds_total",
    "Slot-pool rebuild-by-replay recoveries after a step failure")

SERVE_ENGINE_WEDGES = REGISTRY.counter(
    "cake_serve_engine_wedges_total",
    "Watchdog detections of a device dispatch stuck past "
    "CAKE_STEP_WATCHDOG_S (the engine reports wedged in /health)")

SERVE_ENGINE_DOWN = REGISTRY.gauge(
    "cake_serve_engine_down",
    "1 while the engine's rebuild budget is exhausted (submits answer "
    "503 + Retry-After; the restore loop is probing the device)")

SERVE_POISONED = REGISTRY.counter(
    "cake_serve_poisoned_requests_total",
    "Requests failed as poison (implicated in consecutive engine "
    "crashes) and fingerprint-quarantined")

SERVE_REQUEST_TIMEOUTS = REGISTRY.counter(
    "cake_serve_request_timeouts_total",
    "Admitted requests cancelled because their total age passed "
    "CAKE_REQUEST_DEADLINE_S (answered 504)")

SERVE_KV_BLOCKS_FREE = REGISTRY.gauge(
    "cake_serve_kv_blocks_free",
    "Unallocated physical blocks in the paged KV pool "
    "(CAKE_KV_BLOCKS > 0)")

SERVE_KV_BLOCKS_USED = REGISTRY.gauge(
    "cake_serve_kv_blocks_used",
    "Allocated physical blocks in the paged KV pool (live slots + "
    "prefix-cache pins)")

SERVE_KV_BLOCKS_SHARED = REGISTRY.gauge(
    "cake_serve_kv_blocks_shared",
    "Paged KV blocks with refcount >= 2 — prefix-cache hits share these "
    "by reference instead of copying")

SERVE_PREEMPTIONS = REGISTRY.counter(
    "cake_serve_preemptions_total",
    "Slots evicted because the paged KV pool was exhausted",
    labelnames=("mode",))           # swap | recompute

SPEC_PROPOSED = REGISTRY.counter(
    "cake_serve_spec_proposed_total",
    "Draft tokens proposed to speculative verify steps (local generate "
    "and serve-engine paths)")

SPEC_ACCEPTED = REGISTRY.counter(
    "cake_serve_spec_accepted_total",
    "Draft tokens accepted by speculative verify steps")

SPEC_ACCEPTED_LEN = REGISTRY.histogram(
    "cake_serve_spec_accepted_length",
    "Accepted draft tokens per speculative verify step (0 = every draft "
    "rejected; the step still emits its correction token)",
    buckets=(0, 1, 2, 3, 4, 6, 8, 12, 16))

SPEC_BUCKET_ACCEPTED = REGISTRY.histogram(
    "cake_serve_spec_bucket_accepted_length",
    "Accepted draft tokens per slot verify, labeled by the batched "
    "dispatch's slot-count bucket — the acceptance x occupancy tradeoff "
    "the serve bench reports",
    labelnames=("bucket",),
    buckets=(0, 1, 2, 3, 4, 6, 8, 12, 16))

SERVE_QOS_QUEUE_DEPTH = REGISTRY.gauge(
    "cake_serve_qos_queue_depth",
    "Queued requests + jobs per QoS class, summed across the admission "
    "plane's queues (chat, image, audio)",
    labelnames=("qos",))            # interactive | standard | batch

SERVE_QOS_TTFT_SECONDS = REGISTRY.histogram(
    "cake_serve_qos_ttft_seconds",
    "Serve-engine time to first token by QoS class and outcome — the "
    "per-class SLO the weighted-fair dequeue exists to protect",
    labelnames=("qos", "outcome"))

SERVE_QOS_E2E_SECONDS = REGISTRY.histogram(
    "cake_serve_qos_e2e_seconds",
    "End-to-end latency by QoS class and outcome, observed for engine "
    "requests AND heavy generation jobs (image/TTS)",
    labelnames=("qos", "outcome"))

SERVE_QOS_SHEDS = REGISTRY.counter(
    "cake_serve_qos_sheds_total",
    "Requests/jobs answered a class-aware 429 because their QoS "
    "class's queue lane was at its bound",
    labelnames=("qos",))

SERVE_TENANT_THROTTLES = REGISTRY.counter(
    "cake_serve_tenant_throttled_total",
    "Requests/jobs refused 429 tenant_quota before any queue slot was "
    "consumed (only configured tenants can throttle, so cardinality is "
    "operator-bounded)",
    labelnames=("tenant", "reason"))    # rate | inflight


__all__ = [
    "Counter", "Gauge", "Histogram", "LATENCY_BUCKETS", "MetricsRegistry",
    "REGISTRY", "RECORDER", "SPAN_CATALOG", "SpanRecorder", "PhaseTimer",
    "now", "now_us", "configure", "new_request_id", "set_request_id",
    "current_request_id", "request_scope", "EVENT_KINDS", "TIMELINES",
    "TimelineStore", "TRACE_HEADER",
    "TTFT_SECONDS", "DECODE_TOKEN_SECONDS", "GENERATED_TOKENS", "GENERATIONS",
    "observe_generation",
    "API_REQUESTS", "API_REQUEST_SECONDS", "SERVE_QUEUE_DEPTH",
    "SERVE_SLOTS_BUSY", "SERVE_QUEUE_WAIT_SECONDS", "SERVE_BATCH_OCCUPANCY",
    "SERVE_PREFILL_CHUNKS", "SERVE_PREFIX_HITS", "SERVE_PREFIX_MISSES",
    "SERVE_PREFIX_EVICTIONS", "SERVE_PREFIX_BYTES", "SERVE_TTFT_SECONDS",
    "SERVE_ITL_SECONDS", "SERVE_E2E_SECONDS", "SERVE_QUEUE_TIMEOUTS",
    "SERVE_STEP_FAILURES", "SERVE_ENGINE_REBUILDS", "SERVE_ENGINE_WEDGES",
    "SERVE_ENGINE_DOWN", "SERVE_POISONED", "SERVE_REQUEST_TIMEOUTS",
    "SERVE_KV_BLOCKS_FREE", "SERVE_KV_BLOCKS_USED", "SERVE_KV_BLOCKS_SHARED",
    "SERVE_PREEMPTIONS", "SERVE_QOS_QUEUE_DEPTH", "SERVE_QOS_TTFT_SECONDS",
    "SERVE_QOS_E2E_SECONDS", "SERVE_QOS_SHEDS", "SERVE_TENANT_THROTTLES",
    "SPEC_PROPOSED", "SPEC_ACCEPTED", "SPEC_ACCEPTED_LEN",
    "SPEC_BUCKET_ACCEPTED",
]
