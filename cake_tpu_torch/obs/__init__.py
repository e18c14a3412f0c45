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
already has; none of it touches the card. `torch_trace` (obs/profile.py)
is the device-side profiler trace SD's trace_dir wraps a generation in.

The fleet router (fleet/) records the FLEET_* instruments here (the
KV-share tier's FLEET_KV_* and the autoscaler's FLEET_SCALE_* among
them) and keeps its time series in obs/series.py (Series, SeriesBank).
Not here yet: the reference's obs/catalog.py (ROADMAP module 15b's last
part).
"""
from __future__ import annotations

from .metrics import (LATENCY_BUCKETS, REGISTRY, Counter, Gauge, Histogram,
                      MetricsRegistry)
from .profile import torch_trace
from .series import Series, SeriesBank
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

SERVE_JOBS_RUNNING = REGISTRY.gauge(
    "cake_serve_jobs_running",
    "Heavy generation jobs (image diffusion / TTS) currently executing "
    "under the admission plane's CAKE_JOB_WORKERS bound",
    labelnames=("kind",))           # image | audio

SERVE_TENANT_THROTTLES = REGISTRY.counter(
    "cake_serve_tenant_throttled_total",
    "Requests/jobs refused 429 tenant_quota before any queue slot was "
    "consumed (only configured tenants can throttle, so cardinality is "
    "operator-bounded)",
    labelnames=("tenant", "reason"))    # rate | inflight


# -- fleet router tier (fleet/: router, registry, telemetry) ---------------
# The reference's FLEET_* instruments, with its names, labels and help
# text.

FLEET_REPLICAS = REGISTRY.gauge(
    "cake_fleet_replicas",
    "Registered replicas by membership state — the primary autoscaling "
    "signal (healthy shrinking or ejected growing means capacity loss)",
    labelnames=("state",))          # healthy | ejected | half_open |
                                    # draining

FLEET_REPLICA_QUEUE_DEPTH = REGISTRY.gauge(
    "cake_fleet_replica_queue_depth",
    "Per-replica admission-queue depth mirrored from the last /health "
    "probe (router-side autoscaling signal: sum across replicas is the "
    "fleet backlog)",
    labelnames=("replica",))

FLEET_REPLICA_OCCUPANCY = REGISTRY.gauge(
    "cake_fleet_replica_occupancy",
    "Per-replica KV occupancy [0, 1] mirrored from the last /health "
    "probe (paged pools report block occupancy, contiguous pools "
    "busy-slot fraction)",
    labelnames=("replica",))

FLEET_REPLICA_INFLIGHT = REGISTRY.gauge(
    "cake_fleet_replica_inflight",
    "Requests the router currently has proxied onto the replica "
    "(bounded by the per-replica in-flight cap)",
    labelnames=("replica",))

FLEET_SHEDS = REGISTRY.counter(
    "cake_fleet_sheds_total",
    "Requests shed 429 AT THE ROUTER before any replica admitted them",
    labelnames=("reason",))         # global | replica_cap | no_replica |
                                    # batch_pressure (QoS early shed)

FLEET_EJECTS = REGISTRY.counter(
    "cake_fleet_ejects_total",
    "Replica ejections from routing membership",
    labelnames=("replica", "reason", "evidence"))
                                        # reason: fails | error_rate |
                                        #   ttft_p95 | health
                                        # evidence: data (transport /
                                        #   request-path) | probe
                                        #   (health-probe-path only)

FLEET_READMITS = REGISTRY.counter(
    "cake_fleet_readmits_total",
    "Replicas readmitted to routing after a half-open trial succeeded",
    labelnames=("replica",))

FLEET_PARTITION_SECONDS = REGISTRY.counter(
    "cake_fleet_partition_seconds_total",
    "Cumulative seconds replicas have spent in a suspected-partition "
    "episode (ejected on data-path/transport evidence, not yet "
    "readmitted through a data-path trial)",
    labelnames=("replica",))

FLEET_RETRIES = REGISTRY.counter(
    "cake_fleet_retries_total",
    "Failover retries: attempts re-routed to another replica after a "
    "retryable failure (transport error, replica 5xx/429)")

FLEET_HEDGES = REGISTRY.counter(
    "cake_fleet_hedges_total",
    "Tail-hedged duplicates fired at a second replica after "
    "CAKE_FLEET_HEDGE_MS without a reply")

FLEET_PROXIED = REGISTRY.counter(
    "cake_fleet_requests_total",
    "Chat requests proxied through the fleet router",
    labelnames=("outcome",))        # ok | failed | shed | broken_stream

FLEET_STREAM_RESUMES = REGISTRY.counter(
    "cake_fleet_stream_resumes_total",
    "Transparent mid-stream resume attempts: streams broken after the "
    "commit point that the router spliced (or tried to) onto another "
    "replica in continuation mode",
    labelnames=("outcome",))        # ok | broken | error | exhausted |
                                    # overflow

# -- fleet-shared KV tier (fleet/kvshare/) -----------------------------------
# Cross-replica prefix-blob fetches and live stream-blob migrations; hit
# ratio is recomputed from the fetch counter each time it moves.

FLEET_KV_FETCHES = REGISTRY.counter(
    "cake_fleet_kv_fetches_total",
    "Cross-replica prefix-blob fetch attempts by a cache-cold replica "
    "before recomputing a prefill (fetch-before-recompute)",
    labelnames=("outcome",))        # hit | miss | timeout | error |
                                    # mismatch

FLEET_KV_FETCH_BYTES = REGISTRY.counter(
    "cake_fleet_kv_fetch_bytes_total",
    "Wire bytes of successfully fetched + installed prefix blobs")

FLEET_KV_MIGRATIONS = REGISTRY.counter(
    "cake_fleet_kv_migrations_total",
    "Live stream-blob migrations attempted by the router's resume plane "
    "(drain/rebalance/failover): shipped = blob installed at the new "
    "owner, source_miss / ship_error = fell back to continuation-mode "
    "re-prefill",
    labelnames=("outcome",))        # shipped | source_miss | ship_error

FLEET_KV_HIT_RATIO = REGISTRY.gauge(
    "cake_fleet_kv_hit_ratio",
    "Fraction of cross-replica prefix fetch attempts that installed a "
    "peer's blob (hit / all outcomes), over this process's lifetime")

# -- fleet telemetry plane (rollups the autoscaler will consume) -------------
# Computed once per probe cycle by fleet/telemetry.py from the in-process
# time-series rings — these are the decision-grade reductions (burn rate,
# headroom, anomaly flags), not raw mirrors.

FLEET_SLO_BURN_RATE = REGISTRY.gauge(
    "cake_fleet_slo_burn_rate",
    "Fleet SLO burn rate per alerting window (fast ~5m, slow ~1h): the "
    "windowed bad-request fraction (TTFT over CAKE_SLO_TTFT_MS, or "
    "errored) divided by the CAKE_SLO_ERR_RATE error budget; > 1 means "
    "the budget is burning faster than it accrues",
    labelnames=("window",))         # fast | slow

FLEET_HEADROOM_TOKENS = REGISTRY.gauge(
    "cake_fleet_headroom_tokens_per_s",
    "Estimated spare fleet decode capacity in tokens/s: per healthy "
    "replica, observed per-slot token rate x free slots x KV-free "
    "fraction, summed fleet-wide — the capacity signal the autoscaler "
    "scales on")

FLEET_REPLICA_OUTLIER = REGISTRY.gauge(
    "cake_fleet_replica_outlier",
    "1 while the replica's TTFT p95 or error rate diverges more than "
    "CAKE_TELEM_OUTLIER_K robust standard deviations from the fleet "
    "median (flagged in /fleet, never auto-ejected)",
    labelnames=("replica",))

FLEET_REPLICA_STALE = REGISTRY.gauge(
    "cake_fleet_replica_stale",
    "1 while the replica's last probe failed, so its mirrored gauges "
    "(queue depth, occupancy) have been retracted and telemetry rollups "
    "exclude it",
    labelnames=("replica",))

# -- fleet autoscale (the closed loop consuming the telemetry plane) ---------
# Written by fleet/autoscale.py (controller) and fleet/lifecycle.py
# (executor) inside the router process; CAKE_SCALE gates the whole loop.

FLEET_SCALE_ACTIONS = REGISTRY.counter(
    "cake_fleet_scale_actions_total",
    "Autoscaler actions EXECUTED (holds are not counted — the decisions "
    "ring at /api/v1/fleet/autoscale carries those): direction out/in, "
    "reason the trigger that fired (burn_fast / headroom_low / "
    "below_min / headroom_high)",
    labelnames=("direction", "reason"))

FLEET_SCALE_PENDING_SPAWNS = REGISTRY.gauge(
    "cake_fleet_scale_pending_spawns",
    "Replica processes spawned by the lifecycle manager still waiting "
    "for their /health to answer 200 (spawn-to-routable window; feeds "
    "the no-replica Retry-After during a cold start)")

FLEET_SCALE_MANAGED_REPLICAS = REGISTRY.gauge(
    "cake_fleet_scale_managed_replicas",
    "Replica processes whose OS lifetime the router's lifecycle manager "
    "owns (spawned by scale-out; retired by scale-in or reaped on "
    "unexpected death)")


# -- cluster instruments (cluster/: master, client, worker) -------------------

WORKER_FWD_SECONDS = REGISTRY.histogram(
    "cake_worker_forward_seconds",
    "Worker-side forward compute time per request (includes any in-band "
    "XLA compile)")

HOP_SECONDS = REGISTRY.histogram(
    "cake_cluster_hop_seconds",
    "Master-observed remote-hop latency split by phase "
    "(rtt | read | deser | fwd | ser | wire)",
    labelnames=("worker", "phase"))

CLUSTER_STAGE_FAILURES = REGISTRY.counter(
    "cake_cluster_stage_failures_total",
    "Classified remote-hop failures observed by the master",
    labelnames=("worker", "kind"))  # timeout | eof | conn | corrupt |
                                    # worker_error

CLUSTER_RECONNECTS = REGISTRY.counter(
    "cake_cluster_reconnects_total",
    "Successful master->worker channel re-establishments (reconnect + "
    "re-auth + re-assign) after a stage failure",
    labelnames=("worker",))

CLUSTER_REPLAYS = REGISTRY.counter(
    "cake_cluster_replays_total",
    "Rebuild-by-replay prefills run to reconstruct lost worker KV state "
    "mid-generation")

CLUSTER_DEGRADED = REGISTRY.gauge(
    "cake_cluster_degraded",
    "1 while a worker is quarantined with its retry budget exhausted "
    "(/health answers 503; the restore loop is probing)")

CLUSTER_HOP_DEGRADED = REGISTRY.gauge(
    "cake_cluster_hop_degraded",
    "1 while the hop's rolling RTT p95 exceeds CAKE_HOP_DEGRADED_MS "
    "(gray failure: slow-but-alive)",
    labelnames=("worker",))

WORKER_HEARTBEAT = REGISTRY.gauge(
    "cake_worker_heartbeat_age_seconds",
    "Seconds since the worker last handled any message, at the last "
    "heartbeat tick (worker-process registry)",
    labelnames=("worker",))


__all__ = [
    "Counter", "Gauge", "Histogram", "LATENCY_BUCKETS", "MetricsRegistry",
    "REGISTRY", "RECORDER", "SPAN_CATALOG", "SpanRecorder", "PhaseTimer",
    "now", "now_us", "configure", "torch_trace", "new_request_id",
    "set_request_id",
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
    "SERVE_JOBS_RUNNING", "SPEC_PROPOSED", "SPEC_ACCEPTED", "SPEC_ACCEPTED_LEN",
    "SPEC_BUCKET_ACCEPTED",
    "WORKER_FWD_SECONDS", "HOP_SECONDS", "CLUSTER_STAGE_FAILURES",
    "CLUSTER_RECONNECTS", "CLUSTER_REPLAYS", "CLUSTER_DEGRADED",
    "CLUSTER_HOP_DEGRADED", "WORKER_HEARTBEAT", "Series", "SeriesBank",
    "FLEET_REPLICAS",
    "FLEET_REPLICA_QUEUE_DEPTH",
    "FLEET_REPLICA_OCCUPANCY",
    "FLEET_REPLICA_INFLIGHT",
    "FLEET_SHEDS",
    "FLEET_EJECTS",
    "FLEET_READMITS",
    "FLEET_PARTITION_SECONDS",
    "FLEET_RETRIES",
    "FLEET_HEDGES",
    "FLEET_PROXIED",
    "FLEET_STREAM_RESUMES",
    "FLEET_KV_FETCHES",
    "FLEET_KV_FETCH_BYTES",
    "FLEET_KV_MIGRATIONS",
    "FLEET_KV_HIT_RATIO",
    "FLEET_SCALE_ACTIONS",
    "FLEET_SCALE_PENDING_SPAWNS",
    "FLEET_SCALE_MANAGED_REPLICAS",
    "FLEET_SLO_BURN_RATE",
    "FLEET_HEADROOM_TOKENS",
    "FLEET_REPLICA_OUTLIER",
    "FLEET_REPLICA_STALE",
]
