"""Admission-plane glue for the chat and image endpoints (the port's own
copy of cake_tpu/api/qos.py: adopt_job_request_id, resolve_admission,
run_admitted_job, admission_refusal), for the standard-library handler in
server.py.

The class/tenant resolution and the tenant-quota gate run BEFORE any
queue slot is consumed, and typed admission refusals map onto their
documented HTTP answers:

  * ``TenantQuotaExceeded`` -> 429, body ``{"type": "tenant_quota"}``,
    Retry-After from the bucket's refill horizon;
  * ``QueueFull``           -> 429, class-aware Retry-After (that class's
    backlog over its weighted service share);
  * ``EngineDraining`` / ``JobsDraining`` -> 503 + Retry-After, so
    balancers fail the client over to a replica that is staying up.
"""
from __future__ import annotations

import contextlib
import uuid

from ..obs import (GENERATIONS, SERVE_QOS_SHEDS, TIMELINES, TRACE_HEADER,
                   set_request_id)
from ..serve.admission import (JobCancelled, JobsDraining, QueueFull,
                               TenantQuotaExceeded, get_plane)
from ..serve.engine import EngineDraining

__all__ = ["admission_refusal", "adopt_job_request_id", "resolve_admission",
           "run_admitted_job"]


def adopt_job_request_id(handler, kind: str) -> str:
    """Trace adoption for a job: an X-Cake-Request-Id header becomes THE
    id (contextvar, timeline key, response echo); without one a
    `<kind>-...` id is minted. /api/v1/requests/<id> then shows the job's
    enqueue -> admit -> finish."""
    rid = handler.headers.get(TRACE_HEADER) \
        or f"{kind}-" + uuid.uuid4().hex[:16]
    set_request_id(rid)
    TIMELINES.begin(rid)
    TIMELINES.event(rid, "received")
    return rid


def resolve_admission(handler, state, body: dict, default_qos: str):
    """(qos, tenant, release) for one request, or None once a refusal has
    been sent. Resolution order: endpoint default -> X-Cake-QoS header /
    body ``qos`` -> tenant policy clamp; then the tenant's token bucket
    and inflight cap are charged (typed 429 before any queue slot).
    `release` is an idempotent thunk the caller runs when the request
    reaches a terminal state (the handler's finally)."""
    plane = get_plane(state)
    try:
        qos, tenant = plane.resolve(handler.headers, body, default_qos)
    except ValueError as e:
        handler.send_json({"error": str(e)}, 400)
        return None
    try:
        release = plane.admit(tenant)
    except TenantQuotaExceeded as e:
        admission_refusal(handler, e)
        return None
    return qos, tenant, release


def run_admitted_job(handler, state, kind: str, fn, qos: str,
                     tenant: str | None, rid: str, release):
    """Submit `fn` as a GenerationJob and wait for it in the handler's
    thread. Returns the finished job, or None once an answer has been
    sent (or the client has gone, and the job was cancelled).

    Lock rule: an engine-less text model (the locked path) generates
    under state.lock, so a job holds it too and never runs a device
    forward beside a locked generation; with an engine, jobs run beside
    the batched decode."""
    from .state import await_job
    lock = state.lock if (state.engine is None and state.model is not None) \
        else contextlib.nullcontext()
    try:
        with lock:
            try:
                job = get_plane(state).submit_job(
                    kind, fn, qos=qos, tenant=tenant, request_id=rid)
            except Exception as e:
                if admission_refusal(handler, e):
                    GENERATIONS.inc(kind=kind, status="error")
                    return None
                raise
            if not await_job(job, handler.connection):
                GENERATIONS.inc(kind=kind, status="error")
                return None
    finally:
        release()
    err = job.result.get("error")
    if err is None:
        GENERATIONS.inc(kind=kind, status="ok")
        return job
    GENERATIONS.inc(kind=kind, status="error")
    if admission_refusal(handler, err):
        return None
    if isinstance(err, ValueError):
        # the user's input: sizes, parameter combinations
        handler.send_json({"error": str(err)}, 400)
        return None
    if isinstance(err, JobCancelled):
        handler.send_json({"error": f"{kind} generation cancelled"}, 503)
        return None
    raise err


def admission_refusal(handler, err: BaseException) -> bool:
    """Send a typed admission refusal's documented answer; False when
    `err` is not one (the caller decides)."""
    if isinstance(err, TenantQuotaExceeded):
        handler.send_json(err.body(), 429,
                          {"Retry-After": str(err.retry_after_s)})
        return True
    if isinstance(err, QueueFull):
        SERVE_QOS_SHEDS.inc(qos=err.qos)
        handler.send_json(
            {"error": f"server overloaded: admission queue full for "
                      f"class {err.qos!r}", "qos": err.qos}, 429,
            {"Retry-After": str(err.retry_after_s)})
        return True
    if isinstance(err, (EngineDraining, JobsDraining)):
        handler.send_json({"error": str(err)}, 503,
                          {"Retry-After": str(err.retry_after_s)})
        return True
    return False
