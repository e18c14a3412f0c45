"""Admission-plane glue for the chat endpoint (the port's own copy of
cake_tpu/api/qos.py: resolve_admission, admission_refusal), for the
standard-library handler in server.py.

The class/tenant resolution and the tenant-quota gate run BEFORE any
queue slot is consumed, and typed admission refusals map onto their
documented HTTP answers:

  * ``TenantQuotaExceeded`` -> 429, body ``{"type": "tenant_quota"}``,
    Retry-After from the bucket's refill horizon;
  * ``QueueFull``           -> 429, class-aware Retry-After (that class's
    backlog over its weighted service share);
  * ``EngineDraining``      -> 503 + Retry-After, so balancers fail the
    client over to a replica that is staying up.

The reference's job glue (`run_admitted_job`, `adopt_job_request_id`)
serves its image and audio endpoints and is not here.
"""
from __future__ import annotations

from ..obs import SERVE_QOS_SHEDS
from ..serve.admission import QueueFull, TenantQuotaExceeded, get_plane
from ..serve.engine import EngineDraining

__all__ = ["admission_refusal", "resolve_admission"]


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
    if isinstance(err, EngineDraining):
        handler.send_json({"error": str(err)}, 503,
                          {"Retry-After": str(err.retry_after_s)})
        return True
    return False
