"""AdmissionPlane: the one front door the chat and image endpoints go
through (the port's own copy of cake_tpu/serve/admission/plane.py:
AdmissionPlane, get_plane, key_fingerprint).

The plane owns what comes BEFORE any scheduling:

  * tenancy: resolve the tenant (X-Cake-Tenant header, else the
    Authorization bearer credential's fingerprint), charge its token
    bucket and inflight cap (typed 429 ``tenant_quota`` before any
    queue slot);
  * class: resolve the QoS class (endpoint default, X-Cake-QoS header /
    ``qos`` body field override, tenant ceiling clamp);
  * heavy jobs: image generation runs as GenerationJobs on the plane's
    JobExecutor (jobs.py), queued in the same class-aware queue type;
  * drain: one flag mirrored by the engine's own drain, and the job
    lane's.

Chat requests flow into the ServeEngine, whose admission queue is the
class-aware AdmissionQueue. The executor's threads start at the first
job, so a plane costs no thread until then.
"""
from __future__ import annotations

import hashlib

from .classes import QOS_HEADER, TENANT_HEADER, resolve_class
from .jobs import GenerationJob, JobExecutor
from .tenants import TenantRegistry

__all__ = ["AdmissionPlane", "get_plane", "key_fingerprint"]


def key_fingerprint(credential: str) -> str:
    """Stable non-reversible tenant key for a bearer credential: what
    quotas match on and what observability records."""
    return "key-" + hashlib.blake2b(credential.encode(),
                                    digest_size=6).hexdigest()


class AdmissionPlane:
    def __init__(self, tenants: TenantRegistry | None = None,
                 jobs: JobExecutor | None = None):
        self.tenants = tenants if tenants is not None else TenantRegistry()
        self.jobs = jobs if jobs is not None else JobExecutor()
        self.draining = False

    # -- per-request resolution ----------------------------------------------

    @staticmethod
    def tenant_of(headers, authorization: str | None = None) -> str | None:
        """The tenant a request bills against: the explicit header wins;
        otherwise the Authorization bearer credential is FINGERPRINTED
        (``key-<12 hex>`` of its blake2b), so keyed deployments get quotas
        without a second header and the raw credential never reaches a
        timeline, a metric label or a log. None = anonymous
        (default-open)."""
        t = headers.get(TENANT_HEADER)
        if t:
            return t
        auth = authorization if authorization is not None \
            else headers.get("Authorization", "")
        if auth.startswith("Bearer "):
            cred = auth[7:].strip()
            return key_fingerprint(cred) if cred else None
        return None

    def resolve(self, headers, body: dict | None,
                endpoint_default: str) -> tuple[str, str | None]:
        """(qos, tenant) for one request: endpoint default, overridden by
        X-Cake-QoS / body ``qos``, clamped by the tenant's policy ceiling.
        Raises ValueError on an unknown class name (API: 400)."""
        tenant = self.tenant_of(headers)
        qos = resolve_class(
            endpoint_default, header=headers.get(QOS_HEADER),
            body_value=(body or {}).get("qos"),
            max_class=self.tenants.max_class(tenant))
        return qos, tenant

    def admit(self, tenant: str | None):
        """Charge the tenant's quota; returns an idempotent release thunk.
        Raises TenantQuotaExceeded (typed 429) before any queue slot is
        consumed."""
        return self.tenants.acquire(tenant)

    # -- heavy jobs ----------------------------------------------------------

    def submit_job(self, kind: str, fn, qos: str = "batch",
                   tenant: str | None = None,
                   request_id: str | None = None) -> GenerationJob:
        return self.jobs.submit(GenerationJob(kind, fn, qos=qos,
                                              tenant=tenant,
                                              request_id=request_id))

    # -- lifecycle -----------------------------------------------------------

    def begin_drain(self):
        self.draining = True
        self.jobs.begin_drain()

    def drain(self, timeout: float | None = None) -> bool:
        """Refuse new jobs and wait for the job lane to go idle."""
        self.draining = True
        return self.jobs.drain(timeout)

    def close(self):
        self.jobs.close()

    def health(self) -> dict:
        return {"draining": self.draining,
                "jobs_running": self.jobs.running_count(),
                "jobs_queued": self.jobs.queue.depth(),
                "job_workers": self.jobs.workers,
                "queue_by_class": self.jobs.queue.depths(),
                "tenant_policies": sorted(self.tenants.policies.keys())}


def get_plane(state) -> AdmissionPlane:
    """The (lazily created) plane attached to the API's state: handlers
    share one instance so tenant accounting spans every request."""
    plane = getattr(state, "plane", None)
    if plane is None:
        plane = AdmissionPlane()
        state.plane = plane
    return plane
