"""Admission plane (the port's own copy of cake_tpu/serve/admission/):
weighted QoS classes, per-tenant quotas answered with typed 429s before
any queue slot is consumed, and the class-aware admission queue the serve
engine dequeues from, and the job executor (jobs.py) that runs image
generation through the same queue type."""
from .classes import (QOS_CLASSES, QOS_HEADER, TENANT_HEADER, class_bounds,
                      class_of, class_weights, clamp_class, priority,
                      resolve_class, retry_after_for)
from .jobs import GenerationJob, JobCancelled, JobExecutor, JobsDraining
from .plane import AdmissionPlane, get_plane
from .queue import AdmissionQueue, QueueFull
from .tenants import (TenantPolicy, TenantQuotaExceeded, TenantRegistry,
                      parse_policies)

__all__ = [
    "AdmissionPlane", "AdmissionQueue", "GenerationJob", "JobCancelled",
    "JobExecutor", "JobsDraining", "QOS_CLASSES", "QOS_HEADER",
    "QueueFull", "TENANT_HEADER", "TenantPolicy", "TenantQuotaExceeded",
    "TenantRegistry", "class_bounds", "class_of", "class_weights",
    "clamp_class", "get_plane", "parse_policies", "priority",
    "resolve_class", "retry_after_for",
]
