"""Per-tenant quotas: token-bucket rate limits and concurrent-inflight caps
(the port's own copy of cake_tpu/serve/admission/tenants.py: TenantPolicy,
parse_policies, TenantRegistry, TenantQuotaExceeded).

Tenancy is resolved per request from the ``X-Cake-Tenant`` header, or
from a bearer key's fingerprint, BEFORE any queue slot is consumed: a
tenant over its quota is answered with a typed 429 whose body carries
``"type": "tenant_quota"`` and never touches the admission queue or the
slot pool.

Policies come from the ``CAKE_QOS_TENANTS`` grammar::

    acme:rps=5,burst=10,inflight=4,max_class=standard;free:rps=1,inflight=1

  * entries separated by ``;``, fields by ``,``;
  * ``rps``       — request tokens per second refilled into the bucket
                    (0 / omitted = unlimited rate);
  * ``burst``     — bucket capacity (defaults to max(2*rps, 1));
  * ``inflight``  — max concurrently admitted requests (0 / omitted =
                    unlimited);
  * ``max_class`` — QoS ceiling: requests asking for a higher class are
                    clamped down (classes.clamp_class);
  * the tenant name ``*`` is a default policy for tenants not named.

DEFAULT-OPEN: a tenant with no matching policy (and no ``*`` entry) is
unlimited, so quotas are an operator opt-in.
"""
from __future__ import annotations

import os
import threading
from collections import OrderedDict

from ...obs import SERVE_TENANT_THROTTLES, now

__all__ = ["TenantPolicy", "TenantQuotaExceeded", "TenantRegistry",
           "parse_policies"]


class TenantQuotaExceeded(Exception):
    """Typed 429 answered before any queue slot is consumed. `reason`
    is "rate" (token bucket empty) or "inflight" (concurrency cap)."""

    def __init__(self, tenant: str, reason: str, retry_after_s: int = 1):
        super().__init__(
            f"tenant {tenant!r} over quota ({reason}); retry in "
            f"{retry_after_s}s")
        self.tenant = tenant
        self.reason = reason
        self.retry_after_s = retry_after_s

    def body(self) -> dict:
        """The typed 429 JSON body (the `tenant_quota` error type is
        the machine-readable contract clients key on)."""
        return {"error": str(self), "type": "tenant_quota",
                "tenant": self.tenant, "reason": self.reason}


class TenantPolicy:
    __slots__ = ("rps", "burst", "inflight", "max_class")

    def __init__(self, rps: float = 0.0, burst: float | None = None,
                 inflight: int = 0, max_class: str | None = None):
        self.rps = float(rps)
        self.burst = float(burst) if burst is not None \
            else max(2.0 * self.rps, 1.0)
        self.inflight = int(inflight)
        self.max_class = max_class


def parse_policies(spec: str | None) -> dict[str, TenantPolicy]:
    """CAKE_QOS_TENANTS grammar → {tenant: TenantPolicy}. Bad field
    names raise at parse (engine/server build time), not per request."""
    out: dict[str, TenantPolicy] = {}
    if not spec:
        return out
    for entry in str(spec).split(";"):
        entry = entry.strip()
        if not entry:
            continue
        name, _, fields = entry.partition(":")
        name = name.strip()
        if not name:
            raise ValueError(f"CAKE_QOS_TENANTS: empty tenant name in "
                             f"{entry!r}")
        kw: dict = {}
        for field in fields.split(","):
            field = field.strip()
            if not field:
                continue
            k, _, v = field.partition("=")
            k = k.strip()
            if k == "rps":
                kw["rps"] = float(v)
            elif k == "burst":
                kw["burst"] = float(v)
            elif k == "inflight":
                kw["inflight"] = int(v)
            elif k == "max_class":
                kw["max_class"] = v.strip().lower()
            else:
                raise ValueError(
                    f"CAKE_QOS_TENANTS: unknown field {k!r} (rps, "
                    f"burst, inflight, max_class)")
        out[name] = TenantPolicy(**kw)
    return out


class _Bucket:
    """One tenant's live accounting: token bucket (refilled lazily at
    read time from the monotonic clock) + inflight count."""

    __slots__ = ("policy", "tokens", "t_last", "inflight")

    def __init__(self, policy: TenantPolicy, t0: float):
        self.policy = policy
        self.tokens = policy.burst
        self.t_last = t0        # the registry's clock, not the wall —
                                # tests inject a fake clock
        self.inflight = 0


# live-bucket cap: tenant names are client-controlled when a `*`
# default policy exists, so the accounting dict must be bounded —
# idle buckets evict LRU past this (an evicted bucket refills to full
# burst on return, which only ever FAVORS the client)
MAX_BUCKETS = 4096


class TenantRegistry:
    """Thread-safe tenant admission: acquire() charges the bucket and
    takes an inflight slot, returning a release thunk the caller runs
    when the request reaches a terminal state."""

    def __init__(self, spec: str | None = None, clock=now):
        if spec is None:
            spec = os.environ.get("CAKE_QOS_TENANTS")
        self.policies = parse_policies(spec)
        self._clock = clock
        self._lock = threading.Lock()
        # guarded-by: self._lock
        self._buckets: "OrderedDict[str, _Bucket]" = OrderedDict()

    def policy(self, tenant: str | None) -> TenantPolicy | None:
        """The policy governing `tenant`: an exact entry, else the `*`
        default, else None (default-open)."""
        if tenant is None:
            return None
        return self.policies.get(tenant) or self.policies.get("*")

    def max_class(self, tenant: str | None) -> str | None:
        pol = self.policy(tenant)
        return pol.max_class if pol is not None else None

    def acquire(self, tenant: str | None):
        """Admit one request for `tenant`. Returns a release thunk
        (idempotent); raises TenantQuotaExceeded BEFORE any queue slot
        is consumed. Unconfigured tenants (or tenant None) are
        default-open: the thunk is a no-op."""
        pol = self.policy(tenant)
        if pol is None:
            return lambda: None
        # metric label: tenants matched only by the `*` default report
        # as "*" — the label stays operator-bounded even though the
        # header value is client-controlled
        label = tenant if tenant in self.policies else "*"
        with self._lock:
            b = self._buckets.get(tenant)
            if b is None:
                b = self._buckets[tenant] = _Bucket(pol, self._clock())
                while len(self._buckets) > MAX_BUCKETS:
                    # LRU-evict an idle bucket (never one holding
                    # inflight slots — its release thunk points at it)
                    victim = next((k for k, v in self._buckets.items()
                                   if v.inflight == 0 and v is not b),
                                  None)
                    if victim is None:
                        break
                    del self._buckets[victim]
            else:
                self._buckets.move_to_end(tenant)
            if pol.rps > 0:
                t = self._clock()
                b.tokens = min(pol.burst,
                               b.tokens + (t - b.t_last) * pol.rps)
                b.t_last = t
                if b.tokens < 1.0:
                    wait = (1.0 - b.tokens) / pol.rps
                    SERVE_TENANT_THROTTLES.inc(tenant=label,
                                               reason="rate")
                    raise TenantQuotaExceeded(
                        tenant, "rate",
                        retry_after_s=max(1, int(wait + 0.999)))
            if pol.inflight > 0 and b.inflight >= pol.inflight:
                SERVE_TENANT_THROTTLES.inc(tenant=label,
                                           reason="inflight")
                raise TenantQuotaExceeded(tenant, "inflight",
                                          retry_after_s=1)
            if pol.rps > 0:
                b.tokens -= 1.0
            b.inflight += 1
        released = threading.Event()

        def release():
            # idempotent: terminal paths (done callback, handler
            # finally, submit-failure unwind) may all fire
            if released.is_set():
                return
            released.set()
            with self._lock:
                b.inflight = max(b.inflight - 1, 0)
        return release

    def inflight_of(self, tenant: str) -> int:
        with self._lock:
            b = self._buckets.get(tenant)
            return b.inflight if b is not None else 0
