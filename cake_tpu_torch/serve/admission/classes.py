"""QoS classes for the admission plane (the port's own copy of
cake_tpu/serve/admission/classes.py, whole).

Every generation workload is admitted under one of three weighted
classes (the port serves chat; the reference's image diffusion and TTS
endpoints default to batch):

  * ``interactive`` — latency-sensitive traffic a human is waiting on.
    Chat defaults here.
  * ``standard``    — ordinary API traffic with moderate latency needs.
  * ``batch``       — throughput traffic that tolerates queueing. Image
    and audio generation default here.

Classes are chosen by endpoint default, overridable per request via the
``X-Cake-QoS`` header or a ``qos`` body field, and CLAMPED by the
tenant's policy (a tenant capped at ``standard`` cannot buy its way into
``interactive`` with a header). The weighted-fair queue (queue.py) turns
the class weights into a service ratio under saturation — batch traffic
always progresses but can never starve chat — and the paged preemption
policy (serve/paged/preempt.py) evicts the lowest class first when the
KV pool runs out.
"""
from __future__ import annotations

import os

__all__ = ["QOS_CLASSES", "QOS_HEADER", "TENANT_HEADER", "priority",
           "class_of", "clamp_class", "resolve_class", "class_weights",
           "class_bounds", "merge_weights", "merge_bounds",
           "retry_after_for"]

# priority order: higher = served/preserved first. The tuple order is
# also the weighted-fair dequeue's visit order, so under equal credit
# the higher class goes first.
QOS_CLASSES = ("interactive", "standard", "batch")
_PRIORITY = {"interactive": 2, "standard": 1, "batch": 0}
_DEFAULT_WEIGHTS = {"interactive": 8, "standard": 4, "batch": 1}

QOS_HEADER = "X-Cake-QoS"
TENANT_HEADER = "X-Cake-Tenant"


def priority(qos: str) -> int:
    """Numeric priority of a class (higher = more latency-sensitive).
    Unknown strings rank as interactive so a foreign object in the
    victim pool is never preferentially evicted by accident."""
    return _PRIORITY.get(qos, _PRIORITY["interactive"])


def class_of(item) -> str:
    """The QoS class an enqueued item travels under (requests and jobs
    both carry .qos; anything else rides interactive)."""
    qos = getattr(item, "qos", None)
    return qos if qos in _PRIORITY else "interactive"


def clamp_class(qos: str, max_class: str | None) -> str:
    """Clamp a requested class by a tenant policy's ceiling: the result
    never outranks max_class (None = no ceiling)."""
    if max_class is None or max_class not in _PRIORITY:
        return qos
    if priority(qos) > _PRIORITY[max_class]:
        return max_class
    return qos


def resolve_class(default: str, header: str | None = None,
                  body_value=None, max_class: str | None = None) -> str:
    """The class one request is admitted under: the endpoint default
    (chat = interactive, images/audio = batch), overridden by the
    X-Cake-QoS header or the body's ``qos`` field (header wins), then
    clamped by the tenant ceiling. Unknown class names raise ValueError
    (the API answers 400 — a typo must not silently land in a default
    class the client did not ask for)."""
    chosen = default
    for raw in (body_value, header):
        if raw is None or raw == "":
            continue
        val = str(raw).strip().lower()
        if val not in _PRIORITY:
            raise ValueError(
                f"unknown QoS class {raw!r} (one of: "
                f"{', '.join(QOS_CLASSES)})")
        chosen = val
    return clamp_class(chosen, max_class)


def _parse_per_class(spec: str | None, cast, defaults: dict) -> dict:
    """``interactive=8,standard=4,batch=1`` → {class: value}, falling
    back to `defaults` for classes the spec omits. Unknown class names
    raise — a misspelled knob must fail loudly at engine build, not
    silently leave a class on its default."""
    out = dict(defaults)
    if not spec:
        return out
    for part in str(spec).split(","):
        part = part.strip()
        if not part:
            continue
        name, _, val = part.partition("=")
        name = name.strip().lower()
        if name not in _PRIORITY:
            raise ValueError(f"unknown QoS class {name!r} in {spec!r}")
        out[name] = cast(val.strip())
    return out


def merge_weights(overrides: dict) -> dict:
    """Partial per-class weight dict merged onto the defaults and
    VALIDATED (> 0, known classes only) — the same checks the knob
    path runs, so a constructor override can never hand the queue a
    zero-credit or missing class."""
    w = dict(_DEFAULT_WEIGHTS)
    for cls, val in overrides.items():
        if cls not in _PRIORITY:
            raise ValueError(f"unknown QoS class {cls!r} in weights")
        w[cls] = float(val)
    for cls, val in w.items():
        if val <= 0:
            raise ValueError(
                f"QoS weights: {cls} weight must be > 0 (got {val}) — "
                "a zero-weight class starves")
    return w


def merge_bounds(default: int, overrides: dict) -> dict:
    """Partial per-class bound dict merged onto `default`, validated
    (>= 1, known classes only)."""
    b = {c: int(default) for c in QOS_CLASSES}
    for cls, val in overrides.items():
        if cls not in _PRIORITY:
            raise ValueError(f"unknown QoS class {cls!r} in bounds")
        b[cls] = int(val)
    for cls, val in b.items():
        if val < 1:
            raise ValueError(
                f"QoS bounds: {cls} bound must be >= 1, got {val}")
    return b


def class_weights(spec: str | None = None) -> dict:
    """Weighted-fair dequeue weights per class (CAKE_QOS_WEIGHTS when
    `spec` is None). Weights must be positive: a zero-weight class would
    never accrue deficit credit and starve outright — exactly what the
    weighted queue exists to prevent."""
    if spec is None:
        spec = os.environ.get("CAKE_QOS_WEIGHTS")
    return merge_weights(_parse_per_class(spec, float, {}))


def class_bounds(default: int, spec: str | None = None) -> dict:
    """Per-class queue bounds (CAKE_QOS_BOUNDS when `spec` is None);
    classes the spec omits use `default` (the engine's max_queue)."""
    if spec is None:
        spec = os.environ.get("CAKE_QOS_BOUNDS")
    return merge_bounds(default, _parse_per_class(spec, int, {}))


def retry_after_for(depth: int, qos: str, weights: dict) -> int:
    """Class-aware Retry-After for a shed request: the wait scales with
    THAT class's backlog divided by its share of service — a shed batch
    request behind a deep batch queue is told to come back much later
    than a shed interactive request behind a shallow one."""
    total = sum(weights.values()) or 1.0
    share = weights.get(qos, 1.0) / total
    # one queue drain ~ a few service rounds; 8 matches the legacy
    # depth//8 heuristic at share=1
    return max(1, min(120, int(depth / max(share, 1e-6)) // 8))
