"""Fleet serving: a router tier over N `cli serve` replicas (counterpart of
cake_tpu/fleet/, module 15a of the port).

One engine survives crashes (serve/supervisor.py) and worker death
(cluster/master.py); this package makes N of them survive each other —
health-driven membership with a gray-failure eject -> half-open ->
readmit machine (registry.py), prefix-affinity routing with
deterministic failover (routing.py), router-level overload control and
the `cli route` process itself (router.py), the chaos drill seam
(faults.py), the telemetry plane that rolls per-replica signals up into
burn rates / headroom / anomaly flags (telemetry.py, the feed `cli top`
renders: top.py), the closed loop that acts on that feed — the pure
scaling controller (autoscale.py) and the replica lifecycle manager that
spawns, drains and reaps real serve processes (lifecycle.py) — and the
fleet-shared KV tier (kvshare/: prefix-blob fetch between replicas and
stream-blob migration). The reference's router is aiohttp; the port's
runs on the standard library's asyncio streams (http.py), and the
package imports neither torch nor any third-party package (kvshare's
replica agent, which moves pool tensors, loads lazily and only in a
replica), so a router starts in well under a second and never claims a
CUDA context. Its knobs are the table in knobs.py.

Not here yet: the userspace network chaos layer (the reference's
netem.py; ROADMAP module 15b's last part).
"""
from .autoscale import (Autoscaler, Decision, DecisionLog, ScalePolicy,
                        decide, select_victim)
from .lifecycle import ManagedReplica, ReplicaLifecycle
from .registry import (EJECTED, HALF_OPEN, HEALTHY, MembershipPolicy,
                       Replica, ReplicaRegistry, discover_replicas)
from .router import FleetRouter, create_router_app, serve_router
from .routing import (AFFINITY_BLOCK, affinity_key, conversation_head,
                      rank_replicas)
from .telemetry import FleetTelemetry

__all__ = [
    "Replica", "ReplicaRegistry", "MembershipPolicy", "discover_replicas",
    "HEALTHY", "EJECTED", "HALF_OPEN",
    "FleetRouter", "create_router_app", "serve_router", "FleetTelemetry",
    "affinity_key", "conversation_head", "rank_replicas", "AFFINITY_BLOCK",
    "Autoscaler", "Decision", "DecisionLog", "ScalePolicy", "decide",
    "select_victim", "ManagedReplica", "ReplicaLifecycle",
]
