"""The fleet's environment knobs: the CAKE_FLEET_*, CAKE_TELEM_*,
CAKE_SLO_*, CAKE_KVSHARE* and CAKE_SCALE_* variables the router tier and
the KV-share tier read, each with the reference's type and default
(cake_tpu/knobs.py), plus the few serving-wide ones they share. The
clamps stay where the reference applies them
(registry.MembershipPolicy.from_knobs, autoscale.ScalePolicy.from_knobs).

The port has no knob registry (ROADMAP "Lower down"); this table is the
fleet's own, read by the fleet and by the API server's KV-share wiring. As in the reference, the
environment is read on every call and an empty value means the default.
"""
from __future__ import annotations

import os

__all__ = ["KNOBS", "get", "get_str"]

# name -> (type, default)
KNOBS: dict[str, tuple[type, object]] = {
    # membership (registry.py)
    "CAKE_FLEET_PROBE_S": (float, 2.0),
    "CAKE_FLEET_EJECT_FAILS": (int, 3),
    "CAKE_FLEET_ERR_WINDOW": (int, 32),
    "CAKE_FLEET_ERR_RATE": (float, 0.5),
    "CAKE_FLEET_DEGRADED_TTFT_MS": (float, 0.0),
    "CAKE_FLEET_EJECT_S": (float, 5.0),
    "CAKE_FLEET_REPLICA_INFLIGHT": (int, 0),
    # routing, failover and shedding (router.py)
    "CAKE_FLEET_RETRIES": (int, 2),
    "CAKE_FLEET_BACKOFF_S": (float, 0.05),
    "CAKE_FLEET_HEDGE_MS": (float, 0.0),
    "CAKE_FLEET_MAX_INFLIGHT": (int, 0),
    "CAKE_FLEET_AFFINITY": (bool, True),
    "CAKE_FLEET_AFFINITY_BLOCKS": (int, 64),
    "CAKE_FLEET_ATTEMPT_TIMEOUT_S": (float, 0.0),
    "CAKE_FLEET_CONNECT_TIMEOUT_S": (float, 5.0),
    "CAKE_FLEET_FIRST_BYTE_TIMEOUT_S": (float, 120.0),
    "CAKE_FLEET_DISCOVER_S": (float, 0.0),
    "CAKE_FLEET_STREAM_RESUMES": (int, 1),
    "CAKE_FLEET_RESUME_BUFFER_KB": (int, 256),
    # the chaos seam (faults.py)
    "CAKE_FLEET_FAULT_PLAN": (str, None),
    # telemetry plane (telemetry.py)
    "CAKE_SLO_TTFT_MS": (float, 2000.0),
    "CAKE_SLO_ERR_RATE": (float, 0.01),
    "CAKE_TELEM_FAST_WINDOW_S": (float, 300.0),
    "CAKE_TELEM_SLOW_WINDOW_S": (float, 3600.0),
    "CAKE_TELEM_RING": (int, 4096),
    "CAKE_TELEM_OUTLIER_K": (float, 3.0),
    "CAKE_TELEM_OUTLIER_MIN_N": (int, 3),
    # serving-wide knobs the router shares with the replicas
    "CAKE_DRAIN_TIMEOUT_S": (float, 30.0),
    "CAKE_QOS_BATCH_SHED_FRAC": (float, 0.8),
    "CAKE_CLUSTER_KEY": (str, None),
    # the fleet-shared KV tier (kvshare/, router.py, the API server)
    "CAKE_KVSHARE": (bool, False),
    "CAKE_KVSHARE_FETCH_TIMEOUT_S": (float, 2.0),
    "CAKE_KVSHARE_INVENTORY": (int, 32),
    # the closed-loop autoscaler (autoscale.py, lifecycle.py)
    "CAKE_SCALE": (bool, False),
    "CAKE_SCALE_SPAWN_CMD": (str, None),
    "CAKE_SCALE_BURN_FAST": (float, 2.0),
    "CAKE_SCALE_HEADROOM_MIN": (float, 0.0),
    "CAKE_SCALE_HEADROOM_HIGH": (float, 0.0),
    "CAKE_SCALE_COOLDOWN_S": (float, 60.0),
    "CAKE_SCALE_MIN": (int, 1),
    "CAKE_SCALE_MAX": (int, 8),
    "CAKE_SCALE_WARMUP_S": (float, 30.0),
    "CAKE_SCALE_SPAWN_TIMEOUT_S": (float, 180.0),
    "CAKE_SCALE_DECISIONS": (int, 256),
}


def _parse_bool(raw: str) -> bool:
    return raw.strip().lower() not in ("0", "false", "off", "no")


def get(name: str):
    """Typed value of `name`: the parsed variable when set and non-empty,
    else the reference's default. An unknown name is a KeyError."""
    cast, default = KNOBS[name]
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    if cast is bool:
        return _parse_bool(raw)
    return cast(raw)


def get_str(name: str) -> str:
    """`get` for str knobs, "" when unset."""
    v = get(name)
    return "" if v is None else str(v)
