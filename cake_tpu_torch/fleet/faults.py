"""Deterministic fault injection for the fleet router's outbound path
(the port's own copy of cake_tpu/fleet/faults.py: the same clause
grammar, refusals and counting).

The membership state machine and failover retry logic exist to survive
replica failure — and, like the serve supervisor (serve/faults.py) and
the cluster wire (cluster/faults.py), every recovery path must be
drillable on one CPU without real crashes. This module hooks the
router's per-attempt seam: before the router opens an HTTP attempt
against a replica it consults `faults.FAULT_HOOK` (one attribute read
when disabled), and while relaying an SSE stream it asks the hook
whether to sever the relay mid-stream.

A fault plan is one `key=val[;key=val...]` clause from the
`CAKE_FLEET_FAULT_PLAN` env var (tests use `install()`/`clear()`). Keys:

    replica=NAME        target replica (required — fleet faults are
                        always per-replica; the point is asymmetry)
    refuse_after_ops=N  outbound attempt N (1-based, counted per target)
                        and later raise a simulated connection refusal —
                        the black-hole/kill drill (default 1 when
                        `refuse=1` alone is given)
    refuse_times=K      only attempts N..N+K-1 refuse (default: forever,
                        i.e. the replica stays dark until clear())
    stall_ms=S          every attempt against the target reports a stall
                        of S ms first (the router awaits it — gray
                        slow-but-alive, drives the TTFB p95 detector)
    break_stream_after=N  sever the SSE relay after N forwarded chunks —
                        the mid-stream failure drill (transparent
                        splice-resume under CAKE_FLEET_STREAM_RESUMES,
                        typed error event past the budget — never a
                        silent hang)
    break_times=K       sever only the first K streams to the target
                        (default: every stream) — lets a resume drill
                        break the owner once and then prove the SAME
                        replica serves clean splices afterwards

An "op" is one outbound ATTEMPT against the target replica (retries and
hedges count separately); the counter survives ejection/readmission
cycles, which is what makes eject -> half-open -> readmit drills
deterministic.
"""
from __future__ import annotations

import logging
from dataclasses import dataclass

from . import knobs

log = logging.getLogger("cake_tpu_torch.fleet.faults")

__all__ = ["FAULT_HOOK", "InjectedFleetFault", "FleetFaultInjector",
           "parse_plan", "install", "active", "clear"]

# the router's per-attempt seam: None (one attribute check) when disabled
FAULT_HOOK = None


class InjectedFleetFault(ConnectionError):
    """A planned outbound failure — a ConnectionError subclass so the
    router's transport-failure classification treats it exactly like a
    real refused/reset connection."""


@dataclass
class FleetFaultInjector:
    """One plan clause; the router invokes the hooks below per attempt.
    All state lives here so it survives the ejections it provokes."""

    replica: str = ""
    refuse_after_ops: int | None = None
    refuse_times: int | None = None     # None = refuse forever once armed
    stall_ms: float = 0.0
    break_stream_after: int | None = None
    break_times: int | None = None      # None = sever every stream
    ops: int = 0                        # attempts seen against the target
    streams_broken: int = 0             # severs already delivered

    _INT_KEYS = ("refuse_after_ops", "refuse_times", "break_stream_after",
                 "break_times")

    @classmethod
    def parse(cls, clause: str) -> "FleetFaultInjector":
        inj = cls()
        for part in filter(None, (p.strip() for p in clause.split(";"))):
            if "=" not in part:
                raise ValueError(f"fault clause needs key=value: {part!r}")
            k, v = (s.strip() for s in part.split("=", 1))
            if k == "replica":
                inj.replica = v
            elif k == "refuse":
                inj.refuse_after_ops = 1
            elif k in cls._INT_KEYS:
                setattr(inj, k, int(v))
            elif k == "stall_ms":
                inj.stall_ms = float(v)
            else:
                raise ValueError(f"unknown fleet fault key {k!r}")
        if not inj.replica:
            raise ValueError("fleet fault plans require replica=NAME")
        return inj

    # -- router seams --------------------------------------------------------

    def on_attempt(self, replica: str) -> float:
        """Before one outbound attempt. Returns a stall in SECONDS the
        router must await (0 = none); raises InjectedFleetFault to
        simulate a refused connection."""
        if replica != self.replica:
            return 0.0
        self.ops += 1
        if (self.refuse_after_ops is not None
                and self.ops >= self.refuse_after_ops
                and (self.refuse_times is None
                     or self.ops < self.refuse_after_ops
                     + self.refuse_times)):
            log.warning("fleet fault: refusing attempt %d to %s",
                        self.ops, replica)
            raise InjectedFleetFault(
                f"fault injected: connection to {replica} refused "
                f"(attempt {self.ops})")
        return self.stall_ms / 1e3

    def break_stream(self, replica: str, chunks_sent: int) -> bool:
        """True when the SSE relay to this replica must sever now; each
        True consumes one of the break_times window (None = sever every
        stream to the target forever)."""
        if (replica != self.replica
                or self.break_stream_after is None
                or chunks_sent < self.break_stream_after):
            return False
        if (self.break_times is not None
                and self.streams_broken >= self.break_times):
            return False
        self.streams_broken += 1
        return True


def parse_plan(spec: str) -> FleetFaultInjector:
    clauses = [c for c in (s.strip() for s in spec.split(",")) if c]
    if len(clauses) != 1:
        raise ValueError("fleet fault plans take exactly one clause")
    return FleetFaultInjector.parse(clauses[0])


def install(spec_or_injector) -> FleetFaultInjector:
    """Activate a fault plan process-wide (faults.FAULT_HOOK)."""
    global FAULT_HOOK
    inj = (spec_or_injector
           if isinstance(spec_or_injector, FleetFaultInjector)
           else parse_plan(spec_or_injector))
    FAULT_HOOK = inj
    log.warning("fleet fault plan installed: %s", inj)
    return inj


def active() -> FleetFaultInjector | None:
    return FAULT_HOOK


def clear() -> None:
    global FAULT_HOOK
    FAULT_HOOK = None


# env-driven activation, mirroring serve/faults.py: the plan takes effect
# the moment the fleet plane loads (router.py imports this module)
_env_plan = knobs.get_str("CAKE_FLEET_FAULT_PLAN")
if _env_plan:
    install(_env_plan)
