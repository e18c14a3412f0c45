"""Deterministic fault injection for the serve engine's step path (the
port's own copy of cake_tpu/serve/faults.py: InjectedFault,
ServeFaultInjector, parse_plan, install, active, clear, FAULT_HOOK).

The supervisor (serve/supervisor.py) rebuilds the engine after a step
failure, and every one of its recovery paths must be testable without a
real device fault. This module hooks the scheduler's device dispatches
(`ServeEngine._step`'s batched decode, every prefill chunk and every
replay chunk) through one module attribute the engine reads once per
dispatch (`faults.FAULT_HOOK`: None, one attribute read, when disabled).
This copy is a global of its own, apart from the JAX package's.

An "op" is one batched decode dispatch, ONE SCHEDULER ITERATION, not one
token: a 3-slot pool emits ~3 tokens per op, so place kill-steps by
iteration count. The counter keeps running across the rebuilds a fault
provokes, which is what makes multi-crash plans (`times=K`)
deterministic.

A fault plan is one clause of `key=val[;key=val...]` from the
`CAKE_SERVE_FAULT_PLAN` environment variable (read when this module is
first imported; tests use `install()` / `clear()`). Keys:

    raise_on_step=N     decode dispatch N raises (1-based); with times=K
                        dispatches N..N+K-1 all raise (default K=1)
    times=K             how many consecutive dispatches raise_on_step kills
    kind=K              the injected exception's fault_kind seeding the
                        supervisor's classifier: internal | device | oom
    stall_on_step=N     decode dispatch N stalls stall_step_ms on the
                        scheduler thread BEFORE dispatch, once (the wedge
                        watchdog drill; default N=1)
    stall_step_ms=S     how long that one stall lasts
    delay_ms=D          every decode dispatch sleeps D ms first (slow but
                        alive)
    poison_token=T      any dispatch touching a request whose PROMPT
                        contains token id T raises, EVERY time, decode and
                        prefill both, which is what lets the supervisor's
                        replay bisection re-trigger and attribute it
    poison_after_ops=N  poison arms only after N decode ops, so the
                        poisoned request admits cleanly and corrupts the
                        pool MID-generation (the hard case)

The stall sleeps on the scheduler thread by design: a scheduler stuck
inside a device call IS the wedge being simulated.
"""
from __future__ import annotations

import logging
import os
import time
from dataclasses import dataclass

log = logging.getLogger("cake_tpu_torch.serve.faults")

__all__ = ["FAULT_HOOK", "InjectedFault", "ServeFaultInjector",
           "parse_plan", "install", "active", "clear"]

# the engine's per-dispatch seam: None (one attribute check) when disabled
FAULT_HOOK = None


class InjectedFault(RuntimeError):
    """A planned failure. `fault_kind` seeds supervisor.classify(), so a
    plan can drill the device / oom / internal recovery paths apart."""

    def __init__(self, msg: str, fault_kind: str = "internal"):
        super().__init__(msg)
        self.fault_kind = fault_kind


@dataclass
class ServeFaultInjector:
    """One plan clause; the engine calls the hooks below per dispatch.
    All state lives here so that it survives the rebuilds it provokes."""

    raise_on_step: int | None = None
    times: int = 1
    kind: str = "internal"
    stall_on_step: int = 1
    stall_step_ms: float = 0.0
    delay_ms: float = 0.0
    poison_token: int | None = None
    poison_after_ops: int = 0
    ops: int = 0                # decode dispatches seen (1-based after inc)
    stalled: bool = False

    _INT_KEYS = ("raise_on_step", "times", "stall_on_step", "poison_token",
                 "poison_after_ops")
    _FLOAT_KEYS = ("stall_step_ms", "delay_ms")

    @classmethod
    def parse(cls, clause: str) -> "ServeFaultInjector":
        inj = cls()
        for part in filter(None, (p.strip() for p in clause.split(";"))):
            if "=" not in part:
                raise ValueError(f"fault clause needs key=value: {part!r}")
            k, v = (s.strip() for s in part.split("=", 1))
            if k in cls._INT_KEYS:
                setattr(inj, k, int(v))
            elif k in cls._FLOAT_KEYS:
                setattr(inj, k, float(v))
            elif k == "kind":
                if v not in ("internal", "device", "oom"):
                    raise ValueError(f"unknown fault kind {v!r}")
                inj.kind = v
            else:
                raise ValueError(f"unknown serve fault key {k!r}")
        return inj

    # -- engine seams -------------------------------------------------------

    def on_decode(self, reqs) -> None:
        """Before a batched decode dispatch; `reqs` are the active
        ServeRequests riding it."""
        self.ops += 1
        if self.delay_ms > 0:
            time.sleep(self.delay_ms / 1e3)
        if (self.stall_step_ms > 0 and not self.stalled
                and self.ops >= self.stall_on_step):
            self.stalled = True
            log.warning("serve fault: stalling dispatch %d for %.0f ms",
                        self.ops, self.stall_step_ms)
            time.sleep(self.stall_step_ms / 1e3)
        if (self.raise_on_step is not None
                and self.raise_on_step <= self.ops
                < self.raise_on_step + self.times):
            log.warning("serve fault: raising %s at dispatch %d",
                        self.kind, self.ops)
            raise InjectedFault(
                f"fault injected: step {self.ops} "
                + ("RESOURCE_EXHAUSTED: out of memory"
                   if self.kind == "oom" else f"{self.kind} failure"),
                fault_kind=self.kind)
        self._poison_check(reqs)

    def on_prefill(self, req) -> None:
        """Before one prefill chunk (admission AND replay) of `req`:
        poison re-fires here, which is how the supervisor's solo replay
        attributes it."""
        self._poison_check((req,))

    def _poison_check(self, reqs) -> None:
        if self.poison_token is None or self.ops < self.poison_after_ops:
            return
        for r in reqs:
            if self.poison_token in r.prompt_ids:
                raise InjectedFault(
                    f"fault injected: poison token {self.poison_token} "
                    f"in request {r.id}", fault_kind="internal")


def parse_plan(spec: str) -> ServeFaultInjector:
    clauses = [c for c in (s.strip() for s in spec.split(",")) if c]
    if len(clauses) != 1:
        raise ValueError("serve fault plans take exactly one clause")
    return ServeFaultInjector.parse(clauses[0])


def install(spec_or_injector) -> ServeFaultInjector:
    """Activate a fault plan process-wide (faults.FAULT_HOOK)."""
    global FAULT_HOOK
    inj = (spec_or_injector
           if isinstance(spec_or_injector, ServeFaultInjector)
           else parse_plan(spec_or_injector))
    FAULT_HOOK = inj
    log.warning("serve fault plan installed: %s", inj)
    return inj


def active() -> ServeFaultInjector | None:
    return FAULT_HOOK


def clear() -> None:
    global FAULT_HOOK
    FAULT_HOOK = None


# the plan takes effect the moment the serve package loads (engine.py
# imports this module)
_env_plan = os.environ.get("CAKE_SERVE_FAULT_PLAN")
if _env_plan:
    install(_env_plan)
