"""Closed-loop fleet autoscaler (the port's copy of
cake_tpu/fleet/autoscale.py): the policy brain over the telemetry plane.

Each router probe cycle the controller evaluates the latest telemetry
rollup (fleet/telemetry.py: burn rates, capacity headroom, per-class QoS
backlog, outlier flags) against a :class:`ScalePolicy` and returns a
:class:`Decision` — scale_out, scale_in, or hold — which the
:class:`Autoscaler` wrapper executes through the replica lifecycle
manager (fleet/lifecycle.py).

The controller is :func:`decide`, a pure function: no I/O, no real clock
— every input (rollup, fleet view, policy, controller state, timestamp)
is a parameter, so tests pin the whole decision table with a fake clock.

Policy, in decision order:

  * BELOW-MIN REPLACEMENT — routable + pending spawns under
    CAKE_SCALE_MIN tops the fleet back up immediately, cooldown or not
    (the floor is not discretionary; this is what turns a kill -9 into
    a respawn within one cycle).
  * SCALE-OUT — fast-window burn rate over CAKE_SCALE_BURN_FAST, or
    headroom under CAKE_SCALE_HEADROOM_MIN tokens/s. The burn rate is
    interactive-TTFT-driven, while batch backlog (rollup qos_backlog) is
    deliberately NOT a trigger — batch absorbs, interactive pages.
  * SCALE-IN — only when fast AND slow burn are clean (<= 1) and
    headroom has sat above CAKE_SCALE_HEADROOM_HIGH CONTINUOUSLY for a
    full CAKE_SCALE_COOLDOWN_S (the high-water clock resets on any dip
    or burn), the fleet is above CAKE_SCALE_MIN, and the predicted
    post-removal headroom still clears CAKE_SCALE_HEADROOM_MIN
    (hysteresis: removing the replica must not re-trigger scale-out).
  * HOLDS — one action per cooldown; while any replica is inside its
    CAKE_SCALE_WARMUP_S warm-up (its empty histograms would misread);
    at the CAKE_SCALE_MAX / CAKE_SCALE_MIN bounds.

HARD RULE: outlier/stale flags are ADVISORY and never a scale input —
they pick WHICH replica drains (victim selection: outlier-flagged
first, then least prefix-affinity mass), never WHETHER the fleet
scales. The same rollup with and without flags yields the same action.

Every decision and lifecycle transition is a typed event on the
decisions ring (GET /api/v1/fleet/autoscale), executed actions count in
cake_fleet_scale_actions_total{direction,reason}, and `cli top` renders
the loop's last word as a dashboard row. Like the rest of the router
tier this module imports no torch.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

from ..obs import FLEET_SCALE_ACTIONS, now
from . import knobs

__all__ = ["ScalePolicy", "ControllerState", "Decision", "DecisionLog",
           "Autoscaler", "decide", "select_victim", "DECISION_KINDS",
           "SCALE_OUT", "SCALE_IN", "HOLD"]

SCALE_OUT = "scale_out"
SCALE_IN = "scale_in"
HOLD = "hold"

# typed vocabulary for the decisions ring — the same closed-catalog rule
# as the request timeline's EVENT_KINDS: the ring rejects unknown kinds,
# and docs/autoscaling.md lists exactly these
DECISION_KINDS = {
    "scale_out": "controller decided to add a replica (reason: "
                 "burn_fast / headroom_low / below_min)",
    "scale_in": "controller decided to retire a replica (victim named; "
                "reason: headroom_high)",
    "hold": "controller held (recorded on reason CHANGE, not every "
            "cycle): cooldown / warmup / at_max / at_min / no_victim / "
            "hysteresis / steady / disabled",
    "spawned": "lifecycle launched a replica process from "
               "CAKE_SCALE_SPAWN_CMD; admission pending",
    "admitted": "spawned replica's /health answered 200 and it joined "
                "the routing registry",
    "spawn_failed": "spawned replica never became healthy within "
                    "CAKE_SCALE_SPAWN_TIMEOUT_S (or died first) and "
                    "was killed",
    "retire": "lifecycle began a graceful scale-in: cordon -> SIGTERM "
              "-> drain",
    "reaped": "retired replica finished draining and its process "
              "exited (or was killed after the drain deadline)",
    "died": "a managed replica process exited unexpectedly (crash, "
            "kill -9); removed from routing — the below-min rule "
            "decides the replacement",
}


@dataclass(frozen=True)
class ScalePolicy:
    """The controller's thresholds, snapshotted from knobs at router
    build time (tests construct their own)."""

    burn_fast: float = 2.0          # fast-window burn scale-out trigger
    headroom_min: float = 0.0       # tokens/s floor (0 = trigger off)
    headroom_high: float = 0.0      # scale-in high-water (0 = no scale-in)
    cooldown_s: float = 60.0        # action spacing + scale-in dwell
    min_replicas: int = 1
    max_replicas: int = 8
    warmup_s: float = 30.0          # fresh-replica grace period
    enabled: bool = True

    @classmethod
    def from_knobs(cls) -> "ScalePolicy":
        return cls(
            burn_fast=knobs.get("CAKE_SCALE_BURN_FAST"),
            headroom_min=knobs.get("CAKE_SCALE_HEADROOM_MIN"),
            headroom_high=knobs.get("CAKE_SCALE_HEADROOM_HIGH"),
            cooldown_s=max(knobs.get("CAKE_SCALE_COOLDOWN_S"), 0.0),
            min_replicas=max(knobs.get("CAKE_SCALE_MIN"), 0),
            max_replicas=max(knobs.get("CAKE_SCALE_MAX"), 1),
            warmup_s=max(knobs.get("CAKE_SCALE_WARMUP_S"), 0.0),
            enabled=knobs.get("CAKE_SCALE"))


@dataclass
class ControllerState:
    """The controller's only memory between cycles, owned by the caller
    and mutated by decide() deterministically: when the last action
    fired (the cooldown anchor) and since when the scale-in conditions
    have held continuously (the high-water dwell clock)."""

    last_action_t: float = float("-inf")
    high_since: float | None = None


@dataclass
class Decision:
    """One cycle's verdict. `action` is SCALE_OUT / SCALE_IN / HOLD,
    `reason` names the trigger (or the hold cause), `victim` the
    replica a scale-in retires, and `detail` the signal values the
    decision was made on — the decisions ring keeps all of it so an
    operator can audit WHY after the fact."""

    action: str
    reason: str
    victim: str | None = None
    detail: dict = field(default_factory=dict)


def select_victim(replicas: list) -> dict | None:
    """Lowest-value retirement candidate among the MANAGED, routable
    rows: outlier-flagged first (the advisory flags' only power — they
    choose WHO drains, never WHETHER), then least prefix-affinity mass
    (tokens/s served over the fast window: the replica the fewest warm
    conversations would miss), name as the deterministic tiebreak.
    Only lifecycle-managed replicas are eligible — the router never
    retires a process it did not spawn."""
    candidates = [r for r in replicas
                  if r.get("managed") and not r.get("cordoned")
                  and r.get("state") in ("healthy", "half_open")]
    if not candidates:
        return None
    return sorted(candidates,
                  key=lambda r: (0 if r.get("outlier") else 1,
                                 r.get("affinity_mass") or 0.0,
                                 r.get("name") or ""))[0]


def decide(rollup: dict, fleet_view: dict, policy: ScalePolicy,
           state: ControllerState, t: float) -> Decision:
    """One control cycle, pure: rollup is the telemetry snapshot
    (burn_rate, headroom_tokens_per_s, qos_backlog), fleet_view the
    membership view ({"replicas": [row...], "pending_spawns": n}),
    `t` the cycle's timestamp on whatever clock the caller runs.
    Mutates `state` (cooldown anchor, high-water dwell) and nothing
    else."""
    reps = fleet_view.get("replicas") or []
    pending = int(fleet_view.get("pending_spawns") or 0)
    routable = [r for r in reps
                if r.get("state") in ("healthy", "half_open")
                and not r.get("cordoned")]
    members = [r for r in reps if not r.get("cordoned")]
    burn = rollup.get("burn_rate") or {}
    fast = float(burn.get("fast") or 0.0)
    slow = float(burn.get("slow") or 0.0)
    headroom = float(rollup.get("headroom_tokens_per_s") or 0.0)
    detail = {"burn_fast": fast, "burn_slow": slow,
              "headroom_tokens_per_s": headroom,
              "members": len(members), "routable": len(routable),
              "pending_spawns": pending,
              "qos_backlog": rollup.get("qos_backlog") or {}}

    def hold(reason: str) -> Decision:
        return Decision(HOLD, reason, detail=detail)

    if not policy.enabled:
        return hold("disabled")

    # 1. below-min replacement: the floor is not discretionary — it
    # bypasses the cooldown AND the warm-up hold (a dead replica's
    # replacement must not wait on either), capped only by max
    if len(routable) + pending < policy.min_replicas:
        if len(members) + pending >= policy.max_replicas:
            return hold("at_max")
        state.last_action_t = t
        state.high_since = None
        return Decision(SCALE_OUT, "below_min", detail=detail)

    in_cooldown = (t - state.last_action_t) < policy.cooldown_s
    warming = [r for r in routable
               if r.get("warm_age_s") is not None
               and r["warm_age_s"] < policy.warmup_s]
    detail["warming"] = len(warming)

    # 2. scale-out triggers. Evaluated before the scale-in dwell so any
    # pressure also resets the high-water clock (a fleet cannot be
    # "comfortably over-provisioned" and "burning" in the same cycle).
    # Batch backlog is visible in detail["qos_backlog"] but is NOT an
    # input: batch absorbs by design; the burn rate (interactive
    # TTFT-driven) and headroom are the only out-triggers.
    out_reason = None
    if fast > policy.burn_fast:
        out_reason = "burn_fast"
    elif policy.headroom_min > 0 and headroom < policy.headroom_min:
        out_reason = "headroom_low"
    if out_reason is not None:
        state.high_since = None
        if len(members) + pending >= policy.max_replicas:
            return hold("at_max")
        if in_cooldown:
            return hold("cooldown")
        if warming or pending:
            # fresh capacity is still materializing: judging the
            # trigger now would double-spend on the same pressure
            return hold("warmup")
        state.last_action_t = t
        return Decision(SCALE_OUT, out_reason, detail=detail)

    # 3. scale-in dwell: clean burn on BOTH windows + headroom above the
    # high-water mark, continuously for a full cooldown
    clean = fast <= 1.0 and slow <= 1.0
    high = policy.headroom_high > 0 and headroom >= policy.headroom_high
    if clean and high:
        if state.high_since is None:
            state.high_since = t
    else:
        state.high_since = None
    detail["high_for_s"] = round(t - state.high_since, 3) \
        if state.high_since is not None else 0.0
    if state.high_since is None \
            or (t - state.high_since) < policy.cooldown_s:
        return hold("steady")
    if in_cooldown:
        return hold("cooldown")
    if warming or pending:
        return hold("warmup")
    if len(routable) <= policy.min_replicas:
        return hold("at_min")
    victim = select_victim(routable)
    if victim is None:
        return hold("no_victim")
    # hysteresis guard: the fleet minus the victim must still clear the
    # scale-out floor, or the loop would flap out <-> in forever
    predicted = headroom - float(victim.get("headroom_tokens_per_s")
                                 or 0.0)
    detail["predicted_headroom_tokens_per_s"] = round(predicted, 3)
    if policy.headroom_min > 0 and predicted < policy.headroom_min:
        return hold("hysteresis")
    state.last_action_t = t
    state.high_since = None
    return Decision(SCALE_IN, "headroom_high", victim=victim.get("name"),
                    detail=detail)


class DecisionLog:
    """Bounded ring of typed controller/lifecycle events — the
    timeline-store shape (closed kind catalog, newest-last list) scoped
    to the autoscale loop. Event-loop-confined like the router state
    that owns it; timestamps are the caller's clock and rendered as
    ages (monotonic clocks mean nothing across processes)."""

    def __init__(self, cap: int | None = None, clock=now):
        cap = cap if cap is not None else knobs.get("CAKE_SCALE_DECISIONS")
        self._ring: deque = deque(maxlen=max(int(cap), 8))
        self._clock = clock

    def record(self, kind: str, t: float | None = None, **fields) -> None:
        if kind not in DECISION_KINDS:
            raise ValueError(f"unknown decision kind {kind!r} (catalog: "
                             f"{sorted(DECISION_KINDS)})")
        ev = {"kind": kind, "t": self._clock() if t is None else float(t)}
        ev.update(fields)
        self._ring.append(ev)

    def events(self, t: float | None = None) -> list:
        """Newest-last events with `t` converted to `age_s`."""
        t = self._clock() if t is None else float(t)
        out = []
        for ev in self._ring:
            row = {k: v for k, v in ev.items() if k != "t"}
            row["age_s"] = round(t - ev["t"], 3)
            out.append(row)
        return out

    def last(self, *kinds: str) -> dict | None:
        for ev in reversed(self._ring):
            if not kinds or ev["kind"] in kinds:
                return ev
        return None


class Autoscaler:
    """The loop: owns policy + controller state + the decisions ring,
    builds the fleet view from the registry and lifecycle, and executes
    decisions through the lifecycle manager. Driven by the router's
    probe cycle (step()); event-loop-confined like the router's own
    handler state."""

    def __init__(self, registry, lifecycle, *,
                 policy: ScalePolicy | None = None,
                 log: DecisionLog | None = None, clock=now):
        self.registry = registry
        self.lifecycle = lifecycle
        self.policy = policy or ScalePolicy.from_knobs()
        self.state = ControllerState()
        self.log = log if log is not None else DecisionLog(clock=clock)
        self._clock = clock
        self._last_hold_reason = None

    def fleet_view(self, rollup: dict) -> dict:
        """Membership + per-replica signals the controller ranks victims
        on: registry state/warm-age/cordon joined with the rollup's
        per-replica headroom and token rate (affinity mass), plus which
        replicas the lifecycle manages."""
        trows = rollup.get("replicas") or {}
        rows = []
        for rep in self.registry.replicas():
            snap = rep.snapshot()
            tr = trows.get(rep.name) or {}
            rows.append({
                "name": rep.name,
                "state": rep.state,
                "cordoned": snap.get("cordoned"),
                "warm_age_s": snap.get("warm_age_s"),
                "inflight": snap.get("inflight"),
                "managed": self.lifecycle.is_managed(rep.name),
                "outlier": snap.get("outlier"),
                "outlier_reason": snap.get("outlier_reason"),
                "stale": snap.get("stale"),
                "headroom_tokens_per_s":
                    tr.get("headroom_tokens_per_s") or 0.0,
                "affinity_mass": tr.get("tokens_per_s") or 0.0,
            })
        return {"replicas": rows,
                "pending_spawns": self.lifecycle.pending_count()}

    def step(self, rollup: dict, t: float | None = None) -> Decision:
        """One control cycle: decide, record, execute. Holds land on the
        ring only when their reason CHANGES (a steady fleet must not
        scroll the ring with identical holds every probe tick)."""
        t = self._clock() if t is None else float(t)
        decision = decide(rollup, self.fleet_view(rollup), self.policy,
                          self.state, t)
        if decision.action == HOLD:
            if decision.reason != self._last_hold_reason:
                self._last_hold_reason = decision.reason
                self.log.record(HOLD, t=t, reason=decision.reason,
                                detail=decision.detail)
            return decision
        self._last_hold_reason = None
        if decision.action == SCALE_OUT:
            self.log.record(SCALE_OUT, t=t, reason=decision.reason,
                            detail=decision.detail)
            FLEET_SCALE_ACTIONS.inc(direction="out",
                                    reason=decision.reason)
            self.lifecycle.spawn(reason=decision.reason)
        elif decision.action == SCALE_IN:
            self.log.record(SCALE_IN, t=t, reason=decision.reason,
                            replica=decision.victim,
                            detail=decision.detail)
            FLEET_SCALE_ACTIONS.inc(direction="in",
                                    reason=decision.reason)
            self.lifecycle.retire(decision.victim,
                                  reason=decision.reason)
        return decision

    def summary(self) -> dict:
        """The compact block merged into /api/v1/fleet/telemetry (and
        rendered as the `cli top` autoscale row)."""
        last = self.log.last(SCALE_OUT, SCALE_IN, HOLD)
        out = {"enabled": self.policy.enabled,
               "min": self.policy.min_replicas,
               "max": self.policy.max_replicas,
               "pending_spawns": self.lifecycle.pending_count(),
               "managed": len(self.lifecycle.managed_names())}
        if last is not None:
            out["last"] = {"kind": last["kind"],
                           "reason": last.get("reason"),
                           "replica": last.get("replica"),
                           "age_s": round(self._clock() - last["t"], 3)}
        return out

    def snapshot(self) -> dict:
        """GET /api/v1/fleet/autoscale: policy, controller state, the
        full decisions ring, and the lifecycle's process view."""
        t = self._clock()
        high = self.state.high_since
        return {
            "enabled": self.policy.enabled,
            "policy": {
                "burn_fast": self.policy.burn_fast,
                "headroom_min": self.policy.headroom_min,
                "headroom_high": self.policy.headroom_high,
                "cooldown_s": self.policy.cooldown_s,
                "min_replicas": self.policy.min_replicas,
                "max_replicas": self.policy.max_replicas,
                "warmup_s": self.policy.warmup_s,
            },
            "state": {
                "since_last_action_s":
                    round(t - self.state.last_action_t, 3)
                    if self.state.last_action_t != float("-inf") else None,
                "high_for_s": round(t - high, 3)
                    if high is not None else 0.0,
            },
            "decisions": self.log.events(t),
            "lifecycle": self.lifecycle.snapshot(),
        }
