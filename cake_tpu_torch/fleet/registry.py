"""Replica registry: health-driven membership for the fleet router (the
port's own copy of cake_tpu/fleet/registry.py: the same state machine,
thresholds, holds and evidence).

One `cake serve` replica survives crashes (serve/supervisor.py) and
worker death (cluster/master.py) — but a fleet of N replicas needs a
tier that stops ROUTING to a sick one. This module owns that decision:
every replica the router fronts is a :class:`Replica` whose membership
state machine is driven by two signal streams,

  * the router's own request outcomes (transport failures, replica 5xx,
    time-to-first-byte), fed through :meth:`Replica.record_result`; and
  * the replica's /health engine block (down / wedged / draining, queue
    depth, kv_pool occupancy), fed through :meth:`Replica.observe_health`
    by the router's probe loop.

The gray-failure detector is the cluster hop detector's shape
(cluster/client.py: rolling window, p95 vs threshold, minimum samples
before it may trip) applied to routing: a replica whose rolling error
rate or TTFB p95 crosses its threshold is EJECTED even though TCP still
connects — slow-but-alive is the failure mode that burns tail latency
("The Tail at Scale", Dean & Barroso).

State machine (docs/fleet.md has the diagram):

    HEALTHY --(consecutive transport fails >= eject_fails,
               error rate >= err_rate over the window,
               TTFB p95 > degraded_ttft_ms,
               or /health says down/wedged)--> EJECTED
    EJECTED --(hold expires AND a probe succeeds)--> HALF_OPEN
    HALF_OPEN --(one successful trial request,
                 or two consecutive healthy probes
                 *probe-evidence ejects only*)--> HEALTHY
    HALF_OPEN --(any failure)--> EJECTED (hold doubles, capped 8x)

Every eject carries an EVIDENCE dimension: "data" when the router's own
request path produced the evidence (transport failures, error rate,
TTFB p95 — including the half-open trial failing), "probe" when only
the /health probe path did. Data evidence is sticky for the episode and
gates readmission: probe successes alone can NEVER clear a
data-evidence eject — only the half-open data-path trial lease can.
This kills the asymmetric-partition flap, where a replica whose probe
path is alive but whose data path is partitioned would otherwise
readmit on two healthy probes, fail its next real request, re-eject,
and loop. While a data-evidence eject is open the replica is in a
suspected-PARTITION episode (surfaced in /fleet, the replica
pseudo-timeline, and cake_fleet_partition_seconds_total). Readmission
does not reset the hold-doubling streak — repeated partition/heal
cycles find their re-eject hold doubled each round (no reputation
laundering); the streak expires only after a quiet forget window.

KV-share inventory: each healthy /health's `engine.kvshare.chains` (the
hex prefix-chain keys the replica can export) is mirrored as kv_chains
and read through kv_inventory() into the router's peer directory; a
stale or sick probe retracts it, and an EJECTED replica advertises
nothing.

DRAINING is orthogonal: a replica whose engine block says draining keeps
its machine state but stops taking NEW requests (in-flight ones finish)
— mirroring how the engine itself drains.

Thread model: the probe loop and the request path touch the same fields,
so every mutable field is `# guarded-by:` its owner's lock. The clock is
the module's `now` (obs/timing.py), which tests replace with a fake one.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass

from . import knobs
from ..obs import (FLEET_EJECTS, FLEET_PARTITION_SECONDS, FLEET_READMITS,
                   FLEET_REPLICAS, FLEET_REPLICA_INFLIGHT,
                   FLEET_REPLICA_OCCUPANCY, FLEET_REPLICA_OUTLIER,
                   FLEET_REPLICA_QUEUE_DEPTH, FLEET_REPLICA_STALE, now)

__all__ = ["Replica", "ReplicaRegistry", "MembershipPolicy",
           "discover_replicas", "HEALTHY", "EJECTED", "HALF_OPEN"]

HEALTHY = "healthy"
EJECTED = "ejected"
HALF_OPEN = "half_open"

# minimum rolling-window samples before the error-rate / TTFB detectors
# may trip (one bad response is noise, not gray failure) — same guard as
# the cluster hop detector's GRAY_MIN_SAMPLES
GRAY_MIN_SAMPLES = 8

# ejection hold multiplier cap: repeated re-ejects back off the half-open
# probe exponentially, but a replica is never held out longer than 8x the
# base hold (a flapping replica should still get probed, just less often)
MAX_EJECT_BACKOFF = 8

# per-replica in-flight fallback before the first health probe reports a
# slot count (auto cap = 2x slots once known)
DEFAULT_INFLIGHT_CAP = 8

# eject-streak forget window, in multiples of the FULLY BACKED-OFF hold:
# a replica that stays out of trouble this long after its last eject has
# its hold-doubling reputation expired (readmission alone never resets
# the streak — see _readmit)
EJECT_FORGET_HOLDS = 2


@dataclass(frozen=True)
class MembershipPolicy:
    """Ejection thresholds, snapshotted from knobs at registry build time
    (tests construct their own)."""

    eject_fails: int = 3        # consecutive transport failures
    err_window: int = 32        # rolling result window length
    err_rate: float = 0.5       # error fraction over the window
    degraded_ttft_ms: float = 0.0   # TTFB p95 gray threshold (0 = off)
    eject_s: float = 5.0        # base ejection hold before half-open
    replica_inflight: int = 0   # per-replica cap (0 = auto from health)

    @classmethod
    def from_knobs(cls) -> "MembershipPolicy":
        return cls(
            eject_fails=max(knobs.get("CAKE_FLEET_EJECT_FAILS"), 1),
            err_window=max(knobs.get("CAKE_FLEET_ERR_WINDOW"), 4),
            err_rate=knobs.get("CAKE_FLEET_ERR_RATE"),
            degraded_ttft_ms=knobs.get("CAKE_FLEET_DEGRADED_TTFT_MS"),
            eject_s=knobs.get("CAKE_FLEET_EJECT_S"),
            replica_inflight=knobs.get("CAKE_FLEET_REPLICA_INFLIGHT"))


class Replica:
    """One `cake serve` replica: identity + membership state + the live
    load view the router routes on. All mutable state is guarded by
    `self._lock` — the probe loop and every concurrent request handler
    share these fields."""

    def __init__(self, name: str, base_url: str,
                 policy: MembershipPolicy | None = None):
        self.name = name
        self.base_url = base_url.rstrip("/")
        self.policy = policy or MembershipPolicy()
        # reentrant: the state-machine helpers (_eject/_readmit/_cap/...)
        # re-acquire under their callers so the lock-discipline lint can
        # verify every guarded access lexically, in helpers included
        self._lock = threading.RLock()
        # membership state machine (probe loop + request path)
        self.state = HEALTHY            # guarded-by: self._lock
        self.state_since = now()        # guarded-by: self._lock
        self.consec_fails = 0           # guarded-by: self._lock
        self.results: list = []         # guarded-by: self._lock
        self.eject_until = 0.0          # guarded-by: self._lock
        self.eject_streak = 0           # guarded-by: self._lock
        self.probe_ok_streak = 0        # guarded-by: self._lock
        self.trial_inflight = False     # guarded-by: self._lock
        # live load view, mirrored from /health by the probe loop
        self.inflight = 0               # guarded-by: self._lock
        self.draining = False           # guarded-by: self._lock
        self.slots_hint = 0             # guarded-by: self._lock
        self.queue_depth = 0            # guarded-by: self._lock
        self.occupancy = 0.0            # guarded-by: self._lock
        self.last_probe_ok = None       # guarded-by: self._lock
        self.ejects = 0                 # guarded-by: self._lock
        self.readmits = 0               # guarded-by: self._lock
        # evidence behind the OPEN eject episode: "data" (request-path
        # transport/error evidence) or "probe" (/health evidence only);
        # None = no open episode. Data evidence is sticky and gates
        # readmission to the data-path trial (see module docstring).
        self.eject_evidence = None      # guarded-by: self._lock
        # suspected-partition episode (open while eject_evidence is
        # "data"): wall-clock start + last accrual point feeding
        # cake_fleet_partition_seconds_total incrementally
        self.partition_since = None     # guarded-by: self._lock
        self._partition_accrued_at = 0.0  # guarded-by: self._lock
        # eject-streak decay clock (EJECT_FORGET_HOLDS)
        self._last_eject_at = 0.0       # guarded-by: self._lock
        # membership events pending pickup by the router probe loop
        # into the replica:<name> pseudo-timelines
        self._pending_events = []       # guarded-by: self._lock
        # warm-up clock: when THIS router first saw this replica (reset
        # on re-registration and on detected in-place restart). The
        # autoscaler holds while any replica is younger than
        # CAKE_SCALE_WARMUP_S — a cold replica's empty histograms would
        # misread as zero headroom and re-trigger the scale-out that
        # just ran.
        self.first_seen = now()         # guarded-by: self._lock
        self._last_started_age = None   # guarded-by: self._lock
        # lifecycle cordon: the router stops routing NEW requests here
        # while the lifecycle manager drains + reaps it (scale-in);
        # unlike `draining` (mirrored from the replica's own /health)
        # this is the ROUTER's decision and survives probe updates
        self.cordoned = False           # guarded-by: self._lock
        # telemetry-plane anomaly flag (fleet/telemetry.py writes it
        # once per rollup cycle; /fleet surfaces it without ejecting)
        self.outlier = False            # guarded-by: self._lock
        self.outlier_reason = None      # guarded-by: self._lock
        # kvshare inventory: hex prefix-chain keys this replica's last
        # healthy /health advertised (kvshare.chains). Retracted the
        # instant a probe goes stale/sick — a peer directory must never
        # point a fetch at a replica whose cache state is unknown
        self.kv_chains = ()             # guarded-by: self._lock

    # -- capacity -----------------------------------------------------------

    def _cap(self) -> int:
        """Per-replica in-flight cap: the knob when set, else 2x the slot
        count the last health probe reported, else the pre-probe
        fallback."""
        with self._lock:
            if self.policy.replica_inflight > 0:
                return self.policy.replica_inflight
            if self.slots_hint > 0:
                return 2 * self.slots_hint
            return DEFAULT_INFLIGHT_CAP

    def cap(self) -> int:
        with self._lock:
            return self._cap()

    def weight(self) -> float:
        """Rendezvous placement weight: the replica's probed capacity
        (engine slots from its last /health), 1.0 before the first
        probe lands — so a heterogeneous fleet places conversations
        proportionally to real slot counts while a fresh fleet starts
        uniform."""
        with self._lock:
            return float(self.slots_hint) if self.slots_hint > 0 else 1.0

    def try_acquire(self) -> str | None:
        """Reserve one routing slot on this replica. Returns a truthy
        lease token — "slot" for a normal reservation, "trial" for THE
        one half-open probation request — or None when the replica
        refuses (draining, ejected, at cap, trial already in flight).
        The caller passes the token back to release(), which is what
        keeps a pre-eject request's release from clearing the trial
        flag of a probation request still running."""
        with self._lock:
            if self.draining or self.cordoned:
                return None
            if self.state == HEALTHY:
                if self.inflight >= self._cap():
                    return None
                self.inflight += 1
                FLEET_REPLICA_INFLIGHT.set(self.inflight,
                                           replica=self.name)
                return "slot"
            if self.state == HALF_OPEN and not self.trial_inflight:
                self.trial_inflight = True
                self.inflight += 1
                FLEET_REPLICA_INFLIGHT.set(self.inflight,
                                           replica=self.name)
                return "trial"
            return None

    def release(self, lease: str = "slot") -> None:
        with self._lock:
            self.inflight = max(self.inflight - 1, 0)
            if lease == "trial":
                self.trial_inflight = False
            FLEET_REPLICA_INFLIGHT.set(self.inflight, replica=self.name)

    # -- outcome stream (request path) --------------------------------------

    def record_result(self, ok: bool, ttfb_ms: float | None = None,
                      transport: bool = False,
                      lease: str = "slot") -> str | None:
        """Feed one routed-request outcome into the detector. `transport`
        marks connect/read failures (the replica never answered) —
        these drive the consecutive-failure eject; HTTP-level errors
        (replica 5xx) ride the rolling error rate instead. `lease` is
        the token try_acquire issued for this request: only the TRIAL
        request's outcome may move a HALF_OPEN replica (readmit or
        re-eject) — a request that started before the ejection and
        finished during probation is STALE evidence (its failure is the
        old incident, not the probe), and an EJECTED replica ignores
        outcomes entirely. Returns the eject reason when this result
        ejected the replica, else None."""
        with self._lock:
            if self.state == EJECTED:
                return None                 # stale pre-eject outcome
            if ok:
                self.consec_fails = 0
                self.results.append((True, ttfb_ms))
                del self.results[:-self.policy.err_window]
                if self.state == HALF_OPEN:
                    if lease == "trial":
                        self._readmit()
                    return None
                return self._check_gray()
            # failure
            if self.state == HALF_OPEN:
                if lease == "trial":
                    return self._eject("fails")
                return None                 # stale pre-eject failure
            self.results.append((False, None))
            del self.results[:-self.policy.err_window]
            if transport:
                self.consec_fails += 1
            if transport and self.consec_fails >= self.policy.eject_fails:
                return self._eject("fails")
            return self._check_gray()

    def _check_gray(self) -> str | None:
        """Rolling-window detectors: error rate, then TTFB p95 — the hop
        detector's shape, pointed at routing outcomes."""
        with self._lock:
            if (self.state != HEALTHY
                    or len(self.results) < GRAY_MIN_SAMPLES):
                return None
            errs = sum(1 for ok, _ in self.results if not ok)
            if errs / len(self.results) >= self.policy.err_rate:
                return self._eject("error_rate")
            if self.policy.degraded_ttft_ms > 0:
                ms = sorted(t for ok, t in self.results
                            if ok and t is not None)
                if len(ms) >= GRAY_MIN_SAMPLES:
                    p95 = ms[min(int(len(ms) * 0.95), len(ms) - 1)]
                    if p95 > self.policy.degraded_ttft_ms:
                        return self._eject("ttft_p95")
            return None

    # -- health stream (probe loop) ------------------------------------------

    def observe_health(self, status: int | None,
                       body: dict | None) -> str | None:
        """Consume one /health probe. `status` None = unreachable (counts
        like a transport failure). A 503 whose engine block says down or
        wedged ejects immediately — the replica itself is reporting it
        cannot serve. Healthy probes drive the ejected -> half_open ->
        readmit side of the machine, so an idle fleet still readmits
        without waiting for live traffic to gamble on the replica.
        A data-evidence (suspected-partition) eject is the exception:
        healthy probes can advance it to HALF_OPEN but never readmit it
        — the probe path answering says nothing about the data path
        that produced the evidence; only the trial lease does.
        Returns an eject reason when the probe ejected, else None."""
        self._accrue_partition()
        with self._lock:
            if status is None:
                self.last_probe_ok = False
                self.probe_ok_streak = 0
                self.consec_fails += 1
                # stale-mirror retraction: the queue-depth / occupancy
                # gauges mirror a /health body that no longer exists —
                # delete the labelsets (a scrape sees the series
                # DISAPPEAR, not freeze) and raise the companion stale
                # flag so rollups/dashboards exclude this replica
                # instead of averaging its last numbers forever. The
                # inflight gauge stays: it counts the router's OWN
                # proxied requests, which are real until they fail.
                FLEET_REPLICA_QUEUE_DEPTH.remove(replica=self.name)
                FLEET_REPLICA_OCCUPANCY.remove(replica=self.name)
                FLEET_REPLICA_STALE.set(1, replica=self.name)
                self.kv_chains = ()     # retract: inventory is stale too
                if self.state == HALF_OPEN:
                    return self._eject("health")
                if (self.state == HEALTHY
                        and self.consec_fails >= self.policy.eject_fails):
                    return self._eject("health")
                return None
            engine = (body or {}).get("engine") or {}
            # in-place restart detection: /health carries a monotonic
            # process age (started_at_age_s); the age moving BACKWARD
            # means a new process answers behind the same URL — reset
            # the warm-up clock so the autoscaler grants it the same
            # grace as a freshly spawned replica
            age = (body or {}).get("started_at_age_s")
            if age is not None:
                try:
                    age = float(age)
                except (TypeError, ValueError):
                    age = None
            if age is not None:
                if self._last_started_age is not None \
                        and age < self._last_started_age:
                    self.first_seen = now()
                self._last_started_age = age
            self.draining = bool((body or {}).get("draining")
                                 or engine.get("draining"))
            if engine.get("slots"):
                self.slots_hint = int(engine["slots"])
            self.queue_depth = int(engine.get("queue_depth") or 0)
            self.occupancy = self._occupancy_of(engine)
            FLEET_REPLICA_QUEUE_DEPTH.set(self.queue_depth,
                                          replica=self.name)
            FLEET_REPLICA_OCCUPANCY.set(self.occupancy, replica=self.name)
            FLEET_REPLICA_STALE.set(0, replica=self.name)
            kvshare = engine.get("kvshare") or {}
            chains = kvshare.get("chains") or []
            self.kv_chains = tuple(
                c for c in chains if isinstance(c, str))
            sick = bool(engine.get("down") or engine.get("wedged")
                        or engine.get("alive") is False)
            self.last_probe_ok = not sick
            if sick:
                self.kv_chains = ()     # retract with the sick verdict
                self.probe_ok_streak = 0
                if self.state in (HEALTHY, HALF_OPEN):
                    return self._eject("health")
                return None
            # healthy probe
            self.consec_fails = 0
            if self.state == EJECTED and now() >= self.eject_until:
                self._transition(HALF_OPEN)
                self.probe_ok_streak = 1
            elif self.state == HALF_OPEN:
                self.probe_ok_streak += 1
                if (self.probe_ok_streak >= 2
                        and self.eject_evidence != "data"):
                    self._readmit()
            return None

    @staticmethod
    def _occupancy_of(engine: dict) -> float:
        """KV occupancy in [0, 1]: the kv_pool block's first-class
        `occupancy` field for paged pools (the producer computes
        used/blocks — block occupancy matters: a paged replica can have
        95% of its KV spoken for with only half its slots busy), with
        the hand-derivation kept only for pre-occupancy replicas mid
        rolling upgrade; contiguous pools fall back to busy-slot
        fraction — the autoscaling signal either way."""
        kv = engine.get("kv_pool") or {}
        if "occupancy" in kv:
            return round(float(kv["occupancy"]), 4)
        if kv.get("blocks"):                # pre-occupancy replica
            return round((kv.get("used") or 0) / kv["blocks"], 4)
        slots = engine.get("slots") or 0
        if slots:
            return round((engine.get("slots_busy") or 0) / slots, 4)
        return 0.0

    # -- transitions (lock held) --------------------------------------------

    def _transition(self, state: str) -> None:
        with self._lock:
            self.state = state
            self.state_since = now()

    def _eject(self, reason: str) -> str:
        with self._lock:
            evidence = "probe" if reason == "health" else "data"
            if self.eject_evidence == "data":
                evidence = "data"   # sticky across the open episode: a
                                    # probe-reason re-eject mid-episode
                                    # must not downgrade the readmit gate
            self.eject_evidence = evidence
            forget_s = (self.policy.eject_s * MAX_EJECT_BACKOFF
                        * EJECT_FORGET_HOLDS)
            if (forget_s > 0 and self._last_eject_at
                    and now() - self._last_eject_at > forget_s):
                self.eject_streak = 0   # reputation expired: quiet since
            self._last_eject_at = now()
            self.eject_streak += 1
            hold = self.policy.eject_s * min(2 ** (self.eject_streak - 1),
                                             MAX_EJECT_BACKOFF)
            self.eject_until = now() + hold
            self.probe_ok_streak = 0
            self.trial_inflight = False
            self.results.clear()
            self.ejects += 1
            if evidence == "data" and self.partition_since is None:
                self.partition_since = now()
                self._partition_accrued_at = self.partition_since
                self._pending_events.append(
                    ("replica_partition_suspected",
                     {"replica": self.name, "reason": reason,
                      "hold_s": round(hold, 3)}))
            self._transition(EJECTED)
        FLEET_EJECTS.inc(replica=self.name, reason=reason,
                         evidence=evidence)
        return reason

    def _readmit(self) -> None:
        with self._lock:
            # eject_streak intentionally SURVIVES readmission: a
            # partition/heal flap must find its re-eject hold doubled
            # each round; the streak expires only after the quiet
            # forget window (_eject)
            self.consec_fails = 0
            self.probe_ok_streak = 0
            self.trial_inflight = False
            self.readmits += 1
            if self.partition_since is not None:
                self._accrue_partition()
                self._pending_events.append(
                    ("partition_healed",
                     {"replica": self.name,
                      "episode_s": round(now() - self.partition_since,
                                         3)}))
                self.partition_since = None
            self.eject_evidence = None
            self._transition(HEALTHY)
        FLEET_READMITS.inc(replica=self.name)

    def _accrue_partition(self) -> None:
        """Feed the open partition episode's elapsed time into
        cake_fleet_partition_seconds_total incrementally (each probe
        cycle), so the counter climbs DURING an episode instead of
        jumping at heal."""
        with self._lock:
            if self.partition_since is None:
                return
            t = now()
            delta = t - self._partition_accrued_at
            self._partition_accrued_at = t
        if delta > 0:
            FLEET_PARTITION_SECONDS.inc(delta, replica=self.name)

    def drain_events(self) -> list:
        """Pop pending membership events as (kind, attrs) tuples — the
        router probe loop records them into the replica:<name>
        pseudo-timelines so partition episodes show up in the stitched
        two-tier timeline."""
        with self._lock:
            ev = self._pending_events
            self._pending_events = []
            return ev

    def history(self) -> dict:
        """The membership reputation that outlives removal (registry
        tombstones): eject counts, backoff streak, and any running
        ejection hold — what restore_history re-applies on re-announce."""
        with self._lock:
            return {"ejects": self.ejects,
                    "eject_streak": self.eject_streak,
                    "readmits": self.readmits,
                    "eject_until": self.eject_until,
                    "eject_evidence": self.eject_evidence,
                    "last_eject_at": self._last_eject_at}

    def cordon(self) -> None:
        """Router-side drain mark (lifecycle scale-in): stop routing NEW
        requests here; in-flight ones finish. One-way — a cordoned
        replica is on its way out of the registry."""
        with self._lock:
            self.cordoned = True

    def warm_age_s(self) -> float:
        """Seconds since this router first saw the replica (re-joins and
        detected restarts reset it) — the autoscaler's warm-up input."""
        with self._lock:
            return now() - self.first_seen

    def restore_history(self, hist: dict) -> None:
        """Re-apply a removed replica's eject history on re-announce
        (registry tombstones): counts and streak carry over so the
        backoff ladder is not laundered, and a still-running ejection
        hold is resumed — while first_seen stays FRESH (set by
        __init__), because the warm-up clock is about this process
        instance, not the name's reputation."""
        with self._lock:
            self.ejects = int(hist.get("ejects") or 0)
            self.eject_streak = int(hist.get("eject_streak") or 0)
            self.readmits = int(hist.get("readmits") or 0)
            self._last_eject_at = float(hist.get("last_eject_at") or 0.0)
            until = float(hist.get("eject_until") or 0.0)
            if until > now():
                self.eject_until = until
                # the evidence gate survives re-announce with the hold:
                # a data-evidence eject still demands a data-path trial
                self.eject_evidence = hist.get("eject_evidence")
                if self.eject_evidence == "data":
                    self.partition_since = now()
                    self._partition_accrued_at = self.partition_since
                self._transition(EJECTED)

    def set_outlier(self, flag: bool, reason: str | None = None) -> None:
        """Telemetry-plane anomaly flag (fleet/telemetry.py, once per
        rollup cycle): surfaced in /fleet and the outlier gauge, but
        NEVER a membership input — flagging is advisory, ejection stays
        the state machine's call."""
        with self._lock:
            self.outlier = bool(flag)
            self.outlier_reason = reason if flag else None
        FLEET_REPLICA_OUTLIER.set(1 if flag else 0, replica=self.name)

    # -- views ---------------------------------------------------------------

    def routable(self) -> bool:
        """Eligible for NEW requests right now (half-open counts — the
        acquire path limits it to one trial)."""
        with self._lock:
            return (not self.draining and not self.cordoned
                    and self.state in (HEALTHY, HALF_OPEN))

    def kv_inventory(self) -> tuple:
        """Hex chain keys from the last HEALTHY probe (empty once
        retracted). The router builds X-Cake-KV-Peers from this.
        Empty while EJECTED — probe retraction can lag a data-evidence
        eject by one probe interval, and a directory must never point a
        fetch at a replica the router itself refuses to route to.
        DRAINING/CORDONED replicas keep advertising on purpose: their
        cache is exactly what peers should siphon before they go."""
        with self._lock:
            if self.state == EJECTED:
                return ()
            return self.kv_chains

    def snapshot(self) -> dict:
        with self._lock:
            state = "draining" if ((self.draining or self.cordoned)
                                   and self.state == HEALTHY) else self.state
            return {
                "name": self.name,
                "base_url": self.base_url,
                "state": state,
                "state_age_s": round(now() - self.state_since, 3),
                "inflight": self.inflight,
                "cap": self._cap(),
                "queue_depth": self.queue_depth,
                "occupancy": self.occupancy,
                "consec_fails": self.consec_fails,
                "eject_streak": self.eject_streak,
                "ejects": self.ejects,
                "readmits": self.readmits,
                "eject_evidence": self.eject_evidence,
                "partition_s": (round(now() - self.partition_since, 3)
                                if self.partition_since is not None
                                else None),
                "last_probe_ok": self.last_probe_ok,
                "stale": self.last_probe_ok is False,
                "warm_age_s": round(now() - self.first_seen, 3),
                "cordoned": self.cordoned,
                "outlier": self.outlier,
                "outlier_reason": self.outlier_reason,
            }


class ReplicaRegistry:
    """Thread-safe membership set. Join/leave mutate the map under the
    registry lock; per-replica state lives in each Replica under its own
    lock, so the probe loop and request handlers never serialize on one
    global lock for outcome recording."""

    def __init__(self, policy: MembershipPolicy | None = None):
        self.policy = policy or MembershipPolicy.from_knobs()
        self._lock = threading.Lock()
        self._replicas: dict = {}       # guarded-by: self._lock
        self._rr = 0                    # guarded-by: self._lock
        # eject-history tombstones: a replica that leaves and
        # re-announces under the same name must NOT launder its
        # membership reputation (the backoff ladder restarts otherwise)
        self._history: dict = {}        # guarded-by: self._lock

    # -- membership ----------------------------------------------------------

    def add(self, name: str, base_url: str) -> Replica:
        """Join (idempotent on name: re-announcement refreshes the URL
        but keeps membership state — a re-registered replica does not
        launder its ejection history). A name that LEFT and re-announces
        gets a fresh Replica whose eject history is restored from the
        tombstone while its first-seen warm-up clock resets — the
        reputation is the name's, the warm-up is the process's."""
        with self._lock:
            rep = self._replicas.get(name)
            if rep is not None:
                rep.base_url = base_url.rstrip("/")
                return rep
            rep = Replica(name, base_url, self.policy)
            hist = self._history.pop(name, None)
            self._replicas[name] = rep
        if hist:
            rep.restore_history(hist)
        self.publish()
        return rep

    def remove(self, name: str) -> bool:
        """Leave: drop the replica from routing entirely, retracting its
        per-replica labelsets so scrapes don't carry a ghost forever.
        Its eject history is kept as a tombstone for a same-name
        re-announce (no laundering)."""
        with self._lock:
            rep = self._replicas.pop(name, None)
            gone = rep is not None
            if gone:
                self._history[name] = rep.history()
        if gone:
            for gauge in (FLEET_REPLICA_QUEUE_DEPTH,
                          FLEET_REPLICA_OCCUPANCY, FLEET_REPLICA_INFLIGHT,
                          FLEET_REPLICA_STALE, FLEET_REPLICA_OUTLIER):
                gauge.remove(replica=name)
        self.publish()
        return gone

    def get(self, name: str) -> Replica | None:
        with self._lock:
            return self._replicas.get(name)

    def replicas(self) -> list:
        with self._lock:
            return list(self._replicas.values())

    def names(self) -> list:
        with self._lock:
            return list(self._replicas.keys())

    def next_rr(self) -> int:
        with self._lock:
            self._rr += 1
            return self._rr - 1

    def drain_events(self) -> list:
        """Collect every replica's pending membership events (see
        Replica.drain_events)."""
        out = []
        for r in self.replicas():
            out.extend(r.drain_events())
        return out

    # -- fleet views ---------------------------------------------------------

    def routable_count(self) -> int:
        return sum(1 for r in self.replicas() if r.routable())

    def total_capacity(self) -> int:
        """Admission capacity of the fleet = sum of ROUTABLE replicas'
        caps: an ejected (e.g. partitioned) or draining replica
        contributes nothing — counting it would let the router admit
        load the remaining replicas cannot carry."""
        return sum(r.cap() for r in self.replicas() if r.routable())

    def total_queue_depth(self) -> int:
        return sum(r.snapshot()["queue_depth"] for r in self.replicas())

    def snapshot(self) -> dict:
        reps = [r.snapshot() for r in self.replicas()]
        by_state: dict = {}
        for r in reps:
            by_state[r["state"]] = by_state.get(r["state"], 0) + 1
        return {"replicas": reps, "by_state": by_state,
                "routable": sum(1 for r in reps
                                if r["state"] in (HEALTHY, HALF_OPEN))}

    def publish(self) -> None:
        """Mirror membership into the cake_fleet_replicas{state=} gauge —
        the primary autoscaling signal."""
        counts = {HEALTHY: 0, EJECTED: 0, HALF_OPEN: 0, "draining": 0}
        for r in self.replicas():
            counts[r.snapshot()["state"]] += 1
        for state, n in counts.items():
            FLEET_REPLICAS.set(n, state=state)


def discover_replicas(cluster_key: str, timeout: float = 2.0,
                      **discovery) -> list:
    """Find announced serve replicas over the existing cluster discovery
    plumbing (UDP broadcast filtered by the PSK-derived cluster hash —
    cluster/discovery.py): `cake serve --announce` runs a
    WorkerAdvertiser whose caps carry role="serve", and this filters the
    replies down to those. Returns [(name, base_url), ...]. `discovery`
    passes discover_workers' `addresses` and `discovery_port` through
    (loopback-only discovery in tests and on one host)."""
    from ..cluster.discovery import discover_workers
    out = []
    for w in discover_workers(cluster_key, timeout=timeout, **discovery):
        if (w.get("caps") or {}).get("role") != "serve":
            continue
        out.append((w["name"], f"http://{w['host']}:{w['port']}"))
    return out
