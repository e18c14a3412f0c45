"""Crash-only supervision for the serve engine: typed step failures, a
budgeted rebuild state machine, poison attribution, and a wedge watchdog
(the port's own copy of cake_tpu/serve/supervisor.py: STEP_KINDS,
StepFailure, EngineDown, PoisonedRequest, RequestDeadlineExceeded,
classify, fingerprint, Supervisor).

    serving ──step failure──▶ classify ──▶ rebuild-by-replay ──▶ serving
       ▲                         │ budget exhausted                 │
       │                         ▼                                  │
       └──trial step ok── DOWN (503 + Retry-After, /health engine   │
                          block; restore loop probes the device) ◀──┘

  * every failure becomes a kind of STEP_KINDS (wedge | device | poison |
    oom | internal), counted per kind and shown in the engine's health;
  * a recoverable failure triggers `ServeEngine._rebuild`: reset the
    device state in place (every captured graph keeps its addresses) and
    replay every live slot's prompt + generated tokens through the
    captured prefill programs; a greedy continuation is bit-identical;
  * a request implicated in two consecutive crashes is POISONED: the
    batch crash implicates every active slot, the rebuild replays
    suspects last and one at a time, so a re-crash during a solo replay
    names the culprit. That one request fails with a typed
    `PoisonedRequest` (500) and its prompt fingerprint is quarantined,
    instead of the whole pool crash-looping;
  * rebuilds are budgeted (`rebuild_budget` per rolling
    `rebuild_window_s`): past the budget the engine goes DOWN. Submits
    answer a typed `EngineDown` (503 + Retry-After, never a bare 500),
    health carries `down`, and a restore loop probes the device every
    `restore_interval_s` with a trial prefill until one succeeds; then
    serving resumes on the reset pool. `ServeEngine.dead` remains only
    as the last resort (the supervisor itself failing).

The wedge watchdog is a daemon thread that watches the age of the armed
device dispatch against `watchdog_s` (0 disables). It cannot interrupt a
call stuck inside the runtime, so it FLAGS: health reports the engine
wedged (the HTTP /health answers 503, so a balancer routes away) and
`wedge_count` counts the event; if the dispatch then dies the failure is
classified `wedge`, and if it returns the flag clears (slow but alive).
Recovery work (replay, trial probes) is armed with a grace limit instead,
so that a slow recovery is not flagged as a wedge.

Its counts feed the metrics plane as the reference's do: step failures by
kind, rebuilds, wedges and the DOWN gauge (obs: SERVE_STEP_FAILURES,
SERVE_ENGINE_REBUILDS, SERVE_ENGINE_WEDGES, SERVE_ENGINE_DOWN), and every
implicated request's timeline gets a `step_failure` event.

Threading: recovery runs ON the scheduler thread (the engine's device
state is single-threaded by design); the watchdog, the API handlers
(submit / health) and this module share only the small state below,
under `self._lock`.
"""
from __future__ import annotations

import hashlib
import logging
import threading
from collections import OrderedDict, deque

import numpy as np
import torch

from ..obs import (SERVE_ENGINE_DOWN, SERVE_ENGINE_REBUILDS,
                   SERVE_ENGINE_WEDGES, SERVE_STEP_FAILURES, TIMELINES, now)

log = logging.getLogger("cake_tpu_torch.serve.supervisor")

__all__ = ["EngineDown", "PoisonedRequest", "RequestDeadlineExceeded",
           "StepFailure", "Supervisor", "classify", "fingerprint"]

STEP_KINDS = ("wedge", "device", "poison", "oom", "internal")

# the reference's CAKE_STEP_WATCHDOG_S, CAKE_ENGINE_REBUILDS,
# CAKE_ENGINE_REBUILD_WINDOW_S and CAKE_ENGINE_RESTORE_S defaults
DEFAULT_STEP_WATCHDOG_S = 0.0
DEFAULT_REBUILD_BUDGET = 3
DEFAULT_REBUILD_WINDOW_S = 300.0
DEFAULT_RESTORE_INTERVAL_S = 5.0

# watchdog limit for recovery-phase dispatches (replay / trial): a replay
# may capture a prefill program at its first use, and a tight watchdog
# would flag the recovery itself as wedged
REBUILD_GRACE_S = 60.0

# consecutive clean steps after a recovery before crash suspects are
# forgotten: two crashes separated by this much progress are independent
# incidents, not a poison pattern
SUSPECT_CLEAR_STEPS = 8

# quarantined prompt fingerprints kept (FIFO past this)
QUARANTINE_CAP = 128


class EngineDown(RuntimeError):
    """The engine cannot take this request: scheduler dead, rebuild
    budget exhausted, or shut down. The API answers 503 + Retry-After on
    every chat path, never a bare 500 and never a hung stream."""

    def __init__(self, msg: str = "serve engine is down",
                 retry_after_s: int = 10):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


class PoisonedRequest(RuntimeError):
    """This request was implicated in consecutive engine crashes (or its
    fingerprint already sits in quarantine): it fails alone with a 500
    while the pool survives for everyone else."""


class RequestDeadlineExceeded(RuntimeError):
    """The request's TOTAL age (queue wait + prefill + decode) passed the
    engine's request deadline (CAKE_REQUEST_DEADLINE_S): it is cancelled
    with a 504 instead of holding a slot for a client that has surely
    given up."""

    def __init__(self, age_s: float, deadline_s: float):
        super().__init__(
            f"request exceeded its {deadline_s:.1f}s deadline "
            f"(age {age_s:.1f}s)")
        self.age_s = age_s
        self.deadline_s = deadline_s


class StepFailure(RuntimeError):
    """A classified scheduler-step failure (the engine's recovery unit)."""

    def __init__(self, kind: str, cause: BaseException, phase: str,
                 implicated: frozenset):
        assert kind in STEP_KINDS
        super().__init__(
            f"{kind} failure in {phase}: {type(cause).__name__}: {cause}")
        self.kind = kind
        self.cause = cause
        self.phase = phase
        self.implicated = implicated


def classify(exc: BaseException) -> str:
    """Map a raw step exception onto a StepFailure kind, in this order:
    an injected fault's own kind; host or CUDA memory exhaustion (by type,
    then by text) is `oom`; a CUDA runtime error (torch.AcceleratorError
    where the installed torch has it, or a RuntimeError whose text holds
    "CUDA error", which the kernel wrappers' launch failures say) is
    `device`; anything else is `internal` (a scheduler or model bug,
    still recoverable by rebuild, since what a replay needs lives on the
    host)."""
    kind = getattr(exc, "fault_kind", None)
    if kind in STEP_KINDS:
        return kind
    if isinstance(exc, (MemoryError, torch.cuda.OutOfMemoryError)):
        return "oom"
    text = f"{type(exc).__name__}: {exc}".lower()
    if "resource_exhausted" in text or "resource exhausted" in text \
            or "out of memory" in text:
        return "oom"
    accel = getattr(torch, "AcceleratorError", None)
    if (accel is not None and isinstance(exc, accel)) or (
            isinstance(exc, RuntimeError) and "CUDA error" in str(exc)):
        return "device"
    return "internal"


def fingerprint(prompt_ids) -> bytes:
    """Stable identity of a request's content (quarantine key): a retry
    of a poisoned prompt is refused without crashing the pool again."""
    return hashlib.blake2b(np.asarray(prompt_ids, np.int32).tobytes(),
                           digest_size=16).digest()


class Supervisor:
    """Policy half of the crash-only engine. The engine owns the device
    state and calls in (`arm` / `disarm` around dispatches, `on_failure`
    from its loop's catch); the supervisor owns classification, budget,
    suspects, quarantine, and the down flag."""

    def __init__(self, engine,
                 watchdog_s: float = DEFAULT_STEP_WATCHDOG_S,
                 rebuild_budget: int = DEFAULT_REBUILD_BUDGET,
                 rebuild_window_s: float = DEFAULT_REBUILD_WINDOW_S,
                 restore_interval_s: float = DEFAULT_RESTORE_INTERVAL_S):
        self.engine = engine
        self.watchdog_s = watchdog_s
        self.rebuild_budget = rebuild_budget
        self.rebuild_window_s = rebuild_window_s
        self.restore_interval_s = restore_interval_s

        # -- cross-thread state (scheduler / watchdog / API handlers) ------
        self._lock = threading.Lock()
        self._inflight_phase = None     # guarded-by: self._lock
        self._inflight_t0 = 0.0         # guarded-by: self._lock
        self._inflight_limit = 0.0      # guarded-by: self._lock
        self._wedge_pending = False     # guarded-by: self._lock
        self._last_phase = "step"       # guarded-by: self._lock
        self._last_ids = ()             # guarded-by: self._lock
        self._down = None               # guarded-by: self._lock
        self._last_failure = None       # guarded-by: self._lock
        self._quarantine = OrderedDict()  # guarded-by: self._lock

        # -- scheduler-thread-only state -----------------------------------
        self._rebuilds: deque = deque()   # rolling-window timestamps
        self._suspects: frozenset | None = None
        self._replay_ok = 0               # successful replays this rebuild
        self._clean_steps = 0
        # lifetime counters (health)
        self.rebuild_count = 0
        self.wedge_count = 0            # the watchdog thread increments
        self.failures = {kind: 0 for kind in STEP_KINDS}

        self._watchdog = None
        if self.watchdog_s > 0:
            self._watchdog = threading.Thread(
                target=self._watch, daemon=True,
                name="cake-torch-serve-watchdog")
            self._watchdog.start()

    # -- dispatch tracking (scheduler thread) -------------------------------

    def arm(self, phase: str, req_ids=(), grace: bool = False) -> None:
        """A device dispatch is starting: record phase + the requests it
        could implicate (failure attribution) and start the wedge clock.
        `grace` widens the limit for recovery work."""
        limit = (max(self.watchdog_s, REBUILD_GRACE_S) if grace
                 else self.watchdog_s)
        with self._lock:
            self._inflight_phase = phase
            self._inflight_t0 = now()
            self._inflight_limit = limit
            self._last_phase = phase
            self._last_ids = tuple(req_ids)

    def disarm(self) -> None:
        """The dispatch came back: stop the wedge clock; a pending wedge
        flag clears (slow but alive)."""
        with self._lock:
            self._inflight_phase = None
            self._wedge_pending = False

    def _watch(self) -> None:
        """Watchdog thread: flag a dispatch stuck past its limit. It
        cannot preempt the runtime: the flag drives health (503, so a
        balancer routes away) and classification if the step then dies."""
        stop = self.engine._stop
        poll = max(0.02, min(self.watchdog_s / 4.0, 0.5))
        while not stop.wait(poll):
            with self._lock:
                phase = self._inflight_phase
                if phase is None or self._wedge_pending:
                    continue
                age = now() - self._inflight_t0
                if age <= self._inflight_limit:
                    continue
                self._wedge_pending = True
                limit = self._inflight_limit
            self.wedge_count += 1
            SERVE_ENGINE_WEDGES.inc()
            log.error("serve watchdog: %s dispatch in flight %.1fs "
                      "(limit %.1fs): engine wedged", phase, age, limit)
            # black box out the door while the evidence is fresh: the
            # wedged dispatch may never return
            self._dump_flight("wedge")

    # -- failure handling (scheduler thread) --------------------------------

    def on_failure(self, exc: BaseException) -> bool:
        """Drive the recovery state machine for a loop-escaping failure.
        Returns True when the engine may keep running (recovered, or
        honestly DOWN with the restore loop armed); False means die: the
        engine falls to its terminal `dead` state."""
        eng = self.engine
        while True:
            if isinstance(exc, (KeyboardInterrupt, SystemExit)):
                return False
            with self._lock:
                phase = self._last_phase
                implicated = frozenset(self._last_ids)
                wedged = self._wedge_pending
                self._inflight_phase = None
                self._wedge_pending = False

            # attribution BEFORE classification: a second consecutive
            # crash pinned on ONE request out of a previously LARGER
            # suspect set makes the failure `poison` (the rebuild replays
            # suspects last and solo, so a data-dependent crash re-fires
            # on exactly the culprit's own replay while the innocents'
            # replays, the contrast, succeeded). A lone busy slot is never
            # attributed (|prev| must exceed 1): with no other request to
            # contrast against, a repeat crash is indistinguishable from a
            # dying device.
            prev = self._suspects
            narrowed = implicated
            if prev and implicated:
                narrowed = (implicated & prev) or implicated
            poisoned = None
            if prev and len(prev) > 1 and len(narrowed) == 1 \
                    and next(iter(narrowed)) in prev:
                poisoned = next(iter(narrowed))
            if poisoned is not None and phase == "replay" \
                    and self._replay_ok == 0:
                # a replay crash with ZERO successful replays before it is
                # not evidence against the request: a still-broken device
                # kills the FIRST replay too
                poisoned = None

            kind = ("poison" if poisoned
                    else "wedge" if wedged else classify(exc))
            self.failures[kind] += 1
            SERVE_STEP_FAILURES.inc(kind=kind)
            for rid in implicated:
                TIMELINES.event(rid, "step_failure", failure=kind,
                                phase=phase)
            summary = f"{kind} in {phase}: {type(exc).__name__}: {exc}"
            with self._lock:
                self._last_failure = {"kind": kind, "phase": phase,
                                      "error": summary, "at": now()}
            log.error("serve step failure (%s), %d request(s) implicated",
                      summary, len(implicated))

            if poisoned is not None:
                err = PoisonedRequest(
                    f"request {poisoned} implicated in two consecutive "
                    "engine crashes; fingerprint quarantined")
                eng._drop_poisoned(poisoned, err)
                self._suspects = None
            else:
                self._suspects = narrowed or prev
            self._clean_steps = 0

            # rebuild budget: a rolling window, not a lifetime count (a
            # storm is a dying device, an isolated blip is not)
            t = now()
            while self._rebuilds and \
                    self._rebuilds[0] < t - self.rebuild_window_s:
                self._rebuilds.popleft()
            if len(self._rebuilds) >= self.rebuild_budget:
                with self._lock:
                    self._down = {"since": t}
                SERVE_ENGINE_DOWN.set(1)
                log.error(
                    "serve engine DOWN: %d rebuilds inside %.0fs exhausted "
                    "the budget (%d); failing live requests, restore loop "
                    "probing every %.1fs", len(self._rebuilds),
                    self.rebuild_window_s, self.rebuild_budget,
                    self.restore_interval_s)
                eng._fail_all(EngineDown(
                    f"serve engine down: rebuild budget exhausted ({summary})",
                    retry_after_s=self.retry_after_s()))
                self._dump_flight("down")
                return True
            self._rebuilds.append(t)
            self.rebuild_count += 1
            SERVE_ENGINE_REBUILDS.inc()
            self._replay_ok = 0
            try:
                eng._rebuild(self._suspects or frozenset())
                return True
            except BaseException as next_exc:  # recovery crashed: re-enter
                exc = next_exc

    def retry_after_s(self) -> int:
        """Retry-After of a DOWN engine's 503: past the next probe."""
        return max(int(self.restore_interval_s) + 1, 5)

    def _dump_flight(self, reason: str) -> None:
        """Write the engine's iteration ring to CAKE_TRACE_DIR (no-op
        without a trace dir; never raises, see flight.py)."""
        fr = getattr(self.engine, "flight", None)
        if fr is not None:
            fr.dump(reason, extra={"last_failure": self.last_failure()})

    def note_replay_ok(self) -> None:
        """One slot's replay completed: the contrast that makes a later
        replay crash attributable to its own request."""
        self._replay_ok += 1

    def note_ok(self) -> None:
        """One scheduler step completed cleanly; enough of these and the
        suspect set of the last incident is forgotten."""
        if self._suspects is not None:
            self._clean_steps += 1
            if self._clean_steps >= SUSPECT_CLEAR_STEPS:
                self._suspects = None

    def note_probe_failure(self, exc: BaseException) -> None:
        with self._lock:
            self._last_failure = {
                "kind": classify(exc), "phase": "trial",
                "error": f"restore probe failed: "
                         f"{type(exc).__name__}: {exc}",
                "at": now()}
        log.warning("serve restore probe failed: %s", exc)

    def clear_down(self) -> None:
        with self._lock:
            self._down = None
        SERVE_ENGINE_DOWN.set(0)

    # -- quarantine ---------------------------------------------------------

    def quarantine(self, prompt_ids) -> None:
        fp = fingerprint(prompt_ids)
        with self._lock:
            self._quarantine[fp] = now()
            self._quarantine.move_to_end(fp)
            while len(self._quarantine) > QUARANTINE_CAP:
                self._quarantine.popitem(last=False)

    def is_quarantined(self, prompt_ids) -> bool:
        fp = fingerprint(prompt_ids)
        with self._lock:
            return fp in self._quarantine

    # -- introspection (any thread) -----------------------------------------

    def is_down(self) -> bool:
        with self._lock:
            return self._down is not None

    def down_info(self) -> dict | None:
        with self._lock:
            if self._down is None:
                return None
            info = {"down_for_s": round(now() - self._down["since"], 1)}
            if self._last_failure is not None:
                info["last_failure"] = self._last_failure["error"]
            return info

    def wedged(self) -> bool:
        with self._lock:
            return self._wedge_pending

    def last_failure(self) -> dict | None:
        with self._lock:
            if self._last_failure is None:
                return None
            lf = dict(self._last_failure)
            lf["age_s"] = round(now() - lf.pop("at"), 1)
            return lf

    def quarantined_count(self) -> int:
        with self._lock:
            return len(self._quarantine)
