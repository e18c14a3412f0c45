"""Replica lifecycle manager (the port's copy of
cake_tpu/fleet/lifecycle.py): the autoscaler's hands.

The controller (fleet/autoscale.py) decides; this module executes
against real OS processes from inside the router's event loop:

  SCALE-OUT  spawn a replica process from the CAKE_SCALE_SPAWN_CMD
             template ({port} and {name} filled per spawn, the port
             allocated from the OS), e.g. "python -m cake_tpu_torch.cli
             serve --flagship --port {port} --announce --cluster-key K
             --announce-name {name}", then poll the child's /health
             until it answers 200 — only THEN is the replica admitted to
             the routing registry, so a cold replica (weights, kernel
             builds, graph captures) never takes traffic.

  SCALE-IN   cordon the victim in the registry (the router stops
             routing NEW requests immediately), SIGTERM the process —
             which triggers the replica's own graceful drain — then wait
             for the exit up to the drain budget and reap. SIGKILL (to
             the child's whole process group) only fires after the
             budget.

  SWEEP      each probe cycle, managed processes that exited
             UNEXPECTEDLY (crash, kill -9) are reaped and removed from
             routing; the controller's below-min rule then decides the
             replacement.

Spawn-to-routable durations feed a rolling estimate the router's
no-replica 503 uses for Retry-After during a cold start.

Every transition lands on the autoscale decisions ring (spawned /
admitted / spawn_failed / retire / reaped / died). The spawn and probe
seams are injectable so tests drive the whole state machine with stub
processes and a fake prober; the default prober is the port's
standard-library client (fleet/http.py). No torch is imported here.
"""
from __future__ import annotations

import asyncio
import logging
import os
import shlex
import signal
import socket
import subprocess
from collections import deque

from ..obs import (FLEET_SCALE_MANAGED_REPLICAS, FLEET_SCALE_PENDING_SPAWNS,
                   now)
from . import knobs
from .http import request

log = logging.getLogger("cake_tpu_torch.fleet")

__all__ = ["ReplicaLifecycle", "ManagedReplica"]

# spawn-to-routable estimate before any spawn has completed (seconds);
# replaced by the rolling mean as soon as one admission lands
DEFAULT_SPAWN_ETA_S = 10.0

# rolling window of completed spawn durations the ETA averages
_SPAWN_HISTORY = 8

# grace past CAKE_DRAIN_TIMEOUT_S before a retiring replica that never
# exited is SIGKILLed (the drain budget is the replica's; this covers
# process teardown after it)
_REAP_GRACE_S = 10.0


class ManagedReplica:
    """One process the router owns: spawn identity + Popen handle +
    admission bookkeeping. Event-loop-confined, like all lifecycle
    state."""

    def __init__(self, name: str, port: int, proc, spawned_at: float):
        self.name = name
        self.port = port
        self.base_url = f"http://127.0.0.1:{port}"
        self.proc = proc
        self.spawned_at = spawned_at
        self.admitted_at: float | None = None
        self.retiring = False

    @property
    def pending(self) -> bool:
        return self.admitted_at is None and not self.retiring

    def snapshot(self, t: float) -> dict:
        return {"name": self.name, "port": self.port,
                "pid": getattr(self.proc, "pid", None),
                "age_s": round(t - self.spawned_at, 3),
                "admitted": self.admitted_at is not None,
                "retiring": self.retiring}


class ReplicaLifecycle:
    """Owns every replica process the autoscaler creates. All methods
    run on the router's event loop; blocking waits are poll loops with
    asyncio sleeps, and process I/O is non-blocking (Popen + poll())."""

    def __init__(self, registry, *,
                 spawn_cmd: str | None = None,
                 spawn_timeout_s: float | None = None,
                 drain_timeout_s: float | None = None,
                 record=None, clock=now, spawner=None, prober=None):
        self.registry = registry
        self.spawn_cmd = spawn_cmd if spawn_cmd is not None \
            else (knobs.get_str("CAKE_SCALE_SPAWN_CMD") or None)
        self.spawn_timeout_s = spawn_timeout_s \
            if spawn_timeout_s is not None \
            else knobs.get("CAKE_SCALE_SPAWN_TIMEOUT_S")
        self.drain_timeout_s = drain_timeout_s \
            if drain_timeout_s is not None \
            else knobs.get("CAKE_DRAIN_TIMEOUT_S")
        # decisions-ring hook (DecisionLog.record); a no-op default
        # keeps the manager usable standalone in tests
        self._record = record if record is not None \
            else (lambda kind, **fields: None)
        self._clock = clock
        # test seams: spawner(cmd_list) -> Popen-like (poll/terminate/
        # kill/pid), prober(base_url) -> awaitable bool (one /health try)
        self._spawner = spawner or self._default_spawner
        self._prober = prober or self._default_prober
        self._managed: dict[str, ManagedReplica] = {}
        self._tasks: set = set()
        self._seq = 0
        self._spawn_secs: deque = deque(maxlen=_SPAWN_HISTORY)

    # -- spawn (scale-out) ---------------------------------------------------

    @staticmethod
    def _default_spawner(cmd: list):
        # own session: the router's SIGTERM must not blanket-kill the
        # fleet it manages — close() retires children deliberately
        return subprocess.Popen(cmd, start_new_session=True)

    async def _default_prober(self, base_url: str) -> bool:
        async def probe():
            async with await request("GET", base_url + "/health",
                                     connect_timeout=2.0) as r:
                await r.read()
                return r.status == 200
        try:
            return await asyncio.wait_for(probe(), 2.0)
        except asyncio.CancelledError:
            raise
        except Exception:
            return False

    @staticmethod
    def _free_port() -> int:
        with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    def _next_name(self) -> str:
        taken = set(self.registry.names()) | set(self._managed)
        while True:
            self._seq += 1
            name = f"scale-{self._seq}"
            if name not in taken:
                return name

    def spawn(self, reason: str = "") -> str | None:
        """Launch one replica process and start its admission poll.
        Returns the managed name, or None when no spawn template is
        configured (the decision still logged upstream — an operator
        running without CAKE_SCALE_SPAWN_CMD gets advisory decisions)."""
        if not self.spawn_cmd:
            log.warning("scale-out decided (%s) but CAKE_SCALE_SPAWN_CMD "
                        "is unset; not spawning", reason or "?")
            return None
        t = self._clock()
        name = self._next_name()
        port = self._free_port()
        cmd = shlex.split(self.spawn_cmd.format(port=port, name=name))
        try:
            proc = self._spawner(cmd)
        except OSError as e:
            log.error("spawn failed to launch %r: %s", cmd, e)
            self._record("spawn_failed", replica=name,
                         error=f"{type(e).__name__}: {e}")
            return None
        mr = ManagedReplica(name, port, proc, t)
        self._managed[name] = mr
        self._record("spawned", replica=name, port=port,
                     pid=getattr(proc, "pid", None), reason=reason)
        self._publish()
        self._track(self._admit(mr))
        return name

    async def _admit(self, mr: ManagedReplica) -> None:
        """Poll the child's /health until 200, then join the routing
        registry. A child that dies or never answers within the spawn
        timeout is killed and recorded spawn_failed."""
        deadline = mr.spawned_at + self.spawn_timeout_s
        while True:
            if mr.retiring:
                return
            if mr.proc.poll() is not None:
                self._record("spawn_failed", replica=mr.name,
                             error="process exited before healthy")
                self._drop(mr)
                return
            if await self._prober(mr.base_url):
                break
            if self._clock() >= deadline:
                self._record("spawn_failed", replica=mr.name,
                             error=f"no healthy /health within "
                                   f"{self.spawn_timeout_s:g}s")
                self._kill(mr)
                self._drop(mr)
                return
            await asyncio.sleep(0.25)
        t = self._clock()
        mr.admitted_at = t
        self._spawn_secs.append(t - mr.spawned_at)
        self.registry.add(mr.name, mr.base_url)
        self._record("admitted", replica=mr.name,
                     spawn_s=round(t - mr.spawned_at, 3))
        self._publish()

    # -- retire (scale-in) ---------------------------------------------------

    def retire(self, name: str, reason: str = "") -> bool:
        """Begin a graceful scale-in of a managed replica. Returns False
        when the name is not managed (the controller only selects
        managed victims; this guards direct callers)."""
        mr = self._managed.get(name)
        if mr is None or mr.retiring:
            return False
        mr.retiring = True
        rep = self.registry.get(name)
        if rep is not None:
            rep.cordon()            # stop NEW routing immediately
        self._record("retire", replica=name, reason=reason)
        self._publish()
        self._track(self._drain_and_reap(mr))
        return True

    async def _drain_and_reap(self, mr: ManagedReplica) -> None:
        """SIGTERM triggers the replica's own graceful drain (in-flight
        requests and live streams finish); wait for the exit up to the
        drain budget + grace, SIGKILL as the backstop, then drop it
        from routing."""
        try:
            if mr.proc.poll() is None:
                mr.proc.terminate()
        except OSError:
            pass
        deadline = self._clock() + self.drain_timeout_s + _REAP_GRACE_S
        killed = False
        while mr.proc.poll() is None:
            if self._clock() >= deadline:
                self._kill(mr)
                killed = True
                break
            await asyncio.sleep(0.1)
        # reap the zombie without blocking the loop (the process is
        # already dead or just SIGKILLed)
        try:
            mr.proc.wait(timeout=5.0)
        except Exception:
            pass
        self._record("reaped", replica=mr.name, forced=killed)
        self._drop(mr)

    # -- sweep (unexpected deaths) -------------------------------------------

    def sweep(self) -> list:
        """Reap managed processes that exited OUTSIDE a retire (crash,
        kill -9): remove them from routing so their gauges retract and
        the controller's below-min rule sees the hole. Returns the
        reaped names. Called once per probe cycle."""
        dead = [mr for mr in list(self._managed.values())
                if not mr.retiring and mr.proc.poll() is not None]
        for mr in dead:
            self._record("died", replica=mr.name,
                         exit_code=mr.proc.poll())
            self._drop(mr)
        return [mr.name for mr in dead]

    # -- views ---------------------------------------------------------------

    def is_managed(self, name: str) -> bool:
        return name in self._managed

    def managed_names(self) -> list:
        return list(self._managed)

    def pending_count(self) -> int:
        return sum(1 for mr in self._managed.values() if mr.pending)

    def pending_spawn_eta(self) -> int | None:
        """Seconds until the oldest pending spawn is expected routable
        (rolling mean of completed spawn durations), or None when no
        spawn is in flight — the cold-start Retry-After."""
        pending = [mr for mr in self._managed.values() if mr.pending]
        if not pending:
            return None
        expected = (sum(self._spawn_secs) / len(self._spawn_secs)) \
            if self._spawn_secs else DEFAULT_SPAWN_ETA_S
        t = self._clock()
        remaining = max(expected - (t - min(mr.spawned_at
                                            for mr in pending)), 1.0)
        return int(remaining + 0.999)

    def snapshot(self) -> dict:
        t = self._clock()
        return {"managed": [mr.snapshot(t)
                            for mr in self._managed.values()],
                "pending_spawns": self.pending_count(),
                "spawn_eta_s": self.pending_spawn_eta(),
                "spawn_cmd_set": bool(self.spawn_cmd)}

    # -- teardown ------------------------------------------------------------

    async def close(self) -> None:
        """Router shutdown: cancel admission/drain tasks and terminate
        every managed process (the router spawned them; an exiting
        router must not orphan a fleet nothing owns)."""
        for task in list(self._tasks):
            task.cancel()
        for task in list(self._tasks):
            try:
                await task
            except (asyncio.CancelledError, Exception):
                pass
        self._tasks.clear()
        for mr in list(self._managed.values()):
            try:
                if mr.proc.poll() is None:
                    mr.proc.terminate()
            except OSError:
                pass
        deadline = self._clock() + self.drain_timeout_s + _REAP_GRACE_S
        for mr in list(self._managed.values()):
            while mr.proc.poll() is None:
                if self._clock() >= deadline:
                    self._kill(mr)
                    break
                await asyncio.sleep(0.1)
            self._drop(mr)

    # -- internals -----------------------------------------------------------

    def _track(self, coro) -> None:
        task = asyncio.create_task(coro)
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)

    def _kill(self, mr: ManagedReplica) -> None:
        try:
            if mr.proc.poll() is None:
                # the whole session: spawn templates may wrap the serve
                # process in a shell, and an orphaned grandchild would
                # keep the port
                try:
                    os.killpg(os.getpgid(mr.proc.pid), signal.SIGKILL)
                except (OSError, AttributeError):
                    mr.proc.kill()
        except OSError:
            pass

    def _drop(self, mr: ManagedReplica) -> None:
        self._managed.pop(mr.name, None)
        self.registry.remove(mr.name)
        self._publish()

    def _publish(self) -> None:
        FLEET_SCALE_PENDING_SPAWNS.set(self.pending_count())
        FLEET_SCALE_MANAGED_REPLICAS.set(len(self._managed))
