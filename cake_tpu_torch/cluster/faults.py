"""Deterministic fault injection for the cluster wire (counterpart of
cake_tpu/cluster/faults.py: the same plans, targets and one-shot rules).

Chaos testing needs failures that land on an exact operation, not "pull a
cable and hope": this module installs a hook into proto's framed
read/write (`proto.FAULT_HOOK` — a single attribute check per frame when
disabled, nothing on import) that can kill, stall, delay, or corrupt any
hop after a chosen number of forward ops.

Channels are labeled when they are created (client.RemoteStage tags its
socket, worker.WorkerServer tags each connection's streams):

    w0      the master's channel TO worker w0 (master side)
    @w0     a connection AT worker w0 (worker side)

A fault plan is a comma-separated list of `target:key=val[;key=val...]`
clauses; `target` is an fnmatch pattern over labels (omitted = `*`).
Plans come from the `CAKE_FAULT_PLAN` env var (read when this module is
first imported) or `install()` in tests. Keys:

    drop_after_ops=N     ops 1..N succeed; op N+1 severs the connection
    delay_ms=D           every op sleeps D ms (gray failure)
    stall_after_ops=N    ops 1..N clean; op N+1 stalls (default 0: the
                         first op) — same after-N semantics as drop/crash
    stall_once_ms=S      ONE op stalls S ms (per-op-deadline trip), once
    corrupt_after_ops=N  op N+1's response frame is corrupted, once
    crash_after_ops=N    op N+1 hard-kills the whole worker (worker-side
                         labels only), once

An "op" is one forward request crossing the channel (master write of a
`forward` frame / worker read of one); one-shot faults (drop, stall,
corrupt, crash) fire exactly once per plan entry, so a recovered channel
is not re-killed — the deterministic single-fault the bit-identical
recovery tests pin. delay_ms keeps applying across reconnects (a gray
worker stays gray until the plan is cleared).

The worker-side sleep blocks the worker's event loop by design: a stalled
event loop IS the gray failure being simulated.
"""
from __future__ import annotations

import fnmatch
import logging
import os
import time
import weakref
from dataclasses import dataclass, field

from . import proto

log = logging.getLogger("cake_tpu_torch.cluster.faults")

# channel object -> label; weak so dead sockets/streams don't accumulate
_labels: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
# worker-side crash callbacks, keyed by worker-side label ("@name")
_crash_cbs: dict[str, object] = {}


def tag(channel, label: str) -> None:
    """Label a channel (socket / StreamReader / StreamWriter) so fault
    plans can target it. Always safe to call; one weak-dict write."""
    try:
        _labels[channel] = label
    except TypeError:
        pass        # non-weakref-able channel: untargetable, not an error


def register_crash(label: str, callback) -> None:
    """Register the hard-kill callback for a worker-side label; invoked
    (on the worker's event loop thread) when crash_after_ops trips."""
    _crash_cbs[label] = callback


def unregister_crash(label: str) -> None:
    _crash_cbs.pop(label, None)


@dataclass
class HopFaults:
    """Fault state for one plan clause (one target pattern)."""

    target: str = "*"
    drop_after_ops: int | None = None
    delay_ms: float = 0.0
    stall_once_ms: float = 0.0
    stall_after_ops: int = 0
    corrupt_after_ops: int | None = None
    crash_after_ops: int | None = None
    ops: int = 0
    fired: set = field(default_factory=set)

    _INT_KEYS = ("drop_after_ops", "corrupt_after_ops", "crash_after_ops",
                 "stall_after_ops")
    _FLOAT_KEYS = ("delay_ms", "stall_once_ms")

    @classmethod
    def parse(cls, clause: str) -> "HopFaults":
        """`[target:]k=v[;k=v...]` — target omitted means every hop."""
        clause = clause.strip()
        target = "*"
        if ":" in clause.split("=", 1)[0]:
            target, clause = clause.split(":", 1)
        hf = cls(target=target.strip() or "*")
        for part in filter(None, (p.strip() for p in clause.split(";"))):
            if "=" not in part:
                raise ValueError(f"fault clause needs key=value: {part!r}")
            k, v = (s.strip() for s in part.split("=", 1))
            if k in cls._INT_KEYS:
                setattr(hf, k, int(v))
            elif k in cls._FLOAT_KEYS:
                setattr(hf, k, float(v))
            else:
                raise ValueError(f"unknown fault key {k!r}")
        return hf

    def matches(self, label: str) -> bool:
        return fnmatch.fnmatch(label, self.target)


class FaultInjector:
    """The installed proto hook: dispatches frames to matching plan
    clauses. State (op counters, one-shot flags) lives here, so it
    survives the reconnects it provokes."""

    def __init__(self, plans: list[HopFaults]):
        self.plans = plans

    def _plans_for(self, channel):
        label = _labels.get(channel)
        if label is None:
            return label, ()
        return label, [p for p in self.plans if p.matches(label)]

    # -- proto seam ---------------------------------------------------------

    def on_write(self, channel, msg: dict) -> None:
        """Before a frame is written. Master-side data-plane ops are
        counted here (one `forward` per op)."""
        if msg.get("t") != "forward":
            return
        label, plans = self._plans_for(channel)
        for p in plans:
            p.ops += 1
            self._apply(p, label, channel)

    def on_read(self, channel, payload: bytes) -> bytes:
        """After a frame's payload is read, before decode. Worker-side
        ops are counted here; corruption happens here on either side."""
        label, plans = self._plans_for(channel)
        if not plans:
            return payload
        t = None
        if label.startswith("@"):
            # only worker-side op counting needs the message type — don't
            # pay a second full msgpack decode of every multi-MB tensor
            # frame on master-side channels
            try:
                t = proto.decode_payload(payload).get("t")
            except Exception:
                t = None
        for p in plans:
            if label.startswith("@") and t == "forward":
                p.ops += 1
                self._apply(p, label, channel)
            if (p.corrupt_after_ops is not None
                    and p.ops > p.corrupt_after_ops
                    and "corrupt" not in p.fired):
                p.fired.add("corrupt")
                log.warning("fault[%s]: corrupting frame after op %d",
                            label, p.ops)
                payload = bytes(b ^ 0xFF for b in payload[:16]) + payload[16:]
        return payload

    # -- fault actions ------------------------------------------------------

    def _apply(self, p: HopFaults, label: str, channel) -> None:
        if p.delay_ms > 0:
            time.sleep(p.delay_ms / 1e3)
        if (p.stall_once_ms > 0 and p.ops > p.stall_after_ops
                and "stall" not in p.fired):
            p.fired.add("stall")
            log.warning("fault[%s]: stalling %.0f ms at op %d", label,
                        p.stall_once_ms, p.ops)
            time.sleep(p.stall_once_ms / 1e3)
        if (p.crash_after_ops is not None and p.ops > p.crash_after_ops
                and "crash" not in p.fired):
            p.fired.add("crash")
            log.warning("fault[%s]: crashing worker at op %d", label, p.ops)
            cb = _crash_cbs.get(label)
            if cb is not None:
                cb()
            raise ConnectionError(f"fault injected: worker {label} crashed")
        if (p.drop_after_ops is not None and p.ops > p.drop_after_ops
                and "drop" not in p.fired):
            p.fired.add("drop")
            log.warning("fault[%s]: dropping connection at op %d", label,
                        p.ops)
            self._sever(channel)
            raise ConnectionError(f"fault injected: {label} connection "
                                  "dropped")

    @staticmethod
    def _sever(channel) -> None:
        try:
            channel.close()
        except Exception:
            pass


def parse_plan(spec: str) -> FaultInjector:
    clauses = [c for c in (s.strip() for s in spec.split(",")) if c]
    if not clauses:
        raise ValueError("empty fault plan")
    return FaultInjector([HopFaults.parse(c) for c in clauses])


def install(spec_or_injector) -> FaultInjector:
    """Activate a fault plan process-wide (proto.FAULT_HOOK)."""
    inj = (spec_or_injector if isinstance(spec_or_injector, FaultInjector)
           else parse_plan(spec_or_injector))
    proto.FAULT_HOOK = inj
    log.warning("fault plan installed: %d clause(s)", len(inj.plans))
    return inj


def active() -> FaultInjector | None:
    return proto.FAULT_HOOK


def clear() -> None:
    proto.FAULT_HOOK = None


# env-driven activation: `CAKE_FAULT_PLAN="w0:drop_after_ops=5"` takes
# effect the moment the cluster plane loads (client.py and worker.py both
# import this module to tag their channels)
_env_plan = os.environ.get("CAKE_FAULT_PLAN")
if _env_plan:
    install(_env_plan)
