"""Preemption policy and parked-request state for the paged serve engine
(the port's own copy of cake_tpu/serve/paged/preempt.py).

When the block pool is exhausted, a victim slot is evicted to make room,
in one of the reference's two modes (the engine's `preempt_mode`):
"swap" copies the slot's blocks and its decode carries to host memory and
frees its blocks, and resume writes the same bytes into fresh blocks;
"recompute" frees the blocks outright, and resume replays the prompt and
the emitted tokens through the prefill programs (the engine's
`_replay_slot`). An admission that is still prefilling is requeued in
either mode, labelled "recompute" as the reference labels it: it has
emitted nothing, so its resume is a clean restart of its prefill.

Victim choice follows the QoS class: the LOWEST class goes first (batch
before standard before interactive), and within a class the latest
admission (LIFO, the vLLM rule: the request that has consumed the least
scheduler work is the cheapest to redo, and the oldest in its class can
never be starved by newcomers). Single-class traffic therefore behaves
as before classes existed. Parked requests resume oldest-first, before
any new admission, as soon as a slot and enough blocks are free.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..admission.classes import class_of, priority

__all__ = ["PreemptedSlot", "choose_victim", "victim_rank"]


@dataclass
class PreemptedSlot:
    req: object                       # ServeRequest
    mode: str                         # "swap" | "recompute"
    tokens_at_preempt: int            # frontier tokens (resume gating)
    blob: dict | None = None          # swap payload (None for requeue)


def victim_rank(req) -> tuple:
    """Sort key under which the MAX element is the preferred victim:
    lowest QoS class first (negated priority), latest admission within a
    class (LIFO). Shared by slot victim choice and the mid-prefill requeue
    pick so the two paths cannot rank classes differently."""
    return (-priority(class_of(req)), getattr(req, "t_enqueue", 0.0))


def choose_victim(candidates: list[tuple[int, object]],
                  exclude: int | None = None) -> tuple[int, object] | None:
    """(slot, req) to preempt from `candidates` [(slot, req)], or None.
    Lowest class first, LIFO within a class; `exclude` protects the slot whose allocation triggered the preemption
    (a slot cannot make room by evicting itself)."""
    pool = [(s, r) for s, r in candidates
            if s != exclude and r is not None]
    if not pool:
        return None
    return max(pool, key=lambda sr: victim_rank(sr[1]))
