"""Prefix-affinity routing: which replica owns this conversation? (the
port's own copy of cake_tpu/fleet/routing.py: the same bytes, keys and
order for every input)

Each replica's serve engine keeps a shared-prefix KV cache keyed by an
incremental blake2b hash chain over the prompt (serve/prefix_cache.py) —
a follow-up that lands on the replica holding its prefix blocks skips
most of its prefill (warm TTFT). Round-robin throws that away: N
replicas means a 1/N chance of landing warm. This module gives the
router the same chain, one tier up (SGLang's cache-aware routing
insight, minus the remote radix trees):

  * the CONVERSATION HEAD — the leading system message plus the first
    non-system message — is rendered to canonical bytes and hashed with
    the same incremental blake2b(digest_size=16) chain over fixed
    256-byte blocks that the prefix cache uses over token blocks. The
    head is what identifies a conversation: every follow-up request
    carries it verbatim at messages[0..], so the key is STABLE across
    turns, while two different conversations diverge in their first user
    message and spread. The chain depth cap
    (CAKE_FLEET_AFFINITY_BLOCKS, default 64 blocks = 16KB) is a COST
    backstop against pathological first messages, not a tuning knob: it
    must comfortably cover the system prompt + first message, because a
    cap that truncates inside a fleet-wide shared system prompt would
    hash every conversation to one key and melt a single replica.

  * the key is placed on replicas by RENDEZVOUS (highest-random-weight)
    hashing: every replica draws a uniform u = blake2b(key || name) in
    (0, 1) and candidates are ranked by -w / ln(u), the logarithmic
    weighted-rendezvous score — a replica with twice the probed
    capacity (slots from /health) owns twice the conversations in
    expectation, so heterogeneous fleets place load proportionally.
    With equal weights the score is monotone in u, which makes the
    ranking IDENTICAL to the classic unweighted digest sort (placement
    is backward-compatible; benches stay comparable). Adding or
    ejecting a replica reshuffles only the conversations it owned,
    changing ONE replica's weight remaps only conversations moving to
    or from it, and the failover order is DETERMINISTIC — when the
    owner is ejected, every router instance agrees on the same
    next-best replica, so the reroute itself stays cache-friendly.

Pure functions, no I/O: the router feeds them membership and bodies.
"""
from __future__ import annotations

import hashlib
import math

__all__ = ["affinity_key", "rank_replicas", "conversation_head",
           "AFFINITY_BLOCK"]

# bytes per chain block — the router-tier analog of the prefix cache's
# block_tokens (tokens hash here would need the tokenizer the router
# deliberately does not load)
AFFINITY_BLOCK = 256


def conversation_head(messages: list) -> bytes:
    """Canonical bytes of the conversation's identity: leading system
    message(s) + the first non-system message. Follow-up turns append to
    the END of messages, so this prefix is verbatim-stable for the whole
    conversation — the property the affinity key needs."""
    parts = []
    for m in messages:
        role = str(m.get("role", ""))
        content = m.get("content")
        if not isinstance(content, str):
            content = str(content)
        parts.append(f"{role}\x1f{content}\x1e")
        if role != "system":
            break                   # first non-system message ends the head
    return "".join(parts).encode("utf-8", "surrogatepass")


def affinity_key(data: bytes, max_blocks: int = 4) -> bytes:
    """Chain digest over `data` in AFFINITY_BLOCK-byte pieces, capped at
    `max_blocks` — the same incremental blake2b(digest_size=16) chain
    construction as PrefixCache.chain_keys, over bytes instead of token
    ids. Equal capped prefixes <=> equal keys."""
    h = hashlib.blake2b(digest_size=16)
    cap = max(max_blocks, 1) * AFFINITY_BLOCK
    view = data[:cap]
    for b in range(0, len(view), AFFINITY_BLOCK):
        h.update(view[b:b + AFFINITY_BLOCK])
    return h.digest()


def rank_replicas(key: bytes, names: list,
                  weights: dict | None = None) -> list:
    """Weighted rendezvous order of `names` for `key`: descending
    -w / ln(u) with u uniform in (0, 1) from blake2b(key || name),
    name-tiebroken. rank[0] is the owner; rank[1] is the deterministic
    next-best every router agrees on when the owner is ejected.
    `weights` maps name -> capacity (missing or non-positive = 1.0);
    a replica's expected share of keys is proportional to its weight,
    and equal weights reproduce the unweighted digest ordering exactly
    (the score is monotone in u)."""
    def score(name: str) -> float:
        h = hashlib.blake2b(
            key + name.encode("utf-8", "surrogatepass"),
            digest_size=8).digest()
        # (h + 0.5) / 2^64 keeps u strictly inside (0, 1) in exact
        # arithmetic, but digests within ~1024 of 2^64 ROUND to 1.0 in
        # float64 — and ln(1) = 0 would make the score a deterministic
        # ZeroDivisionError for that (key, name) pair forever; clamp to
        # the largest float64 below 1.0 (ties broken by name as usual)
        u = min((int.from_bytes(h, "big") + 0.5) / 2.0 ** 64,
                1.0 - 2.0 ** -53)
        w = float((weights or {}).get(name, 1.0))
        if w <= 0.0:
            w = 1.0
        return -w / math.log(u)
    return sorted(names, key=lambda n: (score(n), n), reverse=True)
