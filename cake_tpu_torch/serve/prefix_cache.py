"""Shared-prefix KV cache (counterpart of cake_tpu/serve/prefix_cache.py:
PrefixCache, PagedPrefixCache).

Chat traffic shares its system prompt across requests. The cache keeps
that work: the prompt's prefix is cut into fixed BLOCK-sized pieces at
chunked-prefill boundaries (block size == chunk size), each block's KV is
captured right after the chunk that completed it, and a later admission
whose prompt starts with the same tokens splices the matched chain into
its row and prefills only the suffix.

Matching is a hash chain: block b's key is blake2b(prompt[: (b+1) *
block]), so lookup walks b = 0, 1, ... to the first miss. The stored token
prefix is compared on every hit, so a hash collision costs compute, never
correctness. Reuse is capped at n-1 tokens: the final prompt token is
always prefilled live, because its logits seed the first sampled token.
Capacity is `capacity_mb` of device bytes, LRU over blocks.

Greedy outputs are bit-identical between a hit and a miss: splicing copies
the exact bytes prefill wrote, and the suffix chunks land on the same
chunk boundaries either way, so every product sees the same shapes and
inputs.

Everything here runs on the engine's scheduler thread. The counters are
plain attributes that `occupancy()` returns, and they feed the metrics
plane's prefix-cache instruments as the reference's do.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from dataclasses import dataclass

import numpy as np

from ..obs import (SERVE_PREFIX_BYTES, SERVE_PREFIX_EVICTIONS,
                   SERVE_PREFIX_HITS, SERVE_PREFIX_MISSES)

__all__ = ["PrefixCache", "PagedPrefixCache"]


@dataclass
class _Block:
    tokens: np.ndarray      # the full prefix this block completes (verify)
    layers: list            # batch-1 per-layer tensors: this block's KV,
                            # a linear layer's state at the block's end
    nbytes: int


@dataclass
class _PagedEntry:
    tokens: np.ndarray      # the full prefix this unit completes (verify)
    pids: list              # physical block ids this entry pins
    snap: list | None       # sliding-window rows and linear state at the
                            # unit's end, installed only from a chain's
                            # final unit
    nbytes: int


def _tree_bytes(layers) -> int:
    return sum(t.numel() * t.element_size() for lc in layers
               for t in lc.values())


class PrefixCache:
    """LRU of prefix blocks of one engine, copied out of the contiguous
    pool (scheduler thread only)."""

    def __init__(self, model, block: int, capacity_bytes: int):
        self.model = model
        self.block = block
        self.capacity = capacity_bytes
        self._blocks: OrderedDict[bytes, _Block | _PagedEntry] = \
            OrderedDict()
        self.bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        # membership version: bumped on every insert and evict, NOT on an
        # LRU touch, so the kvshare inventory mirror refreshes only when
        # the key set changed (the reference's PrefixCache.version)
        self.version = 0

    @classmethod
    def build(cls, model, ctx: int, block: int,
              capacity_mb: float) -> "PrefixCache | None":
        """None when disabled (capacity <= 0) or unsound: a sliding window
        smaller than the block would evict a block's own entries from the
        ring before they could be captured."""
        if capacity_mb <= 0 or block > ctx:
            return None
        for spec in model.cfg.layer_specs():
            if spec.window is not None and spec.window < block:
                return None
        return cls(model, block, int(capacity_mb * 1024 * 1024))

    # -- admission side -----------------------------------------------------

    def chain_keys(self, prompt_ids: list[int]) -> list[bytes]:
        """Key of every block this prompt could match or contribute
        ((n-1) // block of them). One incremental blake2b pass per
        admission; the engine keeps the list for the admission's life."""
        ids = np.asarray(prompt_ids, np.int32)
        h = hashlib.blake2b(digest_size=16)
        keys = []
        for b in range((len(ids) - 1) // self.block):
            h.update(ids[b * self.block:(b + 1) * self.block].tobytes())
            keys.append(h.digest())
        return keys

    def match(self, prompt_ids: list[int], keys: list[bytes]) -> int:
        """Longest cached chain usable for this prompt, in blocks (0 =
        miss). Refreshes the LRU recency of every matched block. Prompts
        too short to ever hit (no keys) count neither a hit nor a miss."""
        if not keys:
            return 0
        ids = np.asarray(prompt_ids, np.int32)
        matched = 0
        for key in keys:
            blk = self._blocks.get(key)
            if blk is None or not np.array_equal(
                    blk.tokens, ids[:len(blk.tokens)]):
                break
            self._blocks.move_to_end(key)
            matched += 1
        if matched:
            self.hits += 1
            SERVE_PREFIX_HITS.inc()
        else:
            self.misses += 1
            SERVE_PREFIX_MISSES.inc()
        return matched

    def splice(self, layers, slot: int, keys: list[bytes], matched: int):
        """Write the matched chain's KV into pool row `slot` (freshly
        wiped) in place. Returns the pool layers."""
        for b in range(matched):
            layers = self.model.slot_splice(
                layers, self._blocks[keys[b]].layers, slot, b * self.block,
                final=b == matched - 1)
        return layers

    def insert(self, layers, slot: int, prompt_ids: list[int],
               block_index: int, keys: list[bytes]) -> None:
        """Capture block `block_index` out of row `slot`, at the chunk
        boundary that completed it. Dedupes on key; evicts LRU past
        capacity."""
        key = keys[block_index]
        if key in self._blocks:
            self._blocks.move_to_end(key)
            return
        end = (block_index + 1) * self.block
        entry_layers = self.model.slot_extract(
            layers, slot, block_index * self.block, self.block)
        blk = _Block(tokens=np.asarray(prompt_ids[:end], np.int32),
                     layers=entry_layers, nbytes=_tree_bytes(entry_layers))
        if blk.nbytes > self.capacity:
            return                          # could never fit; don't thrash
        while self.bytes + blk.nbytes > self.capacity and self._blocks:
            self._evict_lru()
        self._blocks[key] = blk
        self.bytes += blk.nbytes
        self.version += 1
        SERVE_PREFIX_BYTES.set(self.bytes)

    def _pop_lru(self):
        _, old = self._blocks.popitem(last=False)
        self.bytes -= old.nbytes
        self.evictions += 1
        self.version += 1
        SERVE_PREFIX_EVICTIONS.inc()
        SERVE_PREFIX_BYTES.set(self.bytes)
        return old

    def _evict_lru(self) -> int:
        """Drop the LRU entry; its tensors free with their last reference.
        Returns pool blocks freed: none, the contiguous cache owns copies."""
        self._pop_lru()
        return 0

    # -- introspection ------------------------------------------------------

    def occupancy(self) -> dict:
        return {
            "blocks": len(self._blocks),
            "block_tokens": self.block,
            "bytes": self.bytes,
            "capacity_bytes": self.capacity,
            "utilization": round(self.bytes / self.capacity, 4)
            if self.capacity else 0.0,
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
        }


class PagedPrefixCache(PrefixCache):
    """Prefix index over shared paged-pool blocks: an insert pins the live
    slot's physical blocks by refcount, and a hit maps those same blocks
    into the new slot's table, so a hit moves no KV bytes (the allocator's
    `shared` count goes positive). Only sliding-window rows, which are
    per slot, ride a snapshot, installed from the final matched unit.

    The share unit stays one chunk of tokens (chunk // bt blocks), so the
    hash chain, the n-1 cap and the capture boundaries are the contiguous
    cache's. Cache-held blocks are reclaimable: the allocator evicts LRU
    units under pressure (evict_for_pressure, wired as PagedKV.evictor)."""

    def __init__(self, model, paged, unit: int, capacity_bytes: int):
        super().__init__(model, unit, capacity_bytes)
        self.paged = paged
        self.bpu = unit // paged.bt           # physical blocks per unit
        self.pinned = 0                       # blocks pinned by the cache

    @classmethod
    def build_paged(cls, model, paged, unit: int,
                    capacity_mb: float) -> "PagedPrefixCache | None":
        if capacity_mb <= 0 or unit > paged.ctx or unit % paged.bt:
            return None
        return cls(model, paged, unit, int(capacity_mb * 1024 * 1024))

    def splice(self, layers, slot: int, keys: list[bytes], matched: int):
        """Map the matched chain's blocks into `slot`'s table (a refcount
        bump per block, no KV copy), publish the table row once, and
        install the final unit's row snapshot. `layers` is returned
        untouched (the paged engine keeps no contiguous pool)."""
        for b in range(matched):
            for j, pid in enumerate(self._blocks[keys[b]].pids):
                self.paged.alloc.ref(pid)
                self.paged.alloc.map(slot, b * self.bpu + j, pid)
        self.paged.sync_table_row(slot)
        final = self._blocks[keys[matched - 1]]
        if final.snap is not None:
            self.model.row_install(self.paged.rows, final.snap, slot)
        return layers

    def insert(self, layers, slot: int, prompt_ids: list[int],
               block_index: int, keys: list[bytes]) -> None:
        """Pin unit `block_index` of `slot` as a shared entry, at the chunk
        boundary that completed it. Dedupes on key: a concurrent admission
        that prefilled its own copy keeps its private blocks."""
        key = keys[block_index]
        if key in self._blocks:
            self._blocks.move_to_end(key)
            return
        pids = self.paged.alloc.tables[slot][block_index * self.bpu:
                                             (block_index + 1) * self.bpu]
        if self.paged.NULL in pids:
            return                  # not fully backed (cannot happen after
                                    # a completed chunk)
        snap = None
        snap_bytes = 0
        if self.paged.has_rows:
            snap = self.model.row_snapshot(self.paged.rows, slot)
            snap_bytes = _tree_bytes(snap)
        nbytes = len(pids) * self.paged.block_bytes + snap_bytes
        if nbytes > self.capacity:
            return                          # could never fit; don't thrash
        while self.bytes + nbytes > self.capacity and self._blocks:
            self._evict_lru()
        for pid in pids:
            self.paged.alloc.ref(pid, cache_pin=True)
        end = (block_index + 1) * self.block
        self._blocks[key] = _PagedEntry(
            tokens=np.asarray(prompt_ids[:end], np.int32), pids=list(pids),
            snap=snap, nbytes=nbytes)
        self.bytes += nbytes
        self.version += 1
        self.pinned += len(pids)
        SERVE_PREFIX_BYTES.set(self.bytes)
        self.paged._publish()

    def _evict_lru(self) -> int:
        """Drop the LRU entry and its pins; returns how many blocks were
        actually freed (0 while every pinned block is still mapped by a
        live slot)."""
        old = self._pop_lru()
        self.pinned -= len(old.pids)
        freed = sum(1 for pid in old.pids
                    if self.paged.alloc.deref(pid, cache_pin=True))
        self.paged._publish()
        return freed

    def evict_for_pressure(self) -> int:
        """Allocator pressure hook: evict LRU entries until a block frees
        or the cache is empty. Returns blocks freed (0 = nothing
        reclaimable: escalate to preemption)."""
        while self._blocks:
            freed = self._evict_lru()
            if freed:
                return freed
        return 0

    def occupancy(self) -> dict:
        out = super().occupancy()
        out["shared_blocks"] = self.paged.alloc.shared_count
        out["unit_blocks"] = self.bpu
        return out
