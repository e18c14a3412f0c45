"""Host-side block-pool allocator: free list, refcounts, per-slot tables
(the port's own copy of cake_tpu/serve/paged/allocator.py: BlockAllocator).

Pure bookkeeping (no torch): the physical pool lives on the device
(cache.init_paged_layers); this class decides WHICH physical block backs
which (slot, table-index) pair and when a block is reusable. All methods
run on the engine's scheduler thread — no locking, same discipline as
SlotPool.

Invariants (asserted by check() in the property tests):

  * every block is FREE xor has refcount >= 1;
  * a block's refcount == (#slot-table entries mapping it) + (#prefix
    cache entries pinning it);
  * a slot's table never maps the same physical block at two indices;
  * a block mapped by TWO OR MORE owners is never written — writers call
    ensure_writable() first, which forks a private copy (copy-on-write).

The NULL sentinel (== num_blocks) marks an unmapped table entry; on the
device it is the pool's sink block, which masked writes land on and no
read ever sees.
"""
from __future__ import annotations

__all__ = ["BlockAllocator"]


class BlockAllocator:
    def __init__(self, num_blocks: int, block_tokens: int, slots: int,
                 max_blocks: int):
        if num_blocks < 1:
            raise ValueError(f"block pool needs >= 1 block, got {num_blocks}")
        self.num_blocks = num_blocks
        self.block_tokens = block_tokens
        self.max_blocks = max_blocks              # table entries per slot
        self.NULL = num_blocks
        self._free: list[int] = list(range(num_blocks - 1, -1, -1))
        self._ref = [0] * num_blocks
        # cache_pins[pid]: how many of pid's refs are prefix-cache pins
        # (reclaimable under pressure) rather than live slot mappings
        self._cache_pins = [0] * num_blocks
        self.tables: list[list[int]] = [[self.NULL] * max_blocks
                                        for _ in range(slots)]
        # lifetime counters (observability)
        self.cow_forks = 0

    # -- core refcounting ---------------------------------------------------

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def used_count(self) -> int:
        return self.num_blocks - len(self._free)

    @property
    def shared_count(self) -> int:
        """Blocks referenced by more than one owner (slot tables and/or
        prefix-cache entries) — the refcount-sharing gauge."""
        return sum(1 for r in self._ref if r >= 2)

    def refcount(self, pid: int) -> int:
        return self._ref[pid]

    def alloc(self) -> int | None:
        """Claim a free block with refcount 1; None when exhausted."""
        if not self._free:
            return None
        pid = self._free.pop()
        assert self._ref[pid] == 0
        self._ref[pid] = 1
        return pid

    def ref(self, pid: int, cache_pin: bool = False) -> None:
        if self._ref[pid] < 1:
            raise ValueError(f"ref of unallocated block {pid}")
        self._ref[pid] += 1
        if cache_pin:
            self._cache_pins[pid] += 1

    def deref(self, pid: int, cache_pin: bool = False) -> bool:
        """Drop one reference; returns True when the block was freed."""
        if self._ref[pid] < 1:
            raise ValueError(f"double free of block {pid}")
        if cache_pin:
            if self._cache_pins[pid] < 1:
                raise ValueError(f"block {pid} has no cache pin to drop")
            self._cache_pins[pid] -= 1
        self._ref[pid] -= 1
        if self._ref[pid] == 0:
            self._free.append(pid)
            return True
        return False

    # -- slot tables --------------------------------------------------------

    def table(self, slot: int) -> list[int]:
        return self.tables[slot]

    def blocks_of(self, slot: int) -> list[int]:
        """Mapped physical ids of a slot, in table order (dense prefix)."""
        return [p for p in self.tables[slot] if p != self.NULL]

    def map(self, slot: int, idx: int, pid: int) -> None:
        """Point table entry (slot, idx) at pid. The caller owns the ref
        being handed over (a fresh alloc(), or a ref() bump for a shared
        block)."""
        if self.tables[slot][idx] != self.NULL:
            raise ValueError(f"slot {slot} table[{idx}] already mapped")
        self.tables[slot][idx] = pid

    def ensure(self, slot: int, idx: int) -> int | None:
        """Return the pid backing (slot, idx), allocating one if the
        entry is unmapped. None = pool exhausted (caller preempts or
        evicts and retries)."""
        pid = self.tables[slot][idx]
        if pid != self.NULL:
            return pid
        pid = self.alloc()
        if pid is None:
            return None
        self.tables[slot][idx] = pid
        return pid

    def unmap_entry(self, slot: int, idx: int) -> bool:
        """Unmap ONE table entry (deref; shared blocks survive under
        their other owners). Returns True when the block was actually
        FREED — the speculative-frontier rollback unit."""
        pid = self.tables[slot][idx]
        if pid == self.NULL:
            return False
        self.tables[slot][idx] = self.NULL
        return self.deref(pid)

    def unmap_slot(self, slot: int) -> list[int]:
        """Release every block the slot maps (deref; shared blocks
        survive under their other owners). Returns the pids that were
        actually FREED."""
        freed = []
        for idx, pid in enumerate(self.tables[slot]):
            if pid == self.NULL:
                continue
            if self.deref(pid):
                freed.append(pid)
            self.tables[slot][idx] = self.NULL
        return freed

    def ensure_writable(self, slot: int, idx: int, copy_block) -> int | None:
        """Copy-on-write guard: make (slot, idx) safe to write. A block
        with refcount 1 is returned as-is; a SHARED block is forked —
        a fresh block is allocated, `copy_block(src_pid, dst_pid)` copies
        the bytes (device-side), the slot's ref moves to the fork.
        None = pool exhausted mid-fork (nothing changed)."""
        pid = self.tables[slot][idx]
        if pid == self.NULL:
            raise ValueError(f"slot {slot} table[{idx}] unmapped")
        if self._ref[pid] == 1:
            return pid
        fork = self.alloc()
        if fork is None:
            return None
        copy_block(pid, fork)
        self.tables[slot][idx] = fork
        self.deref(pid)
        self.cow_forks += 1
        return fork

    # -- invariants (property tests) ----------------------------------------

    def check(self) -> None:
        free = set(self._free)
        assert len(free) == len(self._free), "free list holds duplicates"
        mapped: dict[int, int] = {}
        for t in self.tables:
            seen = set()
            for pid in t:
                if pid == self.NULL:
                    continue
                assert pid not in seen, "slot maps one block twice"
                seen.add(pid)
                mapped[pid] = mapped.get(pid, 0) + 1
        for pid in range(self.num_blocks):
            if pid in free:
                assert self._ref[pid] == 0, f"free block {pid} has refs"
                assert pid not in mapped, f"free block {pid} still mapped"
            else:
                assert self._ref[pid] >= 1, f"used block {pid} unreferenced"
                assert self._ref[pid] == mapped.get(pid, 0) \
                    + self._cache_pins[pid], \
                    f"block {pid}: ref {self._ref[pid]} != " \
                    f"{mapped.get(pid, 0)} mappings + " \
                    f"{self._cache_pins[pid]} cache pins"
