"""PagedKV: the device-facing side of the paged KV pool (counterpart of
cake_tpu/serve/paged/pool.py: PagedKV, KVPoolExhausted, pow2_block_tokens).

Owns the physical block pool (cache.init_paged_layers: one extra sink
block at index num_blocks, the NULL id), the per-slot rows of
sliding-window and linear-attention layers, the device block table ([B,
M] int32) that the model's paged programs read, and the host-side
BlockAllocator that mirrors it. The serve engine talks to this object;
the allocator never touches torch and the engine never touches block
ids.

The paged prefill programs (`prefill`, graphs.PrefillGraphs over
TextModel.prefill_chunk_paged_into) read this object's pool, rows and
tables at fixed addresses, as the decode graph does.

Everything here runs on the engine's scheduler thread. Every allocator
change to a table entry updates the device table at once, without a host
sync: a single entry is a scalar write, a row is one copy from pinned
memory. The swap transport (swap_out / swap_in) is the slow path and
syncs on purpose. Every change to the allocator's counts republishes the
pool's gauges (obs: free, used and shared blocks) from host counters.
"""
from __future__ import annotations

import torch

from ...models.common.cache import reset_layers
from ...obs import (SERVE_KV_BLOCKS_FREE, SERVE_KV_BLOCKS_SHARED,
                    SERVE_KV_BLOCKS_USED)
from .allocator import BlockAllocator

__all__ = ["PagedKV", "KVPoolExhausted", "pow2_block_tokens"]


class KVPoolExhausted(RuntimeError):
    """The block pool cannot satisfy an allocation even after prefix-cache
    eviction and preemption: the request fails with a typed error instead
    of wedging the scheduler."""

    def __init__(self, msg: str, retry_after_s: int = 2):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


def pow2_block_tokens(n: int, chunk: int) -> int:
    """Clamp the block size to a power of two in [8, chunk]: chunk % block
    == 0 keeps every chunked-prefill boundary a block boundary, which the
    prefix share unit hangs off."""
    n = max(8, min(int(n), chunk))
    b = 8
    while b * 2 <= n:
        b *= 2
    return b


class PagedKV:
    def __init__(self, model, slots: int, ctx: int, num_blocks: int,
                 block_tokens: int, chunk: int | None = None):
        """chunk: the longest prefill chunk (default ctx), which sizes the
        prefill programs' token buffer."""
        self.model = model
        self.slots = slots
        self.ctx = ctx
        self.bt = block_tokens
        self.num_blocks = num_blocks
        self.max_blocks = ctx // block_tokens
        self.alloc = BlockAllocator(num_blocks, block_tokens, slots,
                                    self.max_blocks)
        self.NULL = self.alloc.NULL
        self.device = model.device
        self.pool, self.rows = model.new_paged(num_blocks, block_tokens,
                                               slots, ctx)
        self.has_rows = any(self.rows)
        # device bytes one physical block costs across every pooled layer
        # (the prefix cache's capacity unit); the sink is not counted
        self.block_bytes = sum(t[0].numel() * t.element_size()
                               for pl in self.pool for t in pl.values())
        self.tables = torch.full((slots, self.max_blocks), self.NULL,
                                 dtype=torch.int32, device=self.device)
        # eviction hook: () -> int, blocks actually freed (wired to the
        # paged prefix cache's LRU by the engine)
        self.evictor = None
        self.swaps = 0
        # the paged prefill programs, one captured graph per (bucket,
        # flash mode) on a card (models/common/graphs.py: PrefillGraphs);
        # bound to the buffers, not to self (no reference cycle)
        pool, rows, tables = self.pool, self.rows, self.tables
        self.prefill = model.prefill_graphs(
            lambda io, bucket, mode: model.prefill_chunk_paged_into(
                pool, rows, tables, io, bucket, mode),
            self.max_blocks * block_tokens, chunk or ctx)
        self._publish()

    @classmethod
    def build(cls, model, slots: int, ctx: int, num_blocks: int,
              block_tokens: int, chunk: int) -> "PagedKV":
        if chunk & (chunk - 1):
            raise ValueError(f"prefill chunk {chunk} must be a power of two "
                             "so that block boundaries align with chunk "
                             "boundaries")
        bt = pow2_block_tokens(block_tokens, chunk)
        if ctx % bt:
            raise ValueError(f"kv_block_tokens={bt} must divide the serve "
                             f"context {ctx} so the paged view keeps the "
                             "contiguous row layout")
        if not any(s.kind == "full" and s.window is None
                   for s in model.cfg.layer_specs()):
            raise ValueError("paged KV needs at least one full-attention "
                             "layer: sliding-window rings are O(window) and "
                             "linear state O(1) per slot, and have nothing "
                             "to page")
        return cls(model, slots, ctx, num_blocks, bt, chunk)

    # -- allocation (host) ------------------------------------------------

    def blocks_for(self, tokens: int) -> int:
        """Blocks a sequence of `tokens` tokens occupies."""
        return -(-tokens // self.bt)

    def _alloc_one(self) -> int | None:
        """One free block, evicting prefix-cache LRU units under pressure
        (cache-held blocks are reclaimable capacity)."""
        pid = self.alloc.alloc()
        while pid is None and self.evictor is not None and self.evictor():
            pid = self.alloc.alloc()
        return pid

    def ensure_free(self, n: int) -> bool:
        """Evict prefix-cache LRU until at least `n` blocks are free. A
        parked request never reaches an allocation, so its resume gate
        must count cache pins as the reclaimable capacity they are. False
        = short even with the cache empty."""
        while self.alloc.free_count < n:
            if self.evictor is None or not self.evictor():
                return False
        return True

    def _host_to_device(self, values: list[int]) -> torch.Tensor:
        """int32 tensor on the pool's device, copied without a host sync
        (from pinned memory on a card)."""
        if self.device.type == "cuda":
            host = torch.tensor(values, dtype=torch.int32, pin_memory=True)
            return host.to(self.device, non_blocking=True)
        return torch.tensor(values, dtype=torch.int32)

    def sync_table_row(self, slot: int) -> None:
        """Publish the slot's host table row to the device in one copy."""
        self.tables[slot] = self._host_to_device(self.alloc.tables[slot])
        self._publish()

    def reserve_range(self, slot: int, pos0: int, n: int) -> bool:
        """Ensure blocks for logical positions [pos0, pos0 + n): the
        pre-dispatch step of a prefill chunk or a decode step. Entries
        already mapped are kept on failure (they hold earlier KV); only
        the shortfall is reported. One device write for the whole range."""
        fresh = short = False
        for b in range(pos0 // self.bt, (pos0 + n - 1) // self.bt + 1):
            if self.alloc.tables[slot][b] != self.NULL:
                continue
            pid = self._alloc_one()
            if pid is None:
                short = True
                break
            self.alloc.map(slot, b, pid)
            fresh = True
        if fresh:
            self.sync_table_row(slot)
        return not short

    def trim_to(self, slot: int, tokens: int) -> int:
        """Speculative-frontier rollback (the reference's trim_to): unmap
        every table entry past the blocks a `tokens`-token sequence
        occupies. A verify reserves blocks for the widest accept; after a
        rejection, or before a swap-out, the tail past the committed
        frontier goes back to the pool. Those blocks were the slot's own
        (the frontier never maps a shared block), and need no wipe: the
        verify left no entry at or past its commit frontier, and the
        gather's stale-tenant guards cover reuse. One device write when
        anything changed. Returns the number of blocks freed."""
        keep = self.blocks_for(max(tokens, 1))
        freed = 0
        touched = False
        for idx in range(keep, self.max_blocks):
            if self.alloc.tables[slot][idx] == self.NULL:
                continue
            touched = True
            freed += bool(self.alloc.unmap_entry(slot, idx))
        if touched:
            self.sync_table_row(slot)
        return freed

    def ensure_writable(self, slot: int, block_idx: int) -> bool:
        """Copy-on-write fork of a shared block before a write into it.
        The scheduler never writes a shared block (capture stops short of
        the write frontier), but the allocator promises this to anyone
        who maps shared blocks."""
        pid = self.alloc.ensure_writable(slot, block_idx, self._copy_block)
        if pid is None:
            return False
        self.tables[slot, block_idx] = pid
        self._publish()
        return True

    def _copy_block(self, src: int, dst: int) -> None:
        """Device copy of one physical block (the copy-on-write fork)."""
        for pl in self.pool:
            for name in pl:
                pl[name][dst] = pl[name][src]

    def release_slot(self, slot: int) -> None:
        """Deref every block the slot maps (shared blocks survive under
        the prefix cache or other slots), clear its device table row and
        wipe its sliding-window rows and linear state. Freed blocks are not
        wiped: the gather's stale-tenant guards hide them until a new owner
        writes."""
        self.alloc.unmap_slot(slot)
        self.tables[slot] = self.NULL
        if self.has_rows:
            self.model.row_reset(self.rows, slot)
        self._publish()

    def reset(self) -> None:
        """Back to a fresh pool, in place: every block (the sink too) and
        every row wiped, every table entry NULL, and a fresh allocator.
        The decode graph and the prefill programs read pool, rows and
        tables at fixed addresses, so nothing here rebinds them."""
        reset_layers(self.pool)
        reset_layers(self.rows)
        self.tables.fill_(self.NULL)
        self.alloc = BlockAllocator(self.num_blocks, self.bt, self.slots,
                                    self.max_blocks)
        self._publish()

    # -- model programs -----------------------------------------------------

    def prefill_into(self, slot: int, ids, pos0: int):
        """One chunk of prompt into the slot's mapped blocks (the caller
        reserved them), by replaying its captured prefill program on a
        card. Returns the chunk's last-position logits, a buffer the next
        chunk overwrites."""
        return self.prefill.run(slot, ids, pos0)

    # -- preemption transport (slow path: explicit host syncs) -------------

    def swap_out(self, slot: int, carries) -> dict:
        """Preempt by swap: copy the slot's block bytes, row state and
        decode carries (device tensors indexed [slot]) to host memory,
        then free its blocks. Returns the blob swap_in() restores."""
        idx = [i for i, p in enumerate(self.alloc.tables[slot])
               if p != self.NULL]
        ids = torch.tensor([self.alloc.tables[slot][i] for i in idx],
                           dtype=torch.long, device=self.device)
        blob = {"idx": idx,
                "layers": [{n: t[ids].cpu() for n, t in pl.items()}
                           for pl in self.pool],
                "rows": None,
                # a copy even on the CPU, where .cpu() would be a view
                "carries": [c[slot].to("cpu", copy=True) for c in carries]}
        if self.has_rows:
            blob["rows"] = [{n: t.cpu() for n, t in rl.items()} for rl in
                            self.model.row_snapshot(self.rows, slot)]
        self.release_slot(slot)
        self.swaps += 1
        return blob

    def swap_in(self, slot: int, blob: dict) -> bool:
        """Restore a swapped-out slot into freshly allocated blocks at its
        exact table indices. False = not enough free blocks yet (the caller
        retries later; the blob is untouched)."""
        if not self.ensure_free(len(blob["idx"])):
            return False
        pids = []
        for idx in blob["idx"]:
            pid = self._alloc_one()
            self.alloc.map(slot, idx, pid)
            pids.append(pid)
        dst = torch.tensor(pids, dtype=torch.long, device=self.device)
        for pl, saved in zip(self.pool, blob["layers"]):
            for name in pl:
                pl[name][dst] = saved[name].to(self.device)
        if blob["rows"] is not None:
            self.model.row_install(
                self.rows, [{n: t.to(self.device) for n, t in sn.items()}
                            for sn in blob["rows"]], slot)
        self.sync_table_row(slot)
        return True

    # -- introspection ------------------------------------------------------

    def _publish(self) -> None:
        SERVE_KV_BLOCKS_FREE.set(self.alloc.free_count)
        SERVE_KV_BLOCKS_USED.set(self.alloc.used_count)
        SERVE_KV_BLOCKS_SHARED.set(self.alloc.shared_count)

    def occupancy(self, live_tokens: dict[int, int] | None = None) -> dict:
        """kv_pool health block. `live_tokens`: slot -> frontier tokens,
        for the fragmentation figure (allocated-but-unfilled share of live
        slots' blocks). The sink is not counted."""
        out = {
            "blocks": self.num_blocks,
            "block_tokens": self.bt,
            "free": self.alloc.free_count,
            "used": self.alloc.used_count,
            "occupancy": round(self.alloc.used_count
                               / max(self.num_blocks, 1), 4),
            "shared": self.alloc.shared_count,
            "cow_forks": self.alloc.cow_forks,
            "swaps": self.swaps,
        }
        if live_tokens:
            alloc_tokens = waste = 0
            for slot, toks in live_tokens.items():
                nblk = len(self.alloc.blocks_of(slot))
                alloc_tokens += nblk * self.bt
                waste += max(nblk * self.bt - toks, 0)
            out["fragmentation"] = round(waste / alloc_tokens, 4) \
                if alloc_tokens else 0.0
        return out
