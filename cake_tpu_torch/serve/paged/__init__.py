"""Paged KV for the serve engine (counterpart of cake_tpu/serve/paged/):
the host block allocator, the device-facing pool with swap transport, and
the preemption policy."""
from .allocator import BlockAllocator
from .pool import KVPoolExhausted, PagedKV, pow2_block_tokens
from .preempt import PreemptedSlot, choose_victim, victim_rank

__all__ = ["BlockAllocator", "KVPoolExhausted", "PagedKV",
           "PreemptedSlot", "choose_victim", "pow2_block_tokens",
           "victim_rank"]
