"""Decoder-only text model runtime (counterpart of
cake_tpu/models/common/text_model.py: prefill, prefill_chunk,
decode_slots, slot_release, slot_extract, slot_splice, the paged
programs decode_slots_paged and prefill_chunk_paged, row_snapshot,
row_install, row_reset, generate).

PyTorch runs eagerly, so the reference's compiled programs become plain
methods; the decode step also has an in-place form (decode_slots_into)
that graphs.DecodeGraph captures as a CUDA graph on a card, and
`generate` replays captured chunks of decode steps. A prefill chunk has
an in-place form too (prefill_chunk_into, prefill_chunk_paged_into: the
reference's `_prefill_slot` / `_prefill_slot_paged`) that reads its slot,
pos0 and valid_len from the card, so that graphs.PrefillGraph captures
one graph per (pool, bucket, flash mode) as the reference compiles one
executable per (bucket, flash mode). Host-static decisions stay
host-side and identical: the prompt is right-padded to a PREFILL_BUCKETS
width, and select_flash_mode picks "fresh", "append" or the masked path
from (pos0, width, capacity); prefill_key names the program.

The slot pool (the serve engine's KV) is one cache with a batch axis; a
prefill chunk writes into a row view of it in place, and the batched
decode step steps every row at once with per-row positions, per-row
sampling parameters and an `active` mask (an inactive row writes nothing
and keeps its carries).

Paged KV (cache.init_paged_layers): full-attention KV lives in a block
pool addressed through [B, M] block tables. The paged decode step writes
each row's entry into its block and attends through the table (the
paged decode kernel on the card). A paged prefill chunk gathers the
slot's whole M x bt logical row, runs the unchanged prefill paths on it
(so the masked short tail sees exactly the contiguous row's shapes), and
scatters the blocks it touched back.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Iterable

import torch

from ...device import resolve_device
from ...obs import RECORDER
from ...ops.sampling import (SamplingConfig, config_has_filters,
                             push_recent_token, request_key, sample_one,
                             sample_traced, spec_accept)
from ...ops.flash import FLASH_MIN_SEQ
from .cache import (grow_cache, init_cache, init_paged_layers, kv_capacity,
                    paged_drop_entries, paged_gather_layer,
                    paged_scatter_blocks, row_view,
                    slot_extract_block_layers, slot_reset_layers,
                    slot_splice_block_layers, update_kv_cache)
from .config import ModelConfig
from .graphs import (DecodeCarries, DecodeGraph, PrefillGraphs, PrefillIO,
                     SpecCarries)
from ..qwen3_5 import gdn_commit
from .layers import (block_forward, embed_tokens, forward_layers,
                     init_params, lm_head_logits, make_rope)

PREFILL_BUCKETS = (32, 64, 128, 256, 512, 1024, 2048, 4096, 8192)


def bucket_for(n: int, max_len: int) -> int:
    for b in PREFILL_BUCKETS:
        if n <= b:
            return min(b, max_len)
    return max_len


def select_flash_mode(pos0: int, width: int, capacity: int | None) -> str:
    """"fresh" at position 0, "append" while the chunk stays inside the
    unwrapped buffer, else the masked path ("off")."""
    if pos0 == 0:
        return "fresh"
    if capacity is not None and pos0 + width <= capacity:
        return "append"
    return "off"


def check_prefill_bounds(n: int, pos0: int, capacity: int | None,
                         max_len: int) -> int:
    """Validate a prefill against the cache; returns the prompt bucket."""
    bkt = bucket_for(n, max_len)
    if n > bkt:
        raise ValueError(f"prompt length {n} exceeds cache {bkt}")
    limit = max_len if capacity is None else min(capacity, max_len)
    if pos0 + n > limit:
        raise ValueError(f"prefill past cache end: pos0={pos0} + {n} "
                         f"tokens > cache capacity {limit}")
    return bkt


def prefill_key(n: int, pos0: int, capacity: int | None,
                max_len: int) -> tuple[int, str]:
    """(bucket, flash mode) of an n-token chunk at pos0: the in-place
    program a captured graph runs, chosen on the host as the reference
    chooses its executable. Below FLASH_MIN_SEQ every mode takes the
    masked path, so those buckets have one program, "off"."""
    bkt = check_prefill_bounds(n, pos0, capacity, max_len)
    mode = select_flash_mode(pos0, bkt, capacity)
    return bkt, (mode if bkt >= FLASH_MIN_SEQ else "off")


def prefill_start_keys(chunk: int, capacity: int | None,
                       max_len: int) -> list[tuple[int, str]]:
    """The prefill programs an engine captures when it starts: every
    bucket of a chunk of up to `chunk` tokens, "off" below FLASH_MIN_SEQ,
    and from it up "fresh" and, over an unwrapped buffer, "append" (else
    "off"). A chunk that runs past the buffer's end ("off" at a wide
    bucket) has its program captured at first use."""
    keys = []
    for bkt in sorted({bucket_for(n, max_len) for n in range(1, chunk + 1)}):
        if bkt < FLASH_MIN_SEQ:
            keys.append((bkt, "off"))
        else:
            keys += [(bkt, "fresh"),
                     (bkt, "off" if capacity is None else "append")]
    return keys


@dataclass
class Token:
    id: int
    is_end_of_stream: bool


class TextModel:
    """All layers on one device. `device` defaults to `cuda`."""

    def __init__(self, cfg: ModelConfig, params: dict | None = None,
                 tokenizer=None, dtype: torch.dtype = torch.bfloat16,
                 device=None, seed: int = 42,
                 max_cache_len: int | None = None):
        self.cfg = cfg
        self.dtype = dtype
        self.device = resolve_device(device)
        self.tokenizer = tokenizer
        self.max_cache_len = min(max_cache_len or cfg.max_seq_len,
                                 cfg.max_seq_len)
        self.params = (init_params(cfg, seed, dtype, self.device)
                       if params is None else params)
        self.rope = make_rope(cfg, self.device)
        self.last_prefill_mode: str | None = None
        self._runners: dict[tuple[int, int], _ChunkRunner] = {}

    # -- cache ---------------------------------------------------------------

    def new_cache(self, batch: int = 1, kv_len: int | None = None) -> dict:
        return init_cache(self.cfg, batch, kv_len or self.max_cache_len,
                          self.dtype, self.device)

    def grow_cache(self, cache: dict, new_len: int) -> dict:
        """The batch-1 cache re-homed into buffers of new_len slots (rings
        keep their window): the reference's `_grow_to`."""
        return grow_cache(self.cfg, cache, new_len)

    # -- prefill -------------------------------------------------------------

    @torch.no_grad()
    def _prefill_into(self, layers: list[dict], token_ids, pos0: int):
        """Bucket-padded prefill of one sequence into batch-1 `layers` at
        pos0; returns logits [1, V] at the last valid position."""
        ids = [int(t) for t in token_ids]
        n = len(ids)
        cap = kv_capacity(self.cfg, {"layers": layers})
        bkt = check_prefill_bounds(n, pos0, cap, self.max_cache_len)
        padded = torch.zeros((1, bkt), dtype=torch.long)
        padded[0, :n] = torch.as_tensor(ids, dtype=torch.long)
        mode = select_flash_mode(pos0, bkt, cap)
        self.last_prefill_mode = mode
        x = embed_tokens(self.cfg, self.params, padded.to(self.device))
        x = forward_layers(self.cfg, self.params, x, layers, pos0, self.rope,
                           valid_len=n, flash_mode=mode)
        return lm_head_logits(self.cfg, self.params, x[:, n - 1:n])[:, 0]

    def prefill(self, cache: dict, token_ids: Iterable[int], pos0: int = 0):
        """Prefill a batch-1 cache; returns (logits [1, V], cache)."""
        ids = list(token_ids)
        logits = self._prefill_into(cache["layers"], ids, pos0)
        cache["pos"] = pos0 + len(ids)
        return logits, cache

    def prefill_chunk(self, layers: list[dict], slot: int, token_ids,
                      pos0: int):
        """Prefill one chunk of a prompt into pool row `slot` at pos0 (the
        row must hold exactly positions 0..pos0-1). Writes the row in
        place; returns (logits [1, V] at the chunk's last valid position,
        layers). The eager, host-int form; the serve engine runs
        prefill_chunk_into."""
        return self._prefill_into(row_view(layers, slot), token_ids,
                                  pos0), layers

    def _last_logits(self, x: torch.Tensor, valid_len: torch.Tensor,
                     io: PrefillIO) -> None:
        """Logits of the chunk's last valid position, taken on the card at
        clip(valid_len - 1), into io.logits."""
        idx = torch.clamp(valid_len - 1, 0, x.shape[1] - 1).long().reshape(1)
        io.logits.copy_(lm_head_logits(self.cfg, self.params,
                                       x.index_select(1, idx))[:, 0])

    @torch.no_grad()
    def prefill_chunk_into(self, layers: list[dict], io: PrefillIO,
                           bucket: int, mode: str) -> None:
        """The contiguous pool's prefill program (the reference's
        `_prefill_slot`, text_model.py:389-414): the first `bucket` tokens
        of io into pool row meta[0] at position meta[1], meta[2] of them
        valid, all three read on the card; the last valid position's
        logits go to io.logits. `mode` is prefill_key's. Nothing is read
        on the host, so graphs.PrefillGraph captures it; the row must hold
        exactly positions 0..pos0-1, as for prefill_chunk."""
        meta = io.meta
        x = embed_tokens(self.cfg, self.params, io.tokens(bucket))
        x = forward_layers(self.cfg, self.params, x,
                           [dict(lc, meta=meta) for lc in layers], meta[1],
                           self.rope, valid_len=meta[2], flash_mode=mode)
        self._last_logits(x, meta[2], io)

    def prefill_graphs(self, program, capacity: int | None,
                       chunk: int) -> PrefillGraphs:
        """The prefill programs of one pool: `program(io, bucket, mode)`
        (prefill_chunk_into or prefill_chunk_paged_into bound to the
        pool), chunks of up to `chunk` tokens, keyed by prefill_key over
        the pool's unwrapped `capacity`."""
        max_len = self.max_cache_len
        return PrefillGraphs(
            program, lambda n, pos0: prefill_key(n, pos0, capacity, max_len),
            bucket_for(chunk, max_len), self.cfg.vocab_size, self.device)

    # -- batched decode --------------------------------------------------------

    def _decode_step(self, layers, toks, pos, recents, keys, counters,
                     temps, top_ks, top_ps, penalties, active):
        """decode_slots' arithmetic; also returns the step's logits."""
        x = embed_tokens(self.cfg, self.params, toks.long()[:, None])
        x = forward_layers(self.cfg, self.params, x, layers, pos, self.rope,
                           valid_len=active.to(torch.int32))
        logits = lm_head_logits(self.cfg, self.params, x)[:, -1]
        nxt = sample_traced(logits, keys, counters, temps, top_ks, top_ps,
                            penalties, recents)
        nxt = torch.where(active, nxt, toks)
        recents = torch.where(active[:, None],
                              push_recent_token(recents, nxt), recents)
        step = active.to(pos.dtype)
        return (logits, torch.stack([toks, nxt]), nxt, pos + step, recents,
                counters + step.to(counters.dtype))

    @torch.no_grad()
    def decode_slots(self, layers: list[dict], toks: torch.Tensor,
                     pos: torch.Tensor, recents: torch.Tensor,
                     keys: torch.Tensor, counters: torch.Tensor,
                     temps: torch.Tensor, top_ks: torch.Tensor,
                     top_ps: torch.Tensor, penalties: torch.Tensor,
                     active: torch.Tensor):
        """One sampled decode step over every pool row.

        toks/pos: [B] int32 (each row's input token and its position);
        recents: [B, N] int32 (-1 padded); keys/counters: [B] int64 (each
        row's sampling key and the draw it takes now); temps/top_ps/
        penalties: [B] float32; top_ks: [B] int32 (>= vocab disables);
        active: [B] bool. An inactive row (free, or mid-way through a
        chunked prefill) writes nothing to its KV and keeps its token,
        position, recent window and counter; an active row's counter
        advances by one. Every row of the pool is stepped whatever the
        occupancy, so a row's arithmetic, its noise included, never
        depends on how many others are busy. Returns (packed [2, B] =
        [input token ; sampled token], toks, pos, recents, counters); the
        KV pool is updated in place."""
        return self._decode_step(layers, toks, pos, recents, keys,
                                 counters, temps, top_ks, top_ps,
                                 penalties, active)[1:]

    @torch.no_grad()
    def decode_slots_into(self, layers: list[dict], c: DecodeCarries,
                          active: torch.Tensor | None = None) -> None:
        """decode_slots writing its results into the carries it read:
        c.packed, c.logits, c.toks, c.pos, c.recents and c.counters, in
        place (a captured graph needs fixed addresses). `active` replaces
        c.active for this step when given."""
        act = c.active if active is None else active
        logits, packed, nxt, pos, recents, counters = self._decode_step(
            layers, c.toks, c.pos, c.recents, c.keys, c.counters, c.temps,
            c.top_ks, c.top_ps, c.pens, act)
        c.logits.copy_(logits)
        c.packed.copy_(packed)
        c.toks.copy_(nxt)
        c.pos.copy_(pos)
        c.recents.copy_(recents)
        c.counters.copy_(counters)

    @staticmethod
    def paged_layers(pool: list[dict], rows: list[dict],
                     tables: torch.Tensor) -> list[dict]:
        """The per-layer caches of a paged decode step: a pooled layer's
        block pool with the step's tables, else the layer's rows."""
        return [dict(pl, tables=tables) if pl else rl
                for pl, rl in zip(pool, rows)]

    def decode_slots_paged(self, pool: list[dict], rows: list[dict],
                           tables: torch.Tensor, toks: torch.Tensor,
                           pos: torch.Tensor, recents: torch.Tensor,
                           keys: torch.Tensor, counters: torch.Tensor,
                           temps: torch.Tensor, top_ks: torch.Tensor,
                           top_ps: torch.Tensor, penalties: torch.Tensor,
                           active: torch.Tensor):
        """decode_slots over a paged pool: the same carries and contract,
        but full-attention KV is read and written through `tables` ([B, M]
        int32 block ids on the device; NULL = the pool's sink). Row b's
        entry lands in block tables[b, pos[b] // bt]; an inactive row
        writes the sink. `pool` and `rows` (cache.init_paged_layers) are
        updated in place. Returns (packed [2, B], toks, pos, recents,
        counters)."""
        return self.decode_slots(self.paged_layers(pool, rows, tables),
                                 toks, pos, recents, keys, counters, temps,
                                 top_ks, top_ps, penalties, active)

    def decode_slots_paged_into(self, pool: list[dict], rows: list[dict],
                                tables: torch.Tensor,
                                c: DecodeCarries) -> None:
        """decode_slots_paged writing into its carries (decode_slots_into)."""
        self.decode_slots_into(self.paged_layers(pool, rows, tables), c)

    @torch.no_grad()
    def decode_logits(self, cache: dict, token_id: int):
        """One decode step of a batch-1 cache at its position cache["pos"]:
        writes the token's entry and returns (logits [1, V], cache) with
        pos advanced (the reference's decode_logits; the draft-model
        drafter's rollout, the offloaded model's decode step), under the
        spans embed, layers and lm_head."""
        dev = self.device
        pos = int(cache["pos"])
        with RECORDER.span("embed", cat="phase"):
            x = embed_tokens(self.cfg, self.params,
                             torch.tensor([[int(token_id)]], device=dev))
        with RECORDER.span("layers", cat="phase"):
            x = forward_layers(
                self.cfg, self.params, x, cache["layers"],
                torch.tensor([pos], dtype=torch.int32, device=dev),
                self.rope,
                valid_len=torch.ones(1, dtype=torch.int32, device=dev))
        cache["pos"] = pos + 1
        with RECORDER.span("lm_head", cat="phase"):
            return lm_head_logits(self.cfg, self.params, x)[:, -1], cache

    # -- speculative verify (module 9) -----------------------------------------

    def _verify_step(self, layers, toks, pos, recents, keys, counters, temps,
                     top_ks, top_ps, penalties, active, drafts, n_drafts,
                     filt: bool):
        """The verify's arithmetic (the reference's `_spec_slots` /
        `_spec_slots_paged`, text_model.py:477-560 and :697-790): each row
        forwards [input token, drafts] at its own position, the accept
        rule (ops/sampling.py: spec_accept) keeps a prefix of the drafts,
        and only the committed entries (the input and the accepted drafts,
        n_acc + 1) remain in the KV. A contiguous row or a ring takes its
        entries after the accept (attention_forward held them back), so a
        ring keeps the older entries its window still needs, which the
        reference's write-then-truncate loses (ROADMAP §3); a block pool
        takes all the row's real entries before the paged kernel reads
        them, and the rejected ones read -1 after the step. A linear-attention
        layer keeps each step's state of the pass and installs the one
        after the committed tokens (qwen3_5.gdn_commit), which equals the
        reference's re-forward at valid_len = n_acc + 1. A row with no
        drafts takes a plain decode step; an inactive row writes nothing
        and keeps its carries. Returns (logits [B, k+1, V], packed [3, B]
        = [input token ; accepted drafts ; next token], toks, pos,
        recents, counters)."""
        cfg = self.cfg
        s = drafts.shape[1] + 1
        tokens = torch.cat([toks[:, None], drafts.to(toks.dtype)], 1)
        n_drafts = torch.where(active, n_drafts, 0)
        n_input = torch.where(active, n_drafts + 1, 0).to(torch.int32)
        caches = [dict(lc) for lc in layers]
        x = embed_tokens(cfg, self.params, tokens.long())
        x = forward_layers(cfg, self.params, x, caches, pos, self.rope,
                           valid_len=n_input)
        logits = lm_head_logits(cfg, self.params, x)
        n_acc, nxt, recent2 = spec_accept(logits, drafts, n_drafts, keys,
                                          counters, temps, top_ks, top_ps,
                                          penalties, recents, filt)
        n_acc = torch.where(active, n_acc, 0)
        commit = torch.where(active, n_acc + 1, 0).to(torch.int32)
        for lc in caches:
            held = lc.pop("held", None)
            held_linear = lc.pop("held_linear", None)
            if held is not None:
                update_kv_cache(lc, held[0], held[1], pos, commit)
            elif held_linear is not None:
                gdn_commit(lc, held_linear, commit)
            elif "tables" in lc:
                paged_drop_entries(lc, lc["tables"], pos, commit, n_input, s)
        nxt = torch.where(active, nxt, toks)
        recents = torch.where(active[:, None], recent2, recents)
        return (logits, torch.stack([toks, n_acc, nxt]), nxt,
                pos + commit.to(pos.dtype), recents,
                counters + active.to(counters.dtype))

    @torch.no_grad()
    def spec_slots(self, layers: list[dict], toks, pos, recents, keys,
                   counters, temps, top_ks, top_ps, penalties, active,
                   drafts, n_drafts, filt: bool = True):
        """One batched speculative verify over every pool row (the
        reference's spec_slots): decode_slots' carries and contract, plus
        drafts [B, k] int32 (right-padded) and n_drafts [B] int32 (0: a
        plain decode step for that row). Acceptance is ragged per row;
        each active row's position advances by its n_acc + 1 and its
        counter by one. filt=False (no row filters its vocabulary) skips
        the accept rule's per-row sorts. Returns (packed [3, B], toks,
        pos, recents, counters); the KV is updated in place."""
        return self._verify_step(layers, toks, pos, recents, keys, counters,
                                 temps, top_ks, top_ps, penalties, active,
                                 drafts, n_drafts, filt)[1:]

    def spec_slots_paged(self, pool: list[dict], rows: list[dict],
                         tables: torch.Tensor, *args, filt: bool = True):
        """spec_slots over a paged pool (the reference's spec_slots_paged).
        The caller has reserved the blocks of each row's speculative
        frontier [pos, pos + n_drafts]; the block cursor moves by the
        accepted length, and every pool entry at or past pos + n_acc + 1
        reads -1 after the step."""
        return self.spec_slots(self.paged_layers(pool, rows, tables), *args,
                               filt=filt)

    @torch.no_grad()
    def spec_slots_into(self, layers: list[dict], c: SpecCarries,
                        filt: bool) -> None:
        """spec_slots reading and writing fixed carries (the verify graph's
        program): drafts from c.io, the shared decode carries c.decode
        advanced in place, c.packed and c.logits written."""
        d = c.decode
        logits, packed, nxt, pos, recents, counters = self._verify_step(
            layers, d.toks, d.pos, d.recents, d.keys, d.counters, d.temps,
            d.top_ks, d.top_ps, d.pens, d.active, c.drafts, c.n_drafts, filt)
        c.logits.copy_(logits)
        c.packed.copy_(packed)
        d.toks.copy_(nxt)
        d.pos.copy_(pos)
        d.recents.copy_(recents)
        d.counters.copy_(counters)

    def spec_slots_paged_into(self, pool: list[dict], rows: list[dict],
                              tables: torch.Tensor, c: SpecCarries,
                              filt: bool) -> None:
        """spec_slots_paged writing into its carries (spec_slots_into)."""
        self.spec_slots_into(self.paged_layers(pool, rows, tables), c, filt)

    @torch.no_grad()
    def verify_tokens(self, cache: dict, last_token: int, draft_ids, k: int,
                      pos0: int, key: int, counter: int,
                      recent: torch.Tensor, scfg: SamplingConfig):
        """One verify step on a batch-1 cache (generate's speculative
        loop; the reference's verify_tokens): [last_token, drafts] padded
        to k + 1 at pos0, the accept rule under draw `counter` of `key`,
        and only the accepted prefix committed. recent: [1, N]. Returns
        (packed [2] = [n_acc, next token], cache with pos at the commit
        frontier pos0 + n_acc + 1, recent'): one host read of packed,
        which the caller needs anyway."""
        draft = [int(t) for t in list(draft_ids)[:k]]
        n_draft = len(draft)
        check_prefill_bounds(n_draft + 1, pos0,
                             kv_capacity(self.cfg, cache),
                             self.max_cache_len)
        dev = self.device

        def one(v, dtype):
            return torch.tensor([v], dtype=dtype, device=dev)

        drafts = torch.tensor([draft + [0] * (k - n_draft)],
                              dtype=torch.int32, device=dev)
        packed, _, _, recent, _ = self.spec_slots(
            cache["layers"], one(last_token, torch.int32),
            one(pos0, torch.int32), recent, one(key, torch.int64),
            one(counter, torch.int64), one(scfg.temperature, torch.float32),
            one(scfg.top_k or self.cfg.vocab_size, torch.int32),
            one(1.0 if scfg.top_p is None else scfg.top_p, torch.float32),
            one(scfg.repeat_penalty, torch.float32),
            torch.ones(1, dtype=torch.bool, device=dev), drafts,
            one(n_draft, torch.int32), filt=config_has_filters(scfg))
        cache["pos"] = pos0 + int(packed[1, 0]) + 1
        return packed[1:, 0], cache, recent

    @torch.no_grad()
    def sample_one(self, logits: torch.Tensor, key: int, counter: int,
                   scfg: SamplingConfig, recent: torch.Tensor) -> torch.Tensor:
        """Sample the first token off prefill logits [1, V] with the
        request's settings and draw `counter` of its key; recent: [1, N].
        Returns [1] int32."""
        return sample_one(logits, key, counter, scfg, recent,
                          self.cfg.vocab_size)

    @torch.no_grad()
    def slot_release(self, layers: list[dict], slot: int) -> list[dict]:
        """Clear pool row `slot` (positions -1, K/V zero) in place."""
        return slot_reset_layers(layers, slot)

    # -- shared-prefix blocks ------------------------------------------------

    @torch.no_grad()
    def slot_extract(self, layers: list[dict], slot: int, start: int,
                     width: int) -> list[dict]:
        """Copy the prefix block [start, start+width) out of pool row
        `slot` as batch-1 tensors (prefix-cache insert)."""
        return slot_extract_block_layers(self.cfg, layers, slot, start,
                                         width)

    @torch.no_grad()
    def slot_splice(self, layers: list[dict], src_layers: list[dict],
                    slot: int, start: int, final: bool = True) -> list[dict]:
        """Write a cached prefix block taken at `start` into pool row
        `slot` in place, without resetting the rest of the row (prefix-
        cache hit); linear-attention state from the chain's `final` block
        only."""
        return slot_splice_block_layers(self.cfg, layers, src_layers, slot,
                                        start, final)

    # -- paged KV ---------------------------------------------------------------

    def new_paged(self, num_blocks: int, block_tokens: int, batch: int,
                  ctx: int) -> tuple[list[dict], list[dict]]:
        """(pool, rows) of a paged slot pool on the model's device."""
        return init_paged_layers(self.cfg, num_blocks, block_tokens, batch,
                                 ctx, self.dtype, self.device)

    @torch.no_grad()
    def prefill_chunk_paged(self, pool: list[dict], rows: list[dict],
                            tables: torch.Tensor, slot: int, token_ids,
                            pos0: int):
        """prefill_chunk over a paged pool. The slot's whole logical row
        (M x bt entries, the contiguous row's length) is gathered through
        tables[slot] with frontier pos0, the chunk runs on that view
        through the unchanged fresh / append / masked paths, and the
        blocks it touched (pos0 // bt on: never a shared prefix block
        below pos0) are scattered back. The caller must have mapped
        them. Returns the chunk's last-position logits [1, V]."""
        ids = list(token_ids)
        table_row = tables[slot]
        view = []
        for pl, rl in zip(pool, rows):
            if pl:
                g = paged_gather_layer(pl, table_row, pos0)
                view.append({name: t[None] for name, t in g.items()})
            else:
                view.append({name: buf[slot:slot + 1]
                             for name, buf in rl.items()})
        logits = self._prefill_into(view, ids, pos0)
        bt = next(pl["pos"].shape[1] for pl in pool if pl)
        b0 = pos0 // bt
        last = (pos0 + max(len(ids), 1) - 1) // bt
        pids = table_row[b0:last + 1]
        for pl, vl in zip(pool, view):
            if pl:
                paged_scatter_blocks(pl, pids, {
                    name: t[0, b0 * bt:(last + 1) * bt].reshape(
                        -1, bt, *t.shape[2:])
                    for name, t in vl.items()})
        return logits

    @torch.no_grad()
    def prefill_chunk_paged_into(self, pool: list[dict], rows: list[dict],
                                 tables: torch.Tensor, io: PrefillIO,
                                 bucket: int, mode: str) -> None:
        """prefill_chunk_into over a paged pool (the reference's
        `_prefill_slot_paged`, text_model.py:643-694): slot, pos0 and
        valid_len are io's meta, read on the card. Layer by layer, the
        slot's whole logical row is gathered through tables[slot] with
        frontier pos0 (one layer's view alive at a time), the block runs
        on it, and a STATIC window of bucket // bt + 1 table entries is
        written back, slid to clip(pos0 // bt, 0, M - window) and masked
        to the sink outside [pos0 // bt, last written block] (nothing at
        valid_len 0): never a shared prefix block below pos0. A
        sliding-window layer's ring is row `slot` of `rows`."""
        cfg = self.cfg
        meta = io.meta
        pos0, vl = meta[1], meta[2]
        table_row = tables.index_select(0, meta[:1].long())[0]
        view_meta = torch.cat([torch.zeros_like(meta[:1]), meta[1:]])
        null, bt = next(pl["pos"].shape for pl in pool if pl)
        null -= 1                                   # the sink's id
        m = table_row.shape[0]
        nwb = min(bucket // bt + 1, m)
        dev = table_row.device
        b0 = torch.div(pos0, bt, rounding_mode="floor")
        last_b = torch.div(pos0 + vl - 1, bt, rounding_mode="floor")
        shift = torch.clamp(b0, 0, m - nwb)
        bidx = shift + torch.arange(nwb, device=dev)
        touched = (bidx >= b0) & (bidx <= last_b) & (vl > 0)
        pids = torch.where(touched, table_row[bidx], null)
        window = shift * bt + torch.arange(nwb * bt, device=dev)
        x = embed_tokens(cfg, self.params, io.tokens(bucket))
        for j, spec in enumerate(cfg.layer_specs()):
            pl = pool[j]
            if pl:
                g = paged_gather_layer(pl, table_row, pos0)
                lc = {name: t[None] for name, t in g.items()}
                lc["meta"] = view_meta
            else:
                lc = dict(rows[j], meta=meta)
            x, _ = block_forward(cfg, spec, self.params["layers"][j], x, lc,
                                 pos0, self.rope, vl, mode)
            if pl:
                paged_scatter_blocks(pl, pids, {
                    name: lc[name][0].index_select(0, window).reshape(
                        nwb, bt, *lc[name].shape[2:])
                    for name in ("k", "v", "pos")})
        self._last_logits(x, vl, io)

    @torch.no_grad()
    def row_snapshot(self, rows: list[dict], slot: int) -> list[dict]:
        """Batch-1 copy of slot `slot`'s unpooled state (sliding-window
        rings, linear-attention conv and recurrent state): what a paged
        swap and a paged prefix unit carry beside their blocks."""
        return [{name: buf[slot:slot + 1].clone() for name, buf in rl.items()}
                for rl in rows]

    @torch.no_grad()
    def row_install(self, rows: list[dict], snap: list[dict],
                    slot: int) -> list[dict]:
        """Install a row_snapshot into slot `slot` in place."""
        for rl, sn in zip(rows, snap):
            for name, buf in rl.items():
                buf[slot].copy_(sn[name][0])
        return rows

    @torch.no_grad()
    def row_reset(self, rows: list[dict], slot: int) -> list[dict]:
        """Clear slot `slot`'s unpooled state in place; pooled blocks need
        no wipe (the gather's stale-tenant guards hide freed blocks)."""
        return slot_reset_layers(rows, slot)

    # -- single-stream generation ------------------------------------------

    def _chunk_runner(self, kv_len: int, recent_n: int) -> "_ChunkRunner":
        """generate's captured decode program for this KV bucket, built at
        first use and kept."""
        key = (kv_len, recent_n)
        if key not in self._runners:
            self._runners[key] = _ChunkRunner(self, kv_len, recent_n)
        return self._runners[key]

    def generate(self, prompt_ids: list[int], max_new_tokens: int = 256,
                 sampling: SamplingConfig | None = None, seed: int = 0,
                 spec=None, spec_k: int | None = None, on_token=None):
        """Generate up to max_new_tokens (stopping at EOS): one prefill,
        the first token sampled off its logits, then captured chunks of
        GEN_CHUNK batch-1 decode steps, STREAM_DEPTH chunks in flight, EOS
        checked between chunks (the reference's `_decode_chunk`). The
        request samples under key request_key(seed, 0). Returns
        (token_ids, stats).

        `spec` switches the decode to speculation (spec/): "ngram", a
        Drafter, or a draft TextModel; None reads CAKE_SPEC (off when
        unset), False forces it off. Each step a drafter proposes up to
        `spec_k` tokens (CAKE_SPEC_K) and one verify step keeps a prefix
        of them: greedy output equals the plain path's, sampled output
        keeps its distribution. The verify runs eagerly, one program per
        step (spec/verify.py: spec_decode_loop).

        `on_token` receives each Token as the host has it: the first at
        once, the rest as each captured chunk is fetched (under
        speculation, all at the end)."""
        scfg = sampling or SamplingConfig()
        if spec is not False:
            from ...spec import resolve_drafter
            drafter, k = resolve_drafter(spec, spec_k)
            if drafter is not None:
                out, stats = self._generate_spec(prompt_ids, max_new_tokens,
                                                 scfg, seed, drafter, k)
                for t in out if on_token is not None else ():
                    on_token(self.mk_token(t))
                return out, stats
        n = len(prompt_ids)
        kv_len = bucket_for(n + max_new_tokens, self.max_cache_len)
        run = self._chunk_runner(kv_len, scfg.repeat_last_n)
        c = run.carries
        t0 = time.perf_counter()
        slot_reset_layers(run.layers, 0)
        # the prefill program's device form, run eagerly: one chunk of the
        # whole prompt into row 0
        bkt, mode = prefill_key(n, 0, kv_capacity(self.cfg, {
            "layers": run.layers}), self.max_cache_len)
        self.last_prefill_mode = mode
        io = PrefillIO.build(bkt, self.cfg.vocab_size, self.device)
        io.load(0, 0, prompt_ids)
        self.prefill_chunk_into(run.layers, io, bkt, mode)
        logits = io.logits
        key = request_key(seed, 0)
        recent = torch.full((1, scfg.repeat_last_n), -1, dtype=torch.int32,
                            device=self.device)
        tok = self.sample_one(logits, key, 0, scfg, recent)
        out = [int(tok[0])]
        ttft = time.perf_counter() - t0
        emit = (None if on_token is None
                else lambda t: on_token(self.mk_token(t)))
        if emit is not None:
            emit(out[0])
        budget = min(max_new_tokens, kv_len - n)
        t1 = time.perf_counter()
        if len(out) < budget and not self.cfg.is_eos(out[0]):
            c.toks.copy_(tok)
            c.pos.fill_(n)
            c.recents.copy_(push_recent_token(recent, tok))
            c.keys.fill_(key)
            c.counters.fill_(1)
            c.set_sampling(0, scfg.temperature,
                           scfg.top_k or self.cfg.vocab_size,
                           1.0 if scfg.top_p is None else scfg.top_p,
                           scfg.repeat_penalty)
            c.active.fill_(True)
            # the step at position p writes entry p and yields token p+1:
            # steps past the budget are masked, never write the cache
            run.limit.fill_(n + budget - 1)
            out += run.decode(budget - 1, self.cfg.is_eos, emit)
        dt = time.perf_counter() - t1
        return out, {"ttft_s": ttft, "decode_tokens": len(out) - 1,
                     "decode_s": dt,
                     "tok_per_s": (len(out) - 1) / dt if dt > 0 else 0.0}

    def _generate_spec(self, prompt_ids: list[int], max_new_tokens: int,
                       scfg: SamplingConfig, seed: int, drafter, k: int):
        """generate under speculation: the same prefill and first token
        (draw 0 of request_key(seed, 0)) into a batch-1 cache, then
        spec_decode_loop."""
        from ...spec.verify import spec_decode_loop
        n = len(prompt_ids)
        kv_len = bucket_for(n + max_new_tokens, self.max_cache_len)
        cache = self.new_cache(1, kv_len=kv_len)
        t0 = time.perf_counter()
        bkt, mode = prefill_key(n, 0, kv_capacity(self.cfg, cache),
                                self.max_cache_len)
        self.last_prefill_mode = mode
        io = PrefillIO.build(bkt, self.cfg.vocab_size, self.device)
        io.load(0, 0, prompt_ids)
        self.prefill_chunk_into(cache["layers"], io, bkt, mode)
        cache["pos"] = n
        key = request_key(seed, 0)
        recent = torch.full((1, scfg.repeat_last_n), -1, dtype=torch.int32,
                            device=self.device)
        tok = self.sample_one(io.logits, key, 0, scfg, recent)
        out = [int(tok[0])]
        ttft = time.perf_counter() - t0
        t1 = time.perf_counter()
        out, spec_stats = spec_decode_loop(
            self, drafter, k, list(prompt_ids), out, cache, kv_len, key,
            push_recent_token(recent, tok), scfg, max_new_tokens,
            self.cfg.is_eos(out[0]))
        dt = time.perf_counter() - t1
        return out, {"ttft_s": ttft, "decode_tokens": len(out) - 1,
                     "decode_s": dt,
                     "tok_per_s": (len(out) - 1) / dt if dt > 0 else 0.0,
                     **spec_stats}

    def mk_token(self, tid: int) -> Token:
        return Token(id=tid, is_end_of_stream=self.cfg.is_eos(tid))


GEN_CHUNK = 16      # decode steps per generate chunk (the reference's)
STREAM_DEPTH = 2    # generate chunks in flight (the reference's)


class _ChunkRunner:
    """generate's decode program for one KV bucket: a batch-1 cache, its
    carries, and GEN_CHUNK decode steps captured as one DecodeGraph that
    writes each step's token into `out`. A step runs only while pos <
    limit (the budget), so a chunk that overshoots writes nothing past
    it. Two host buffers take turns receiving `out`, so a replay never
    overwrites the chunk being fetched."""

    def __init__(self, model: TextModel, kv_len: int, recent_n: int):
        self.model = model
        dev = model.device
        self.layers = model.new_cache(1, kv_len=kv_len)["layers"]
        self.carries = DecodeCarries.build(1, model.cfg.vocab_size,
                                           recent_n, dev)
        self.limit = torch.zeros(1, dtype=torch.int32, device=dev)
        self.out = torch.zeros(GEN_CHUNK, dtype=torch.int32, device=dev)
        cuda = dev.type == "cuda"
        self.host = [torch.zeros(GEN_CHUNK, dtype=torch.int32,
                                 pin_memory=cuda)
                     for _ in range(STREAM_DEPTH)]
        self.events = [torch.cuda.Event() if cuda else None
                       for _ in range(STREAM_DEPTH)]
        # captured with every row inactive (the carries are fresh)
        self.graph = DecodeGraph(self._chunk, dev, warmup=1)

    @torch.no_grad()
    def _chunk(self) -> None:
        c = self.carries
        for i in range(GEN_CHUNK):
            self.model.decode_slots_into(self.layers, c,
                                         active=c.active & (c.pos < self.limit))
            self.out[i:i + 1].copy_(c.toks)

    def decode(self, n: int, stop, emit=None) -> list[int]:
        """Up to n tokens, ending at the first for which stop(token);
        emit(token), when given, as each is fetched."""
        chunks = -(-n // GEN_CHUNK)
        issued = fetched = 0
        toks: list[int] = []
        while fetched < chunks:
            while issued < chunks and issued - fetched < STREAM_DEPTH:
                k = issued % STREAM_DEPTH
                self.graph.step()
                self.host[k].copy_(self.out, non_blocking=True)
                if self.events[k] is not None:
                    self.events[k].record()
                issued += 1
            k = fetched % STREAM_DEPTH
            if self.events[k] is not None:
                self.events[k].synchronize()
            fetched += 1
            for t in self.host[k].tolist():
                toks.append(t)
                if emit is not None:
                    emit(t)
                if len(toks) == n or stop(t):
                    return toks
        return toks
