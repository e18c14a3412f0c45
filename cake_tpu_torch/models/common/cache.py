"""Fixed-shape KV cache (counterpart of cake_tpu/models/common/cache.py).

Same layout as the reference: per layer {"k", "v": [B, size, Hkv, D],
"pos": [B, size] int32 (-1 = empty)}; full-attention layers hold position
p at index p, sliding-window layers are rings (index p % size). A
linear-attention layer holds per-row state instead, {"conv": [B, C, K-1]
in the model dtype, "state": [B, Hv, Dk, Dv] float32} (qwen3_5.py): it
has no capacity, nothing to grow, and cannot be truncated.

Unlike the reference, whose arrays are immutable, the port updates the
buffers IN PLACE: `update_kv_cache` writes into the layer's tensors and
returns the same dict, and a slot-pool row is a view of the pool, so a
prefill chunk into a row needs no gather or scatter-back copy.
"""
from __future__ import annotations

import torch

from ..qwen3_5 import init_linear_cache
from .config import ModelConfig


def init_layer_cache(cfg: ModelConfig, spec, batch: int, max_seq_len: int,
                     dtype: torch.dtype, device) -> dict:
    if spec.kind == "linear":
        return init_linear_cache(cfg, batch, dtype, device)
    size = max_seq_len if spec.window is None else min(spec.window,
                                                       max_seq_len)
    shape = (batch, size, cfg.num_key_value_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.full((batch, size), -1, dtype=torch.int32,
                          device=device),
    }


def init_cache(cfg: ModelConfig, batch: int, max_seq_len: int,
               dtype: torch.dtype = torch.bfloat16, device="cpu",
               layer_range: tuple[int, int] | None = None) -> dict:
    """The cache of every layer, or of the contiguous `layer_range` [lo,
    hi) only (a cluster stage holds its own range; the reference's
    init_cache(layer_range=))."""
    lo, hi = layer_range or (0, cfg.num_hidden_layers)
    return {
        "layers": [init_layer_cache(cfg, cfg.layer_spec(i), batch,
                                    max_seq_len, dtype, device)
                   for i in range(lo, hi)],
        "pos": 0,
    }


def update_kv_cache(layer_cache: dict, k_new: torch.Tensor,
                    v_new: torch.Tensor, pos, valid_len=None,
                    row: torch.Tensor | None = None) -> dict:
    """Write S new entries at absolute positions pos .. pos+S-1 (ring
    index = position % size), in place.

    Prefill: `pos` and `valid_len` are host ints; entries at index >=
    valid_len are padding and are not written; when S exceeds a ring's
    size only the last `size` valid entries land.
    Traced prefill (a captured graph's): `pos` and `valid_len` are 0-d
    device tensors and the batch-1 chunk lands in row `row` (a [1] device
    index), the same entries as the host-int form, with no host
    synchronisation (`_update_traced`).
    Batched decode: S == 1, `pos` is a [B] tensor of per-row positions and
    `valid_len` a [B] tensor of 0/1 — a row with 0 keeps its old entry
    (it is not stepping), with no host synchronisation.
    Batched verify commit: S > 1 with per-row `pos` [B] and `valid_len`
    [B]: row b's first valid_len[b] entries land at pos[b] .. (`_update_
    rows`)."""
    kc, vc, pc = layer_cache["k"], layer_cache["v"], layer_cache["pos"]
    size = kc.shape[1]
    if torch.is_tensor(pos) and pos.dim() == 0:
        return _update_traced(layer_cache, k_new, v_new, pos, valid_len, row)
    if torch.is_tensor(pos) and k_new.shape[1] > 1:
        return _update_rows(layer_cache, k_new, v_new, pos, valid_len)
    if torch.is_tensor(pos):
        rows = torch.arange(kc.shape[0], device=kc.device)
        slots = (pos % size).long()
        write = (torch.ones_like(pos, dtype=torch.bool) if valid_len is None
                 else valid_len.bool())
        kc[rows, slots] = torch.where(write[:, None, None], k_new[:, 0],
                                      kc[rows, slots])
        vc[rows, slots] = torch.where(write[:, None, None], v_new[:, 0],
                                      vc[rows, slots])
        pc[rows, slots] = torch.where(write, pos.to(pc.dtype),
                                      pc[rows, slots])
        return layer_cache
    s = k_new.shape[1]
    n = s if valid_len is None else max(0, min(int(valid_len), s))
    start = max(0, n - size)             # only the last `size` valid land
    if n <= start:
        return layer_cache
    positions = torch.arange(pos + start, pos + n, device=kc.device)
    slots = positions % size
    kc[:, slots] = k_new[:, start:n]
    vc[:, slots] = v_new[:, start:n]
    pc[:, slots] = positions.to(pc.dtype)[None, :]
    return layer_cache


def _update_traced(layer_cache: dict, k_new: torch.Tensor,
                   v_new: torch.Tensor, pos: torch.Tensor,
                   valid_len: torch.Tensor, row: torch.Tensor) -> dict:
    """update_kv_cache of a batch-1 chunk at a device position (after the
    reference's traced form, cache.py:59-95). A ring narrower than the
    chunk takes the `size` entries from clip(valid_len - size, 0, S -
    size) by index_select. The W target slots are consecutive positions
    modulo the buffer, so they are distinct; an entry at or past valid_len
    writes back the old bytes of its own slot, in place of the
    reference's dropped write, so no index repeats in one index_put."""
    kc, vc, pc = layer_cache["k"], layer_cache["v"], layer_cache["pos"]
    size, s = kc.shape[1], k_new.shape[1]
    idx = torch.arange(min(s, size), device=kc.device)
    if s > size:
        idx = idx + torch.clamp(valid_len - size, 0, s - size)
        k_new = k_new.index_select(1, idx)
        v_new = v_new.index_select(1, idx)
    positions = pos + idx
    slots = positions % size
    rows = row.long()
    write = idx < valid_len
    kc.index_put_((rows, slots), torch.where(write[:, None, None], k_new[0],
                                             kc[rows, slots]))
    vc.index_put_((rows, slots), torch.where(write[:, None, None], v_new[0],
                                             vc[rows, slots]))
    pc.index_put_((rows, slots), torch.where(write, positions.to(pc.dtype),
                                             pc[rows, slots]))
    return layer_cache


def _update_rows(layer_cache: dict, k_new: torch.Tensor,
                 v_new: torch.Tensor, pos: torch.Tensor,
                 valid_len: torch.Tensor) -> dict:
    """update_kv_cache of S entries per row at per-row positions (the
    batched verify's commit): row b's entries 0 .. valid_len[b]-1 land at
    positions pos[b] + i, ring index (pos[b] + i) % size, with no host
    sync. As in `_update_traced`, a ring narrower than S takes, per row,
    the `size` entries from clip(valid_len - size, 0, S - size), so one
    row's targets are distinct slots; an entry at or past valid_len
    writes back its slot's old bytes."""
    kc, vc, pc = layer_cache["k"], layer_cache["v"], layer_cache["pos"]
    b, size = kc.shape[:2]
    s = k_new.shape[1]
    dev = kc.device
    idx = torch.arange(min(s, size), device=dev)[None, :].expand(b, -1)
    if s > size:
        idx = idx + torch.clamp(valid_len.long() - size, 0, s - size)[:, None]
        sel = idx[:, :, None, None].expand(-1, -1, *k_new.shape[2:])
        k_new = torch.gather(k_new, 1, sel)
        v_new = torch.gather(v_new, 1, sel)
    positions = pos.long()[:, None] + idx
    slots = positions % size
    rows = torch.arange(b, device=dev)[:, None].expand_as(slots)
    write = idx < valid_len.long()[:, None]
    kc.index_put_((rows, slots), torch.where(write[..., None, None], k_new,
                                             kc[rows, slots]))
    vc.index_put_((rows, slots), torch.where(write[..., None, None], v_new,
                                             vc[rows, slots]))
    pc.index_put_((rows, slots), torch.where(write, positions.to(pc.dtype),
                                             pc[rows, slots]))
    return layer_cache


def truncate_layers(cfg: ModelConfig, layers: list[dict],
                    new_end: int) -> list[dict]:
    """Mark every entry at a position >= new_end empty (pos -1), in place,
    across the batch (the reference's truncate_layers): the draft-model
    drafter's rollback of its own speculative suffix. K/V bytes stay: a
    -1 entry is invisible, and the next write lands over it. A
    linear-attention layer passes through: its state cannot roll back."""
    for lc in layers:
        if "pos" in lc:
            lc["pos"].masked_fill_(lc["pos"] >= new_end, -1)
    return layers


def truncate_cache(cfg: ModelConfig, cache: dict, new_end: int) -> dict:
    """Roll a batch-1 cache back to positions < new_end (its pos clamped
    too): the reference's truncate_cache, in place. On a sliding-window
    ring it cannot bring back the older entries that the dropped suffix
    overwrote, as in the reference: a windowed draft model then proposes
    from a damaged window. That changes only what it proposes, never what
    the accept rule emits. A linear-attention layer raises, as in the
    reference: its state cannot roll back."""
    if any(s.kind == "linear" for s in cfg.layer_specs()):
        raise ValueError("truncate_cache cannot roll back linear-attention "
                         "state")
    truncate_layers(cfg, cache["layers"], new_end)
    cache["pos"] = min(int(cache["pos"]), int(new_end))
    return cache


def grow_cache(cfg: ModelConfig, cache: dict, new_len: int,
               layer_range: tuple[int, int] | None = None) -> dict:
    """A cache of min(new_len, window) slots per layer holding the same
    entries (re-homed at pos % the new size); empty entries are dropped
    (the reference's grow_cache). Linear-attention state passes
    through. layer_range: the layers the cache holds (default all)."""
    lo = layer_range[0] if layer_range else 0
    out = []
    for i, lc in enumerate(cache["layers"]):
        spec = cfg.layer_spec(lo + i)
        if spec.kind == "linear":
            out.append(lc)
            continue
        size = new_len if spec.window is None else min(spec.window, new_len)
        b, old = lc["pos"].shape
        if size <= old:
            out.append(lc)
            continue
        nl = init_layer_cache(cfg, spec, b, size, lc["k"].dtype,
                              lc["k"].device)
        rows, idx = torch.nonzero(lc["pos"] >= 0, as_tuple=True)
        slots = lc["pos"][rows, idx].long() % size
        for name in ("k", "v", "pos"):
            nl[name][rows, slots] = lc[name][rows, idx]
        out.append(nl)
    return {"layers": out, "pos": cache["pos"]}


def kv_capacity(cfg: ModelConfig, cache: dict,
                layer_range: tuple[int, int] | None = None) -> int | None:
    """Smallest full-attention buffer length (positions past it would
    wrap); None when every layer is a ring or linear. layer_range: the
    layers the cache holds (default all)."""
    lo = layer_range[0] if layer_range else 0
    caps = [lc["k"].shape[1] for i, lc in enumerate(cache["layers"])
            if cfg.layer_spec(lo + i).kind == "full"
            and cfg.layer_spec(lo + i).window is None]
    return min(caps) if caps else None


def row_view(layers: list[dict], slot: int) -> list[dict]:
    """Batch-1 views of pool row `slot`: writes through them land in the
    pool."""
    return [{name: buf[slot:slot + 1] for name, buf in lc.items()}
            for lc in layers]


def _clear(name: str, buf: torch.Tensor) -> None:
    buf.fill_(-1) if name == "pos" else buf.zero_()


def slot_reset_layers(layers: list[dict], slot: int) -> list[dict]:
    """Clear pool row `slot` in place (positions -1, K/V and linear state
    zero). Empty dicts (a paged pool's pooled positions in `rows`) are
    skipped."""
    for lc in layers:
        for name, buf in lc.items():
            _clear(name, buf[slot])
    return layers


def reset_layers(layers: list[dict]) -> list[dict]:
    """Clear every row (or every block of a block pool, sink included) in
    place, as freshly built: positions -1, K/V and linear state zero.
    Empty dicts are skipped."""
    for lc in layers:
        for name, buf in lc.items():
            _clear(name, buf)
    return layers


# -- prefix blocks: copy out of a row and back --------------------------------


def slot_extract_block_layers(cfg: ModelConfig, layers: list[dict], slot: int,
                              start: int, width: int) -> list[dict]:
    """Copy one prefix block (absolute positions start .. start+width-1) out
    of pool row `slot` into batch-1 tensors: the shared-prefix cache's
    insert path. Entries are read through the ring map (index = position %
    buffer), valid while width <= the smallest window, which the prefix
    cache gates at construction. A linear-attention layer's block is a
    copy of the row's state: exact only at the block's end, where the
    engine takes it."""
    out = []
    for lc in layers:
        if "conv" in lc:
            out.append({name: buf[slot:slot + 1].clone()
                        for name, buf in lc.items()})
            continue
        size = lc["k"].shape[1]
        idx = (start + torch.arange(width, device=lc["k"].device)) % size
        out.append({name: lc[name][slot, idx][None] for name in
                    ("k", "v", "pos")})
    return out


def slot_splice_block_layers(cfg: ModelConfig, layers: list[dict],
                             src_layers: list[dict], slot: int,
                             start: int, final: bool = True) -> list[dict]:
    """Write a cached prefix block (slot_extract_block_layers output, taken
    at `start`) into pool row `slot` in place, without resetting the rest
    of the row, so consecutive blocks of a matched chain merge. Entries
    land where extract read them, at (start + i) % buffer. The row must
    have been wiped at release; an entry the block holds as empty (pos -1)
    stays empty there, which is what the reference's dropped write leaves
    visible on a wiped row. Unlike the reference, the caller passes the
    block's start, so no index depends on device data (no host sync).
    A linear-attention layer's state is a block-end snapshot: only the
    chain's `final` block installs it."""
    for lc, sl in zip(layers, src_layers):
        if "conv" in lc:
            if final:
                for name, buf in lc.items():
                    buf[slot].copy_(sl[name][0])
            continue
        size = lc["k"].shape[1]
        width = sl["pos"].shape[1]
        idx = (start + torch.arange(width, device=lc["k"].device)) % size
        for name in ("k", "v", "pos"):
            lc[name][slot, idx] = sl[name][0]
    return layers


# -- paged KV: block-pool storage behind a per-slot block table --------------
#
# As in the reference (cache.py:328-440): full-attention KV lives in one
# pool of fixed-size blocks per layer, and a slot addresses its logical row
# through a [max_blocks] table whose entry j maps positions [j*bt,
# (j+1)*bt) to a physical block. Sliding-window rings stay per-slot rows.
#
# Where the port differs: the pool has ONE EXTRA block, the sink, at index
# num_blocks, which is also the NULL table id. It is never mapped and its
# contents are never visible: writes of masked rows land there (in place of
# JAX's `mode="drop"`), and gathers of unmapped entries read it and mask
# it. Writes need no host sync that way.


def init_paged_layers(cfg: ModelConfig, num_blocks: int, block_tokens: int,
                      batch: int, ctx: int, dtype: torch.dtype = torch.bfloat16,
                      device="cpu") -> tuple[list[dict], list[dict]]:
    """(pool_layers, row_layers): pool_layers[i] holds full-attention layer
    i's block pool ({k, v: [num_blocks + 1, bt, Hkv, D], pos: [num_blocks +
    1, bt]}, the last block the sink) and an empty dict elsewhere;
    row_layers[i] holds a sliding-window layer's per-slot ring or a
    linear-attention layer's per-slot state, and an empty dict at pooled
    positions."""
    pool, rows = [], []
    shape = (num_blocks + 1, block_tokens, cfg.num_key_value_heads,
             cfg.head_dim)
    for i in range(cfg.num_hidden_layers):
        spec = cfg.layer_spec(i)
        if spec.kind == "linear" or spec.window is not None:
            pool.append({})
            rows.append(init_layer_cache(cfg, spec, batch, ctx, dtype,
                                         device))
            continue
        pool.append({
            "k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": torch.full(shape[:2], -1, dtype=torch.int32,
                              device=device),
        })
        rows.append({})
    return pool, rows


def paged_gather_layer(pl: dict, table, frontier) -> dict:
    """Materialize logical KV rows from a layer's block pool through block
    tables. `table`: [M] (one row) or [B, M] physical ids, NULL (the sink)
    = unmapped; `frontier`: a scalar, or [B] for a [B, M] table. Returns
    {k, v: [..., M*bt, Hkv, D], pos: [..., M*bt]}, batch axis only when the
    table has one.

    Both of the reference's stale-tenant guards hold: an entry is real iff
    its table entry is mapped, its position lies in that entry's own
    logical range (pos // bt == j) and pos < frontier. Masked entries get
    pos -1; their K/V bytes are finite and never weigh in."""
    null, bt = pl["pos"].shape
    null -= 1                                   # the sink's id
    table = table.long()
    m = table.shape[-1]
    lead = table.shape[:-1]
    k = pl["k"][table].reshape(*lead, m * bt, *pl["k"].shape[2:])
    v = pl["v"][table].reshape(*lead, m * bt, *pl["v"].shape[2:])
    pos = pl["pos"][table]                              # [..., M, bt]
    blk = torch.arange(m, device=pos.device)[:, None]
    front = (frontier if isinstance(frontier, int)
             else torch.as_tensor(frontier, device=pos.device)[..., None, None])
    own = (table < null)[..., None] & (torch.div(pos, bt, rounding_mode="floor")
                                       == blk) & (pos < front)
    pos = torch.where(own, pos, -1).reshape(*lead, m * bt)
    return {"k": k, "v": v, "pos": pos}


def paged_block_of(view_lc: dict, wb: int, bt: int) -> dict:
    """Block `wb` of a gathered row view ({k, v: [bt, H, D], pos: [bt]}):
    the write-back unit after a forward advanced the view."""
    return {name: view_lc[name][wb * bt:(wb + 1) * bt]
            for name in ("k", "v", "pos")}


def paged_scatter_blocks(pl: dict, pids: torch.Tensor, blk: dict) -> dict:
    """Write block contents back into a layer's pool at physical ids `pids`
    ([n], leaves [n, bt, ...]), in place. NULL ids land on the sink (the
    reference drops them); live ids are owned by their writer alone
    (shared blocks are forked before any write), so the scatter is
    injective over everything visible."""
    idx = pids.long()
    for name in ("k", "v", "pos"):
        pl[name][idx] = blk[name]
    return pl


def paged_write_entry(pl: dict, tables: torch.Tensor, k_new: torch.Tensor,
                      v_new: torch.Tensor, pos: torch.Tensor,
                      write: torch.Tensor) -> dict:
    """The batched decode step's write: row b's new entry (k_new/v_new
    [B, 1, Hkv, D]) at position pos[b] goes to block tables[b, pos[b] //
    bt], index pos[b] % bt, in place; rows with write[b] False go to the
    sink. The reference writes back the whole block from its masked view
    (stale entries past pos become -1 there); the visible contents are the
    same, since an index of a block only ever holds positions congruent to
    it mod bt, and every live one at or below the frontier was written."""
    null, bt = pl["pos"].shape
    null -= 1
    m = tables.shape[1]
    pos = pos.long()
    j = torch.clamp(torch.div(pos, bt, rounding_mode="floor"), 0, m - 1)
    pid = torch.gather(tables.long(), 1, j[:, None])[:, 0]
    pid = torch.where(write.bool(), pid, null)
    off = pos % bt
    pl["k"][pid, off] = k_new[:, 0]
    pl["v"][pid, off] = v_new[:, 0]
    pl["pos"][pid, off] = pos.to(pl["pos"].dtype)
    return pl


def paged_write_entries(pl: dict, tables: torch.Tensor, k_new: torch.Tensor,
                        v_new: torch.Tensor, pos: torch.Tensor,
                        valid_len: torch.Tensor) -> dict:
    """The batched verify's write into a layer's block pool: row b's
    entries i < valid_len[b] (k_new/v_new [B, S, Hkv, D]) at positions
    pos[b] + i go to block tables[b, (pos[b] + i) // bt], index (pos[b] +
    i) % bt, in place; the others (padding, inactive rows) go to the sink.
    The engine has reserved the blocks of [pos, pos + valid_len)."""
    null, bt = pl["pos"].shape
    null -= 1
    b, s = k_new.shape[:2]
    m = tables.shape[1]
    positions = pos.long()[:, None] + torch.arange(s, device=pos.device)
    j = torch.clamp(torch.div(positions, bt, rounding_mode="floor"), 0,
                    m - 1)
    pid = torch.gather(tables.long(), 1, j)
    write = torch.arange(s, device=pos.device)[None, :] \
        < valid_len.long()[:, None]
    pid = torch.where(write, pid, null)
    off = positions % bt
    pl["k"][pid, off] = k_new
    pl["v"][pid, off] = v_new
    pl["pos"][pid, off] = positions.to(pl["pos"].dtype)
    return pl


def paged_drop_entries(pl: dict, tables: torch.Tensor, pos: torch.Tensor,
                       lo: torch.Tensor, hi: torch.Tensor, width: int) -> dict:
    """Mark row b's entries at positions pos[b] + i, lo[b] <= i < hi[b]
    (i < width), empty (pos -1) in the block pool, in place: the verify's
    rollback of the drafts it wrote and rejected, so that every pool
    entry at or past the commit frontier reads -1 after the step (a
    swapped-out slot carries no uncommitted entry). The others go to the
    sink."""
    null, bt = pl["pos"].shape
    null -= 1
    m = tables.shape[1]
    i = torch.arange(width, device=pos.device)[None, :]
    positions = pos.long()[:, None] + i
    j = torch.clamp(torch.div(positions, bt, rounding_mode="floor"), 0,
                    m - 1)
    drop = (i >= lo.long()[:, None]) & (i < hi.long()[:, None])
    pid = torch.where(drop, torch.gather(tables.long(), 1, j), null)
    pl["pos"].index_put_((pid, positions % bt),
                         torch.full_like(pid, -1, dtype=pl["pos"].dtype))
    return pl
