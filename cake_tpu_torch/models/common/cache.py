"""Fixed-shape KV cache (counterpart of cake_tpu/models/common/cache.py).

Same layout as the reference: per layer {"k", "v": [B, size, Hkv, D],
"pos": [B, size] int32 (-1 = empty)}; full-attention layers hold position
p at index p, sliding-window layers are rings (index p % size).

Unlike the reference, whose arrays are immutable, the port updates the
buffers IN PLACE: `update_kv_cache` writes into the layer's tensors and
returns the same dict, and a slot-pool row is a view of the pool, so a
prefill chunk into a row needs no gather or scatter-back copy.
"""
from __future__ import annotations

import torch

from .config import ModelConfig


def init_layer_cache(cfg: ModelConfig, spec, batch: int, max_seq_len: int,
                     dtype: torch.dtype, device) -> dict:
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
               dtype: torch.dtype = torch.bfloat16, device="cpu") -> dict:
    return {
        "layers": [init_layer_cache(cfg, cfg.layer_spec(i), batch,
                                    max_seq_len, dtype, device)
                   for i in range(cfg.num_hidden_layers)],
        "pos": 0,
    }


def update_kv_cache(layer_cache: dict, k_new: torch.Tensor,
                    v_new: torch.Tensor, pos, valid_len=None) -> dict:
    """Write S new entries at absolute positions pos .. pos+S-1 (ring
    index = position % size), in place.

    Prefill: `pos` and `valid_len` are host ints; entries at index >=
    valid_len are padding and are not written; when S exceeds a ring's
    size only the last `size` valid entries land.
    Batched decode: S == 1, `pos` is a [B] tensor of per-row positions and
    `valid_len` a [B] tensor of 0/1 — a row with 0 keeps its old entry
    (it is not stepping), with no host synchronisation."""
    kc, vc, pc = layer_cache["k"], layer_cache["v"], layer_cache["pos"]
    size = kc.shape[1]
    if torch.is_tensor(pos):
        if k_new.shape[1] != 1:
            raise ValueError("per-row positions take one new entry per row")
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


def kv_capacity(cfg: ModelConfig, cache: dict) -> int | None:
    """Smallest full-attention buffer length (positions past it would
    wrap); None when every layer is a ring."""
    caps = [lc["k"].shape[1] for i, lc in enumerate(cache["layers"])
            if cfg.layer_spec(i).window is None]
    return min(caps) if caps else None


def row_view(layers: list[dict], slot: int) -> list[dict]:
    """Batch-1 views of pool row `slot`: writes through them land in the
    pool."""
    return [{name: buf[slot:slot + 1] for name, buf in lc.items()}
            for lc in layers]


def slot_reset_layers(layers: list[dict], slot: int) -> list[dict]:
    """Clear pool row `slot` in place (positions -1, K/V zero)."""
    for lc in layers:
        lc["k"][slot].zero_()
        lc["v"][slot].zero_()
        lc["pos"][slot].fill_(-1)
    return layers
