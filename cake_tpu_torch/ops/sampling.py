"""Token sampling on the device (counterpart of cake_tpu/ops/sampling.py:
SamplingConfig, sample_traced, push_recent_token).

`sample_traced` takes every parameter as a per-row tensor, so one batched
call serves any mix of per-request settings in the engine's decode step.

Gumbel noise is a pure function of each row's (key, counter) and the
column: `keyed_uniform` hashes them with integer ops only (murmur3's
32-bit finalizer, computed in int64 masked to 32 bits, products split
into 16-bit halves so that nothing overflows), so the same key gives
the same bits on the CPU and on the card, a row's draw never depends on
the other rows, and a captured CUDA graph can draw fresh noise on every
replay (the counter is a device tensor it advances). `request_key` is
the reference's `fold_in(base, seq)`: one key per admission. The bits
cannot match JAX's threefry, so sampled streams agree with the reference
in distribution only; greedy (temperature <= 0) and top_k = 1 are exact.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    temperature: float = 0.0
    top_k: int | None = None
    top_p: float | None = None
    repeat_penalty: float = 1.0
    repeat_last_n: int = 64


MASK32 = 0xFFFFFFFF
GOLDEN = 0x9E3779B9       # counter stride (2^32 / golden ratio)
COLUMN_MUL = 0x27D4EB2F   # column spread
ROW_SALT = 0x632BE5AB     # second-round row salt
FMIX_C1 = 0x85EBCA6B      # murmur3 fmix32 constants
FMIX_C2 = 0xC2B2AE35


def _mul32(x, c: int):
    """(x * c) mod 2^32 for x in [0, 2^32) (a tensor or an int): the
    product is taken in 16-bit halves so that no int64 step overflows."""
    lo, hi = x & 0xFFFF, x >> 16
    return (lo * c + ((hi * (c & 0xFFFF)) << 16)) & MASK32


def _fmix32(h):
    """murmur3's 32-bit finalizer: a bijection of [0, 2^32) with full
    avalanche."""
    h = h ^ (h >> 16)
    h = _mul32(h, FMIX_C1)
    h = h ^ (h >> 13)
    h = _mul32(h, FMIX_C2)
    return h ^ (h >> 16)


def request_key(seed: int, seq: int) -> int:
    """The sampling key of admission `seq` under engine seed `seed`, in
    [0, 2^32): distinct for distinct seqs of one seed."""
    s = _fmix32((seed ^ (seed >> 32)) & MASK32)
    return _fmix32(s ^ _mul32(seq & MASK32, GOLDEN))


def keyed_uniform(keys: torch.Tensor, counters: torch.Tensor,
                  width: int) -> torch.Tensor:
    """[B, width] float32 uniforms in [0, 1), a pure function of (keys[b],
    counters[b], column): two hash rounds over the row's seed and the
    column, then the top 24 bits scaled by 2^-24. keys/counters: [B]
    integer tensors (keys in [0, 2^32))."""
    row = _fmix32((keys.long() & MASK32)
                  ^ _mul32(counters.long() & MASK32, GOLDEN))
    salt = _fmix32(row ^ ROW_SALT)
    col = _mul32(torch.arange(width, device=keys.device, dtype=torch.long),
                 COLUMN_MUL)
    x = _fmix32(_fmix32(row[:, None] ^ col[None, :]) ^ salt[:, None])
    return (x >> 8).to(torch.float32) * (2.0 ** -24)


def apply_repeat_penalty(logits: torch.Tensor, recent_tokens: torch.Tensor,
                         penalty: torch.Tensor) -> torch.Tensor:
    """Sign-aware penalty on the tokens in each row's recent window:
    logit >= 0 -> logit / penalty, logit < 0 -> logit * penalty.
    logits: [B, V] float32; recent_tokens: [B, N] (-1 = empty);
    penalty: [B]."""
    v = logits.shape[-1]
    idx = torch.where(recent_tokens < 0, v, recent_tokens).long()
    flagged = torch.zeros((logits.shape[0], v + 1), dtype=torch.bool,
                          device=logits.device)
    flagged.scatter_(1, idx, True)
    flagged = flagged[:, :v]
    pen = penalty[:, None]
    penalized = torch.where(logits >= 0, logits / pen, logits * pen)
    return torch.where(flagged, penalized, logits)


def sample_traced(logits: torch.Tensor, keys: torch.Tensor,
                  counters: torch.Tensor, temperature: torch.Tensor, top_k: torch.Tensor,
                  top_p: torch.Tensor, repeat_penalty: torch.Tensor,
                  recent_tokens: torch.Tensor) -> torch.Tensor:
    """One token per row. logits: [B, V]; temperature/top_p/
    repeat_penalty: [B] float; top_k: [B] integer (>= V disables);
    recent_tokens: [B, N]; keys/counters: [B], each row's noise
    (keyed_uniform). temperature <= 0 gives the argmax of the penalized
    logits with ties to the lowest id; otherwise top-k, then top-p
    measured on the renormalized top-k distribution, then a Gumbel draw
    over the sorted ranks. Returns [B] int32."""
    v = logits.shape[-1]
    lf = apply_repeat_penalty(logits.float(), recent_tokens, repeat_penalty)
    scaled = lf / torch.clamp(temperature, min=1e-6)[:, None]
    # one stable descending sort serves argmax (rank 0), the top-k rank
    # mask and the top-p cumulative-mass mask; ties keep the lower id first
    sorted_logits, order = torch.sort(scaled, dim=-1, descending=True,
                                      stable=True)
    rank = torch.arange(v, device=logits.device)[None, :]
    in_k = rank < top_k[:, None]
    neg = torch.full((), float("-inf"), device=logits.device)
    probs = torch.softmax(torch.where(in_k, sorted_logits, neg), dim=-1)
    prev_mass = torch.cumsum(probs, dim=-1) - probs
    keep = in_k & (prev_mass < top_p[:, None])
    keep[:, 0] = True                        # never mask every token
    u = keyed_uniform(keys, counters, v)
    gumbel = -torch.log((-torch.log(u.clamp_min(1e-20))).clamp_min(1e-20))
    z = torch.where(keep, sorted_logits, neg) + gumbel
    choice = torch.gather(order, 1, torch.argmax(z, dim=-1, keepdim=True))[:, 0]
    return torch.where(temperature > 0, choice, order[:, 0]).to(torch.int32)


def push_recent_token(recent_tokens: torch.Tensor,
                      token: torch.Tensor) -> torch.Tensor:
    """Shift one token per row into the recent-token window: [B, N] and
    [B] -> [B, N] (an unbatched [N] and scalar work too)."""
    token = token.to(recent_tokens.dtype)
    return torch.cat([recent_tokens[..., 1:], token[..., None]], dim=-1)
