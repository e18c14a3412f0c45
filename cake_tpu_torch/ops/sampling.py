"""Token sampling on the device (counterpart of cake_tpu/ops/sampling.py:
SamplingConfig, sample_traced, push_recent_token, config_has_filters,
and the speculative pieces filtered_probs and spec_accept).

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


def sample_one(logits: torch.Tensor, key: int, counter: int,
               scfg: SamplingConfig, recent: torch.Tensor,
               vocab_size: int) -> torch.Tensor:
    """One token off logits [1, V] under the request's settings, draw
    `counter` of key `key`; recent: [1, N]. Returns [1] int32."""
    dev = logits.device

    def one(v, dtype):
        return torch.tensor([v], dtype=dtype, device=dev)
    return sample_traced(
        logits, one(key, torch.int64), one(counter, torch.int64),
        one(scfg.temperature, torch.float32),
        one(scfg.top_k or vocab_size, torch.int32),
        one(1.0 if scfg.top_p is None else scfg.top_p, torch.float32),
        one(scfg.repeat_penalty, torch.float32), recent)


def push_recent_token(recent_tokens: torch.Tensor,
                      token: torch.Tensor) -> torch.Tensor:
    """Shift one token per row into the recent-token window: [B, N] and
    [B] -> [B, N] (an unbatched [N] and scalar work too)."""
    token = token.to(recent_tokens.dtype)
    return torch.cat([recent_tokens[..., 1:], token[..., None]], dim=-1)


def config_has_filters(scfg: SamplingConfig) -> bool:
    """True when `scfg` filters the vocabulary (top-k, or top-p below 1):
    the host's choice of the verify program's `filt` form. Greedy and
    plain-temperature settings need no sort."""
    return scfg.top_k is not None or (
        scfg.top_p is not None and scfg.top_p < 1.0)


# -- speculative decoding: the target distribution and the accept rule ------


def filtered_probs(logits: torch.Tensor, temperature: torch.Tensor,
                   top_k: torch.Tensor, top_p: torch.Tensor,
                   repeat_penalty: torch.Tensor, recent_tokens: torch.Tensor,
                   use_filters: bool = True) -> torch.Tensor:
    """The distribution sample_traced draws from, as [R, V] float32
    probabilities in vocabulary order (the reference's filtered_probs,
    batched over rows). logits: [R, V]; temperature/top_p/repeat_penalty:
    [R] float; top_k: [R] integer; recent_tokens: [R, N]. The same
    pipeline as sample_traced: sign-aware penalty, temperature, one stable
    descending sort for the top-k rank mask and the top-p mass mask
    (measured on the renormalized top-k distribution). temperature <= 0
    gives (almost) a point mass at the penalized argmax. use_filters=False
    (no row filters) skips the sort: the masks are then the identity."""
    lf = apply_repeat_penalty(logits.float(), recent_tokens, repeat_penalty)
    scaled = lf / torch.clamp(temperature, min=1e-6)[:, None]
    if not use_filters:
        return torch.softmax(scaled, dim=-1)
    v = logits.shape[-1]
    sorted_logits, order = torch.sort(scaled, dim=-1, descending=True,
                                      stable=True)
    rank = torch.arange(v, device=logits.device)[None, :]
    in_k = rank < top_k[:, None]
    neg = torch.full((), float("-inf"), device=logits.device)
    probs = torch.softmax(torch.where(in_k, sorted_logits, neg), dim=-1)
    prev_mass = torch.cumsum(probs, dim=-1) - probs
    keep = in_k & (prev_mass < top_p[:, None])
    keep[:, 0] = True                        # never mask every token
    kept = torch.where(keep, probs, torch.zeros((), device=logits.device))
    kept = kept / torch.clamp(kept.sum(-1, keepdim=True), min=1e-30)
    return torch.zeros_like(kept).scatter_(1, order, kept)


def spec_accept(logits: torch.Tensor, drafts: torch.Tensor,
                n_drafts: torch.Tensor, keys: torch.Tensor,
                counters: torch.Tensor, temperature: torch.Tensor,
                top_k: torch.Tensor, top_p: torch.Tensor,
                repeat_penalty: torch.Tensor, recent_tokens: torch.Tensor,
                use_filters: bool = True):
    """The speculative accept rule for a deterministic drafter (point-mass
    q; Leviathan et al. 2023, Chen et al. 2023), batched over B rows (the
    reference's spec_accept, one row each).

    logits: [B, K+1, V], row i the target distribution of the token after
    input i; drafts: [B, K] (entries at or past n_drafts[b] are padding);
    n_drafts: [B]; keys/counters: [B], each row's noise; the sampling
    settings per row as in sample_traced; recent_tokens: [B, N].

    Greedy rows (temperature <= 0) accept draft i iff it equals the
    penalized argmax: the emitted sequence equals plain greedy decoding.
    Sampled rows accept draft i with probability p_i(draft i) and, on a
    rejection, draw the correction from p with the rejected token's mass
    removed; with every draft accepted the bonus token is drawn from p.
    Each emitted token's marginal is p. Row i's distribution assumes
    drafts 0..i-1 are in its penalty window (acceptance is a prefix), so
    every row is computed at once.

    Noise: keyed_uniform(keys, counters, V + K), a pure function of
    (key, counter, column). Columns 0 .. V-1 are the Gumbel noise of the
    row's final draw; column V + i is draft i's acceptance test. The bonus
    draw (every draft accepted, none proposed included) is sample_traced
    itself under the same (key, counter), so a row with no drafts draws
    exactly what a decode step would, and the correction after a
    rejection is a Gumbel draw over the residual in vocabulary order.
    The caller advances an active row's counter by ONE per verify step,
    whatever it accepted, as decode_slots does per decode step: a sampled
    stream under speculation then depends neither on its company (which
    decides whether an iteration is a verify or a decode step) nor on a
    swap.

    Returns (n_acc [B] in [0, n_drafts], next token [B] int32, recent'
    [B, N]: the accepted drafts and the next token pushed)."""
    b, k1, v = logits.shape
    k = k1 - 1
    n = recent_tokens.shape[1]
    dev = logits.device
    rows = torch.arange(b, device=dev)
    # row i's penalty window: [recent ; drafts][i : i + n]
    big = torch.cat([recent_tokens, drafts.to(recent_tokens.dtype)], 1)
    span = (torch.arange(k1, device=dev)[:, None]
            + torch.arange(n, device=dev)[None, :])
    win = big[:, span]                                   # [B, K+1, N]

    def per_row(x):
        return x[:, None].expand(b, k1).reshape(-1)

    probs = filtered_probs(
        logits.reshape(b * k1, v), per_row(temperature), per_row(top_k),
        per_row(top_p), per_row(repeat_penalty), win.reshape(b * k1, n),
        use_filters).reshape(b, k1, v)
    greedy = temperature <= 0
    u = keyed_uniform(keys, counters, v + k)
    idx = torch.arange(k, device=dev)
    dl = drafts.long()
    p_draft = torch.gather(probs[:, :k], 2, dl[:, :, None])[:, :, 0]
    ok = torch.where(greedy[:, None], dl == probs[:, :k].argmax(-1),
                     u[:, v:] < p_draft)
    ok = ok & (idx[None, :] < n_drafts[:, None])
    n_acc = torch.cumprod(ok.to(torch.int32), 1).sum(1)
    p = probs[rows, n_acc]                               # [B, V]
    recent = win[rows, n_acc]
    rejected = n_acc < n_drafts
    d_rej = dl[rows, torch.clamp(n_acc, max=k - 1)] if k else \
        torch.zeros(b, dtype=torch.long, device=dev)
    drop = torch.zeros_like(p).scatter_(1, d_rej[:, None],
                                        rejected[:, None].to(p.dtype))
    resid = p * (1 - drop)
    resid = resid / torch.clamp(resid.sum(-1, keepdim=True), min=1e-30)
    gumbel = -torch.log((-torch.log(u[:, :v].clamp_min(1e-20)))
                        .clamp_min(1e-20))
    neg = torch.full((), float("-inf"), device=dev)
    z = torch.where(resid > 0, torch.log(resid.clamp_min(1e-38)), neg) \
        + gumbel
    bonus = sample_traced(logits[rows, n_acc], keys, counters, temperature,
                          top_k, top_p, repeat_penalty, recent)
    nxt = torch.where(greedy, p.argmax(-1),
                      torch.where(rejected, z.argmax(-1), bonus))
    nxt = nxt.to(torch.int32)
    return n_acc.to(torch.int32), nxt, push_recent_token(recent, nxt)
