"""Token sampling on the device (counterpart of cake_tpu/ops/sampling.py:
SamplingConfig, sample_traced, push_recent_token).

`sample_traced` takes every parameter as a per-row tensor, so one batched
call serves any mix of per-request settings in the engine's decode step.
Gumbel noise comes from an explicit `torch.Generator`: it cannot match
JAX's threefry bits, so sampled streams agree with the reference in
distribution only; greedy (temperature <= 0) is exact.
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


def sample_traced(logits: torch.Tensor, generator: torch.Generator | None,
                  temperature: torch.Tensor, top_k: torch.Tensor,
                  top_p: torch.Tensor, repeat_penalty: torch.Tensor,
                  recent_tokens: torch.Tensor) -> torch.Tensor:
    """One token per row. logits: [B, V]; temperature/top_p/
    repeat_penalty: [B] float; top_k: [B] integer (>= V disables);
    recent_tokens: [B, N]. temperature <= 0 gives the argmax of the
    penalized logits with ties to the lowest id; otherwise top-k, then
    top-p measured on the renormalized top-k distribution, then a Gumbel
    draw. Returns [B] int32."""
    b, v = logits.shape
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
    u = torch.rand((b, v), generator=generator, device=logits.device,
                   dtype=torch.float32)
    gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)).clamp_min(1e-20))
    z = torch.where(keep, sorted_logits, neg) + gumbel
    choice = torch.gather(order, 1, torch.argmax(z, dim=-1, keepdim=True))[:, 0]
    return torch.where(temperature > 0, choice, order[:, 0]).to(torch.int32)


def push_recent_token(recent_tokens: torch.Tensor,
                      token: torch.Tensor) -> torch.Tensor:
    """Shift one token per row into the recent-token window: [B, N] and
    [B] -> [B, N] (an unbatched [N] and scalar work too)."""
    token = token.to(recent_tokens.dtype)
    return torch.cat([recent_tokens[..., 1:], token[..., None]], dim=-1)
