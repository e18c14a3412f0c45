"""The host side of speculative decoding (counterpart of
cake_tpu/spec/verify.py: record_step, spec_stats_dict, spec_decode_loop).

The device side lives elsewhere: ops/sampling.py: spec_accept (the
accept rule, batched over rows) and TextModel's verify programs
(verify_tokens for one sequence; spec_slots / spec_slots_paged and their
in-place `_into` forms for the serve engine's batched verify, which
graphs.DecodeGraph captures). This module keeps what must stay on the
host: asking the drafter, growing the KV bucket, cutting the output at
EOS or the budget, and the spec instruments both paths share.
"""
from __future__ import annotations

from ..obs import (RECORDER, SPEC_ACCEPTED, SPEC_ACCEPTED_LEN,
                   SPEC_BUCKET_ACCEPTED, SPEC_PROPOSED)

__all__ = ["record_step", "spec_decode_loop", "spec_stats_dict"]


def record_step(n_proposed: int, n_acc: int, bucket: int | None = None) -> None:
    """Feed the spec instruments from one completed verify step of one
    sequence (generate's loop and the serve engine both call this).
    `bucket`: the batched dispatch's slot count (engine path only)."""
    SPEC_PROPOSED.inc(n_proposed)
    SPEC_ACCEPTED.inc(n_acc)
    SPEC_ACCEPTED_LEN.observe(n_acc)
    if bucket is not None:
        SPEC_BUCKET_ACCEPTED.observe(n_acc, bucket=str(bucket))


def spec_stats_dict(steps: int, proposed: int, accepted: int) -> dict:
    """One generation's speculative stats."""
    return {
        "spec_steps": steps,
        "spec_proposed": proposed,
        "spec_accepted": accepted,
        "spec_accept_rate": round(accepted / proposed, 4) if proposed else 0.0,
        # tokens emitted per verify step (1.0 == plain decode: every step
        # emits its correction or bonus token besides the accepted ones)
        "spec_tokens_per_step": round((accepted + steps) / steps, 4)
        if steps else 0.0,
    }


def spec_decode_loop(model, drafter, k: int, prompt_ids: list[int],
                     out: list[int], cache: dict, kv_len: int, key: int,
                     recent, scfg, max_new_tokens: int, done: bool):
    """generate's decode loop under speculation. `out` holds the first
    token (sampled off the prefill with draw 0 of `key`); `done` is True
    when it was EOS. Each step: the drafter proposes up to k tokens from
    the host sequence, one verify call (an eager batch-1 program) checks
    them and commits the accepted prefix, and the host emits n_acc + 1
    tokens, stopping at EOS or the budget exactly where one-at-a-time
    decoding stops. Step j draws its noise from counter j + 1 of `key`.
    Returns (out, spec stats)."""
    cfg = model.cfg
    drafter.reset()
    pos = len(prompt_ids)               # next KV write position
    n_total = min(max_new_tokens - 1, model.max_cache_len - pos - 1)
    emitted = 0
    steps = proposed = accepted = 0
    counter = 1
    while not done and emitted < n_total:
        # room for the widest verify (k drafts and the input token)
        if pos + k + 1 > kv_len and kv_len < model.max_cache_len:
            from ..models.common.text_model import bucket_for
            kv_len = bucket_for(pos + k + 1, model.max_cache_len)
            cache = model.grow_cache(cache, kv_len)
        # never draft past the cache or the budget (a step emits at most
        # n_draft + 1 tokens; the correction token always fits)
        n_draft = min(k, kv_len - pos - 1, max(n_total - emitted - 1, 0))
        draft = list(drafter.propose(prompt_ids + out, n_draft))[:n_draft] \
            if n_draft > 0 else []
        with RECORDER.span("spec.verify", cat="gen", drafts=len(draft),
                           pos=pos):
            packed, cache, recent = model.verify_tokens(
                cache, out[-1], draft, k, pos, key, counter, recent, scfg)
            n_acc, nxt = (int(t) for t in packed.tolist())
        counter += 1
        steps += 1
        proposed += len(draft)
        accepted += n_acc
        record_step(len(draft), n_acc)
        for t in draft[:n_acc] + [nxt]:
            out.append(t)
            emitted += 1
            if cfg.is_eos(t) or emitted >= n_total:
                done = True
                break
        pos += n_acc + 1
    return out, spec_stats_dict(steps, proposed, accepted)
