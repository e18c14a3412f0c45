"""Drafters: proposal sources for speculative decoding (counterpart of
cake_tpu/spec/drafter.py: Drafter, NGramDrafter, DraftModelDrafter,
resolve_drafter).

A drafter looks at the committed sequence (prompt + generated ids, on the
host) and proposes up to k continuation tokens for one verify step to
check. A proposal may be wrong: the accept rule (ops/sampling.py:
spec_accept) keeps the target model's output either way, so a drafter
only has to be cheap and right often enough.

  * NGramDrafter: prompt lookup. Match the last few tokens against the
    earlier sequence and propose what followed last time. No weights, no
    device work; strong where the output restates its input.
  * DraftModelDrafter: a smaller TextModel with the same tokenizer rolls
    out k greedy tokens against its own small KV cache, and rolls its
    speculative suffix back between calls (cache.truncate_cache).

Both are deterministic (a point-mass q), which is what the accept rule
assumes. The knobs are the reference's, read from the environment with
its defaults and clamps: CAKE_SPEC (unset = off, "ngram"), CAKE_SPEC_K
(6, clamped to [1, 32]), CAKE_SPEC_NGRAM (3, at least 2) and
CAKE_SPEC_RESERVE (0 = the whole draft window).
"""
from __future__ import annotations

import os
from typing import Protocol, Sequence, runtime_checkable

import numpy as np

DEFAULT_SPEC_K = 6
MAX_SPEC_K = 32
DEFAULT_SPEC_NGRAM = 3
DEFAULT_SPEC_RESERVE = 0

__all__ = ["DEFAULT_SPEC_K", "MAX_SPEC_K", "Drafter", "DraftModelDrafter",
           "NGramDrafter", "resolve_drafter", "spec_knobs"]


def spec_knobs(env=None) -> dict:
    """{spec, spec_k, spec_ngram, spec_reserve} from CAKE_SPEC,
    CAKE_SPEC_K, CAKE_SPEC_NGRAM and CAKE_SPEC_RESERVE, unset or empty
    ones at the reference's defaults (spec None: off)."""
    env = os.environ if env is None else env
    return {"spec": env.get("CAKE_SPEC") or None,
            "spec_k": int(env.get("CAKE_SPEC_K") or DEFAULT_SPEC_K),
            "spec_ngram": int(env.get("CAKE_SPEC_NGRAM")
                              or DEFAULT_SPEC_NGRAM),
            "spec_reserve": max(int(env.get("CAKE_SPEC_RESERVE")
                                    or DEFAULT_SPEC_RESERVE), 0)}


@runtime_checkable
class Drafter(Protocol):
    """Proposal source. `shareable` marks a drafter safe to call from
    every slot of the serve engine (a stateless propose)."""

    name: str
    shareable: bool

    def propose(self, ids: Sequence[int], k: int) -> list[int]:
        """Up to k proposed continuation tokens for `ids` (prompt +
        generated so far); [] abstains, and the verify step is then a
        plain decode step."""
        ...

    def reset(self) -> None:
        """Drop any per-sequence state before a new generation."""
        ...


class NGramDrafter:
    """Prompt lookup: the last m tokens (m from max_ngram down to
    min_ngram) matched against the earlier sequence; on a hit, the k
    tokens that followed the most recent earlier occurrence with a full
    k-token continuation (else the longest continuation on offer).
    Abstains when nothing repeats. min_ngram >= 2 by default, so that
    single-token coincidences propose nothing."""

    name = "ngram"
    shareable = True

    def __init__(self, max_ngram: int = 3, min_ngram: int = 2):
        if not 1 <= min_ngram <= max_ngram:
            raise ValueError(f"need 1 <= min_ngram <= max_ngram, got "
                             f"{min_ngram}..{max_ngram}")
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram

    def propose(self, ids: Sequence[int], k: int) -> list[int]:
        arr = np.asarray(list(ids), dtype=np.int64)
        n = int(arr.shape[0])
        if k <= 0 or n < self.min_ngram + 1:
            return []
        for m in range(min(self.max_ngram, n - 1), self.min_ngram - 1, -1):
            suffix = arr[n - m:]
            # candidate starts 0..n-m-1: the suffix itself is excluded,
            # and every candidate has at least one continuation token
            windows = np.lib.stride_tricks.sliding_window_view(
                arr, m)[:n - m]
            hits = np.nonzero((windows == suffix).all(axis=1))[0]
            if hits.size == 0:
                continue
            full = hits[hits + m + k <= n]
            j = int(full[-1]) if full.size else int(hits[0])
            cont = arr[j + m:j + m + k]
            if cont.size:
                return [int(t) for t in cont]
        return []

    def reset(self) -> None:
        pass


class DraftModelDrafter:
    """Greedy rollout from a smaller TextModel that shares the target's
    tokenizer (Leviathan et al. / Chen et al. 2023). Its batch-1 cache
    holds exactly the confirmed prefix between calls: propose() forwards
    the unseen suffix (one prefill), decodes k greedy tokens, then rolls
    its own speculative suffix back (truncate_cache). Per-sequence state:
    not shareable across the serve engine's slots (generate's path)."""

    name = "draft_model"
    shareable = False

    def __init__(self, model):
        if any(s.kind == "linear" for s in model.cfg.layer_specs()):
            raise ValueError(
                "draft model has linear-attention layers; their recurrent "
                "state cannot roll back between proposals: use an "
                "attention-only draft model or the n-gram drafter")
        self.model = model
        self.reset()

    def reset(self) -> None:
        self.cache = None
        self.kv_len = 0
        self.n_valid = 0        # the cache holds exactly [0, n_valid)

    def propose(self, ids: Sequence[int], k: int) -> list[int]:
        from ..models.common.cache import truncate_cache
        from ..models.common.text_model import bucket_for
        m = self.model
        n = len(ids)
        if n == 0 or n >= m.max_cache_len:
            return []
        # greedy decode writes positions n .. n+k-2: stay inside the cache
        k = min(k, m.max_cache_len - n)
        if k <= 0:
            return []
        need = n + k
        if self.cache is None:
            self.kv_len = bucket_for(need, m.max_cache_len)
            self.cache = m.new_cache(1, kv_len=self.kv_len)
            self.n_valid = 0
        elif need > self.kv_len:
            self.kv_len = bucket_for(need, m.max_cache_len)
            self.cache = m.grow_cache(self.cache, self.kv_len)
        # forward the unseen suffix (at least one token: re-forwarding the
        # last position rewrites identical KV)
        start = min(self.n_valid, n - 1)
        logits, self.cache = m.prefill(self.cache, list(ids[start:n]),
                                       pos0=start)
        self.n_valid = n
        props = [int(logits[0].argmax())]
        for _ in range(k - 1):
            logits, self.cache = m.decode_logits(self.cache, props[-1])
            props.append(int(logits[0].argmax()))
        if len(props) > 1:
            # positions n .. n+k-2 are our own speculation: drop them
            self.cache = truncate_cache(m.cfg, self.cache, n)
        return props


def resolve_drafter(spec, k: int | None = None, ngram: int | None = None):
    """(drafter or None, k) from a generate() or engine `spec` argument.

    spec None reads CAKE_SPEC (unset or empty: off); False forces off;
    "ngram", a Drafter instance or a draft TextModel are taken as they
    are. k defaults to CAKE_SPEC_K, clamped to [1, MAX_SPEC_K]; the
    n-gram drafter's longest match to CAKE_SPEC_NGRAM (at least 2)."""
    knobs = spec_knobs()
    if k is None:
        k = knobs["spec_k"]
    k = max(1, min(int(k), MAX_SPEC_K))
    if spec is None:
        spec = knobs["spec"]
    if spec is None or spec is False:
        return None, k
    if isinstance(spec, str):
        s = spec.strip().lower()
        if s in ("", "0", "off", "none", "false"):
            return None, k
        if s in ("ngram", "prompt", "prompt_lookup", "lookup"):
            mg = knobs["spec_ngram"] if ngram is None else ngram
            return NGramDrafter(max_ngram=max(2, int(mg))), k
        raise ValueError(
            f"unknown drafter {spec!r}: pass 'ngram', a Drafter instance, "
            "or a draft TextModel")
    if isinstance(spec, Drafter):
        return spec, k
    if hasattr(spec, "prefill") and hasattr(spec, "decode_logits"):
        return DraftModelDrafter(spec), k
    raise TypeError(f"cannot build a drafter from {type(spec).__name__}")
