"""Speculative decoding (counterpart of cake_tpu/spec/): a drafter
proposes up to CAKE_SPEC_K continuation tokens, one verify step forwards
them all, and the accept rule keeps the prefix the target model agrees
with. Greedy output equals plain greedy decoding; sampled output keeps
the target distribution (Leviathan et al. 2023; Chen et al. 2023).

  drafter.py: Drafter, NGramDrafter (prompt lookup), DraftModelDrafter
              (a smaller model), resolve_drafter, spec_knobs
  verify.py:  generate's host loop and the spec instruments

The device pieces: ops/sampling.py (filtered_probs, spec_accept), the
verify programs of models/common/text_model.py (verify_tokens,
spec_slots, spec_slots_paged and their `_into` forms), the held ring
writes and the paged verify writes of models/common/cache.py and
layers.py, and ops/paged_attention.py: paged_verify_attention.
Entry points: TextModel.generate(spec=..., spec_k=...) and the serve
engine (serve/engine.py: spec, spec_k, spec_reserve; `cli serve` and
`cli run` read CAKE_SPEC, CAKE_SPEC_K, CAKE_SPEC_NGRAM and
CAKE_SPEC_RESERVE).
"""
from .drafter import (DEFAULT_SPEC_K, MAX_SPEC_K, Drafter, DraftModelDrafter,
                      NGramDrafter, resolve_drafter, spec_knobs)
from .verify import record_step, spec_decode_loop, spec_stats_dict

__all__ = [
    "Drafter", "DraftModelDrafter", "NGramDrafter", "resolve_drafter",
    "spec_decode_loop", "record_step", "spec_stats_dict", "spec_knobs",
    "DEFAULT_SPEC_K", "MAX_SPEC_K",
]
