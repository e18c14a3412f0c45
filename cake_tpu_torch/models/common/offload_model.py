"""The eager serving path of a model whose MoE experts stay on disk
(`--expert-offload`; counterpart of
cake_tpu/models/common/offload_model.py: OffloadedTextModel).

The trunk (attention and Gated DeltaNet layers, norms, routers, shared
experts, embeddings, head) is on the device; each MoE layer holds a
`_provider` (expert_provider.DiskExpertProvider) that reads the experts a
token selects into its LRU. The forward is the resident model's
(TextModel.prefill and decode_logits over layers.forward_layers), run
eagerly: routing fetches the selected indices to the host, which a
captured graph cannot replay. A prefill is one bucket-padded chunk with
valid_len (the flash kernel at 256 tokens and up), then one eager decode
step per token over a contiguous batch-1 cache (linear-attention state
for hybrid layers). Sampling is the port's keyed sampling: the request's key
request_key(seed, 0), draw i for token i, as TextModel.generate, so both
models give the same stream from the same logits.

No serve engine: an offloaded model is served one request at a time
(serve/engine.py: maybe_engine returns None; api/state.py).
"""
from __future__ import annotations

from ...obs import observe_generation
from ...ops.sampling import SamplingConfig
from .text_model import TextModel, bucket_for, eager_generate


class OffloadedTextModel(TextModel):
    """TextModel over a parameter tree whose MoE layers carry a
    `_provider` leaf (utils/loaders.ParamLoader(expert_offload=True))
    instead of stacked expert banks. Its prefill and decode step are
    TextModel's (prefill, decode_logits); only generate differs, an eager
    loop in place of the captured chunks."""

    expert_offload = True

    def providers(self) -> list:
        """The MoE layers' expert providers, in layer order."""
        return [lp["mlp"]["_provider"] for lp in self.params["layers"]
                if "_provider" in lp.get("mlp", {})]

    def expert_stats(self) -> dict:
        """The providers' counts summed: hits, misses, reads, bytes_read,
        read_s, resident (experts held in the LRUs)."""
        out = {"hits": 0, "misses": 0, "reads": 0, "bytes_read": 0,
               "read_s": 0.0, "resident": 0}
        for p in self.providers():
            for k, v in p.stats().items():
                out[k] += v
        return out

    def generate(self, prompt_ids: list[int], max_new_tokens: int = 256,
                 sampling: SamplingConfig | None = None, seed: int = 0,
                 on_token=None, **_):
        """text_model.eager_generate over TextModel's prefill and
        decode_logits, in a cache of TextModel.generate's KV bucket.
        Returns (token_ids, stats): eager_generate's stats, `expert_offload:
        True`, and this generation's expert reads, LRU hits and misses,
        bytes and read seconds (expert_*), the prefill's share of each
        beside them (expert_prefill_*)."""
        before = self.expert_stats()
        kv_len = bucket_for(len(prompt_ids) + max_new_tokens,
                            self.max_cache_len)
        state = {"cache": self.new_cache(1, kv_len)}

        def prefill(ids):
            logits, state["cache"] = self.prefill(state["cache"], ids)
            state["mid"] = self.expert_stats()
            return logits

        def decode(tid, pos):
            logits, state["cache"] = self.decode_logits(state["cache"], tid)
            return logits

        out, stats = eager_generate(self.cfg, self.device, prompt_ids,
                                    kv_len, prefill, decode, max_new_tokens,
                                    sampling, seed, on_token)
        after = self.expert_stats()
        stats["expert_offload"] = True
        for k in ("reads", "hits", "misses", "bytes_read", "read_s"):
            stats[f"expert_{k}"] = after[k] - before[k]
            stats[f"expert_prefill_{k}"] = state["mid"][k] - before[k]
        observe_generation(stats, len(out), "offload")
        return out, stats
