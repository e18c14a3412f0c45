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

import torch

from ...obs import RECORDER, now, observe_generation
from ...ops.sampling import SamplingConfig, push_recent_token, request_key
from .text_model import TextModel, bucket_for


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
        """Up to max_new_tokens (stopping at EOS) under key
        request_key(seed, 0), in a cache of TextModel.generate's KV
        bucket; on_token receives each Token as it is sampled. Returns
        (token_ids, stats): TextModel's stats, `expert_offload: True`, and
        this generation's expert reads, LRU hits and misses, bytes and
        read seconds (expert_*), the prefill's share of each beside them
        (expert_prefill_*)."""
        cfg = self.cfg
        scfg = sampling or SamplingConfig()
        key = request_key(seed, 0)
        before = self.expert_stats()
        n = len(prompt_ids)
        kv_len = bucket_for(n + max_new_tokens, self.max_cache_len)
        cache = self.new_cache(1, kv_len)
        recent = torch.full((1, scfg.repeat_last_n), -1, dtype=torch.int32,
                            device=self.device)
        t0 = now()
        with RECORDER.span("prefill", cat="gen", tokens=n):
            logits, cache = self.prefill(cache, prompt_ids)
        mid = self.expert_stats()
        with RECORDER.span("sample", cat="phase"):
            tok = self.sample_one(logits, key, 0, scfg, recent)
            recent = push_recent_token(recent, tok)
            tid = int(tok[0])           # the host paces the next step
        ttft = now() - t0
        out = [tid]
        if on_token is not None:
            on_token(self.mk_token(tid))
        budget = min(max_new_tokens, kv_len - n)
        t1 = now()
        while not cfg.is_eos(tid) and len(out) < budget:
            with RECORDER.span("decode_token", cat="gen", pos=cache["pos"]):
                logits, cache = self.decode_logits(cache, tid)
                with RECORDER.span("sample", cat="phase"):
                    tok = self.sample_one(logits, key, len(out), scfg,
                                          recent)
                    recent = push_recent_token(recent, tok)
                    tid = int(tok[0])
            out.append(tid)
            if on_token is not None:
                on_token(self.mk_token(tid))
        dt = now() - t1
        after = self.expert_stats()
        stats = {"ttft_s": ttft, "decode_tokens": len(out) - 1,
                 "decode_s": dt,
                 "tok_per_s": (len(out) - 1) / dt if dt > 0 else 0.0,
                 "expert_offload": True}
        for k in ("reads", "hits", "misses", "bytes_read", "read_s"):
            stats[f"expert_{k}"] = after[k] - before[k]
            stats[f"expert_prefill_{k}"] = mid[k] - before[k]
        observe_generation(stats, len(out), "offload")
        return out, stats

    def chat_generate(self, messages: list[dict], **kw):
        return self.generate(self.tokenizer.chat_prompt_ids(messages), **kw)
