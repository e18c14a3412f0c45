"""The captured decode step against the eager one, from one state.

`build_state` fills a slot pool (contiguous rows, or a paged pool with
its tables) through the real prefill programs, one prompt per row at
different lengths (None leaves a row free, hence inactive), and sets each
live row's carries as the engine does after a prefill: the first token
sampled with draw 0 of the row's key, counter 1, the row's sampling
settings. The rows stay inactive until `activate()`, so a DecodeGraph
can be captured over the state first (its warm-up then writes nothing
visible).

`graph_vs_eager` captures the step over one state, clones it, and runs
the graph's steps on the state and the eager in-place step
(TextModel.decode_slots_into) on the clone: the step's tokens, its
logits, every KV byte (the paged sink included) and every carry must be
identical. On the CPU the "graph" is the same eager call, so only the
card's run holds a replay against eager arithmetic; `chip_smoke.py` does
that at the flagship's full width and depth, and
`tests/test_torch_graphs_card.py` on a small config.

`step_by_step` is generate as a loop of single eager decode steps, one
fetch per token: the parity reference of generate's captured chunks.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch

from ..models.common.graphs import DecodeCarries, DecodeGraph
from ..models.common.text_model import bucket_for
from ..ops.sampling import SamplingConfig, push_recent_token, request_key
from ..serve.engine import RECENT_N
from ..serve.paged import PagedKV


@dataclass
class DecodeState:
    """The KV and carries a decode step reads and writes."""
    carries: DecodeCarries
    live: torch.Tensor                       # [B] bool: rows to activate
    layers: list[dict] | None = None         # contiguous pool
    pool: list[dict] = field(default_factory=list)    # paged pool
    rows: list[dict] = field(default_factory=list)
    tables: torch.Tensor | None = None

    @property
    def paged(self) -> bool:
        return self.layers is None

    def kv(self) -> list[torch.Tensor]:
        """Every KV tensor (and the block tables) of the state."""
        caches = self.layers if not self.paged else self.pool + self.rows
        out = [t for lc in caches for t in lc.values()]
        return out + ([self.tables] if self.paged else [])

    def clone(self) -> "DecodeState":
        def copy(caches):
            return [{n: t.clone() for n, t in lc.items()} for lc in caches]
        return DecodeState(
            self.carries.clone(), self.live.clone(),
            None if self.paged else copy(self.layers), copy(self.pool),
            copy(self.rows),
            None if self.tables is None else self.tables.clone())

    def activate(self) -> None:
        self.carries.active.copy_(self.live)

    def step_fn(self, model):
        """The in-place decode step over this state."""
        c = self
        if self.paged:
            return lambda: model.decode_slots_paged_into(
                c.pool, c.rows, c.tables, c.carries)
        return lambda: model.decode_slots_into(c.layers, c.carries)


def _prompt(n: int, seed: int, vocab: int) -> list[int]:
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, min(vocab, 256), (n,), generator=gen).tolist()


def build_state(model, lengths: list[int | None],
                samplings: list[SamplingConfig], ctx: int,
                kv_blocks: int = 0, block_tokens: int = 16,
                chunk: int = 256, headroom: int = 512,
                seed: int = 0) -> DecodeState:
    """A pool of len(lengths) slots with ctx tokens each: row b holds a
    prompt of lengths[b] tokens prefilled in chunks, or nothing (None).
    kv_blocks > 0 makes it paged, with blocks reserved for `headroom`
    decode steps past each prompt. Row b samples with samplings[b] under
    key request_key(seed, b)."""
    n = len(lengths)
    dev = model.device
    paged = None
    if kv_blocks:
        paged = PagedKV.build(model, n, ctx, kv_blocks, block_tokens, chunk)
        state = DecodeState(None, None, None, paged.pool, paged.rows,
                            paged.tables)
    else:
        state = DecodeState(None, None, model.new_cache(n, kv_len=ctx)[
            "layers"])
    c = DecodeCarries.build(n, model.cfg.vocab_size, RECENT_N, dev)
    for b, (length, scfg) in enumerate(zip(lengths, samplings)):
        if length is None:
            continue
        ids = _prompt(length, seed * 1000 + b, model.cfg.vocab_size)
        if paged is not None:
            if not paged.reserve_range(b, 0, min(length + headroom, ctx)):
                raise ValueError("paged pool too small for the state")
        for p0 in range(0, length, chunk):
            part = ids[p0:p0 + chunk]
            if paged is not None:
                logits = paged.prefill_into(b, part, p0)
            else:
                logits, _ = model.prefill_chunk(state.layers, b, part, p0)
        key = request_key(seed, b)
        recent = torch.full((1, RECENT_N), -1, dtype=torch.int32, device=dev)
        tok = model.sample_one(logits, key, 0, scfg, recent)
        c.toks[b] = tok[0]
        c.pos[b] = length
        c.recents[b] = push_recent_token(recent, tok)[0]
        c.keys[b] = key
        c.counters[b] = 1
        c.set_sampling(b, scfg.temperature,
                       scfg.top_k or model.cfg.vocab_size,
                       1.0 if scfg.top_p is None else scfg.top_p,
                       scfg.repeat_penalty)
    state.carries = c
    state.live = torch.tensor([x is not None for x in lengths],
                              dtype=torch.bool, device=dev)
    return state


def graph_vs_eager(model, state: DecodeState, steps: int) -> dict:
    """Capture the step over `state` (rows still inactive), clone it, then
    activate both and run `steps` replays on the state and `steps` eager
    in-place steps on the clone. Returns {graph, eager (the clone),
    tokens (the graph's [steps, 2, B]), tokens_equal, kv_equal,
    carries_equal, max_logit_diff}."""
    graph = DecodeGraph(state.step_fn(model), model.device)
    eager = state.clone()
    eager_step = eager.step_fn(model)
    state.activate()
    eager.activate()
    toks, tokens_equal, max_diff = [], True, 0.0
    for _ in range(steps):
        graph.step()
        eager_step()
        a, b = state.carries, eager.carries
        toks.append(a.packed.to("cpu", copy=True))
        tokens_equal &= torch.equal(a.packed, b.packed)
        max_diff = max(max_diff,
                       (a.logits - b.logits).abs().max().item())
    kv_equal = all(torch.equal(x, y) for x, y in zip(state.kv(), eager.kv()))
    carries_equal = all(
        torch.equal(x, y) for x, y in zip(state.carries.tensors().values(),
                                          eager.carries.tensors().values()))
    return {"graph": graph, "eager": eager, "tokens": torch.stack(toks),
            "tokens_equal": tokens_equal, "kv_equal": kv_equal,
            "carries_equal": carries_equal, "max_logit_diff": max_diff}


def step_by_step(model, ids: list[int], max_new: int, scfg: SamplingConfig,
                 seed: int = 0) -> list[int]:
    """generate's tokens from a loop of eager decode_slots calls at batch
    1, EOS and budget checked after every token."""
    dev = model.device
    n = len(ids)
    kv_len = bucket_for(n + max_new, model.max_cache_len)
    logits, cache = model.prefill(model.new_cache(1, kv_len=kv_len), ids)
    key = request_key(seed, 0)
    recent = torch.full((1, scfg.repeat_last_n), -1, dtype=torch.int32,
                        device=dev)
    tok = model.sample_one(logits, key, 0, scfg, recent)
    recent = push_recent_token(recent, tok)
    out = [int(tok[0])]

    def col(v, dtype):
        return torch.tensor([v], dtype=dtype, device=dev)
    pos, keys, ctr = (col(n, torch.int32), col(key, torch.int64),
                      col(1, torch.int64))
    rest = (col(scfg.temperature, torch.float32),
            col(scfg.top_k or model.cfg.vocab_size, torch.int32),
            col(1.0 if scfg.top_p is None else scfg.top_p, torch.float32),
            col(scfg.repeat_penalty, torch.float32), col(True, torch.bool))
    budget = min(max_new, kv_len - n)
    while len(out) < budget and not model.cfg.is_eos(out[-1]):
        _, tok, pos, recent, ctr = model.decode_slots(
            cache["layers"], tok, pos, recent, keys, ctr, *rest)
        out.append(int(tok[0]))
    return out
