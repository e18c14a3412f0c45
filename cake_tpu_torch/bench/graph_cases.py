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
logits, every KV byte (a block pool's sink aside: DecodeState.kv) and
every carry must be identical. On the CPU the "graph" is the same eager
call, so only the
card's run holds a replay against eager arithmetic; `chip_smoke.py` does
that at the flagship's full width and depth, and
`tests/test_torch_graphs_card.py` on a small config.

`step_by_step` is generate as a loop of single eager decode steps, one
fetch per token: the parity reference of generate's captured chunks.

`prefill_vs_eager` holds the captured prefill programs (graphs.
PrefillGraphs over prefill_chunk_into / prefill_chunk_paged_into) against
the eager host-int chunks (prefill_chunk / prefill_chunk_paged), from one
state: the same prompt in chunks into the same row of two copies of a
pool, logits and every KV byte compared (the paged sink aside).

`engine_addresses` names every tensor a serve engine's captured programs
(decode, verify and prefill) read or write with its data_ptr: a rebuild
must leave all of them where they were.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch

import time

from ..models.common.cache import kv_capacity
from ..models.common.graphs import DecodeCarries, DecodeGraph
from ..models.common.text_model import bucket_for, prefill_start_keys
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
        """Every KV tensor (linear state included, and the block tables)
        of the state; a block pool without its sink, whose contents are
        never visible: masked rows of one step all write there, to the
        same entries at times, and which write lands is not fixed."""
        if not self.paged:
            return [t for lc in self.layers for t in lc.values()]
        out = [t[:-1] for pl in self.pool for t in pl.values()]
        out += [t for rl in self.rows for t in rl.values()]
        return out + [self.tables]

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


def _copy(caches):
    return [{n: t.clone() for n, t in lc.items()} for lc in caches]


def _strict(program):
    """The program under torch.cuda.set_sync_debug_mode("error"): any
    host sync inside it (warm-up or capture) raises."""
    def run(io, bucket, mode):
        torch.cuda.set_sync_debug_mode("error")
        try:
            program(io, bucket, mode)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return run


@dataclass
class PrefillCase:
    """Two copies of a pool after `prefill_vs_eager`: `graphs` replays into
    one, the eager chunks went into the other. `chunks`: (pos0, ids) of
    each chunk; `graph_chunk(i)` / `eager_chunk(i)` run chunk i again
    (each rewrites the same entries: timing)."""
    graphs: object
    chunks: list
    results: list
    kv_equal: bool
    capture_s: float
    graph_chunk: object
    eager_chunk: object


def prefill_vs_eager(model, ids: list[int], slot: int, slots: int, ctx: int,
                     kv_blocks: int = 0, block_tokens: int = 16,
                     chunk: int = 256, strict: bool = False,
                     tenant: list[int] | None = None) -> PrefillCase:
    """`ids` in chunks of `chunk` into row `slot` of a pool of `slots` rows
    of ctx (paged with kv_blocks > 0), row 0 first holding `tenant`'s
    prompt: once through the pool's captured prefill programs (every start
    program captured first, under the sync-debug check when `strict` on a
    card) and once through the eager chunks on a copy. results[i]:
    {key, logits_equal, max_logit_diff}."""
    dev = model.device
    pk = None
    if kv_blocks:
        pk = PagedKV.build(model, slots, ctx, kv_blocks, block_tokens, chunk)
        graphs, cap = pk.prefill, pk.max_blocks * pk.bt
        for row, n in ((0, len(tenant or [])), (slot, len(ids))):
            if n and not pk.reserve_range(row, 0, n):
                raise ValueError("paged pool too small for the case")
        state = (pk.pool, pk.rows, pk.tables)

        def eager_run(st, row, part, p0):
            return model.prefill_chunk_paged(*st, row, part, p0)

        def copy(st):
            return (_copy(st[0]), _copy(st[1]), st[2].clone())
    else:
        layers = model.new_cache(slots, kv_len=ctx)["layers"]
        cap = kv_capacity(model.cfg, {"layers": layers})
        graphs = model.prefill_graphs(
            lambda io, bucket, mode: model.prefill_chunk_into(
                layers, io, bucket, mode), cap, chunk)
        state = layers

        def eager_run(st, row, part, p0):
            return model.prefill_chunk(st, row, part, p0)[0]

        def copy(st):
            return _copy(st)
    if strict and dev.type == "cuda":
        graphs.program = _strict(graphs.program)
    for p0 in range(0, len(tenant or []), chunk):
        eager_run(state, 0, tenant[p0:p0 + chunk], p0)
    eager = copy(state)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    graphs.capture(prefill_start_keys(chunk, cap, model.max_cache_len))
    capture_s = time.perf_counter() - t0
    chunks = [(p0, ids[p0:p0 + chunk]) for p0 in range(0, len(ids), chunk)]
    results = []
    for p0, part in chunks:
        got = graphs.run(slot, part, p0).clone()
        want = eager_run(eager, slot, part, p0)
        results.append({"key": graphs.key(len(part), p0),
                        "logits_equal": torch.equal(got, want),
                        "max_logit_diff": (got - want).abs().max().item()})
    if kv_blocks:
        a = [t[:-1] for pl in state[0] for t in pl.values()]
        b = [t[:-1] for pl in eager[0] for t in pl.values()]
        a += [t for rl in state[1] for t in rl.values()] + [state[2]]
        b += [t for rl in eager[1] for t in rl.values()] + [eager[2]]
    else:
        a = [t for lc in state for t in lc.values()]
        b = [t for lc in eager for t in lc.values()]
    kv_equal = all(torch.equal(x, y) for x, y in zip(a, b))

    def graph_chunk(i):
        p0, part = chunks[i]
        return lambda: graphs.run(slot, part, p0)

    def eager_chunk(i):
        p0, part = chunks[i]
        return lambda: eager_run(eager, slot, part, p0)
    return PrefillCase(graphs, chunks, results, kv_equal, capture_s,
                       graph_chunk, eager_chunk)


def engine_addresses(engine) -> dict[str, int]:
    """data_ptr of every tensor a ServeEngine's decode graph, verify
    graphs and prefill programs read or write: the carries (the verify's
    too, with speculation on), the prefill buffers, and the KV
    (contiguous rows, or the paged pool, rows and block tables)."""
    out = {f"carries.{n}": t.data_ptr()
           for n, t in engine.carries.tensors().items()}
    if engine.spec is not None:
        out.update({f"spec.{n}": t.data_ptr()
                    for n, t in engine.spec.tensors().items()})
    out.update({f"io.{n}": t.data_ptr()
                for n, t in engine.prefill.io.tensors().items()})
    if engine.paged is not None:
        kv = {"pool": engine.paged.pool, "rows": engine.paged.rows}
        out["tables"] = engine.paged.tables.data_ptr()
    else:
        kv = {"layers": engine._layers}
    for name, layers in kv.items():
        for i, lc in enumerate(layers):
            out.update({f"{name}{i}.{k}": t.data_ptr()
                        for k, t in lc.items()})
    return out
