"""The speculative verify on the card: its paged kernel cases, their bounds
and the library yardstick, the captured verify graph against the eager
step, and the plain greedy stream with its top-2 logit gaps.
`chip_smoke.py` phase 12 runs them at the flagship's full width and depth.

`verify_case` builds a paged verify's inputs from a seed: each active slot
holds its committed positions 0 .. p-1 and the n_input entries the verify
wrote at p .. p+n_input-1 (so the pool is `paged_case`'s at frontier
p + n_input - 1), q is [B, S, Hq, D], and row (b, i) reads slot b's table
at frontier p + i. Slots given as None are inactive: an all-NULL table.
Rows past a slot's n_input (a padded draft window) and an inactive slot's
rows are don't-care; the kernel and the plain version still compute the
same function there, so only rows without a visible key are skipped.

`verify_bounds` gives two least times for one call on an H100 SXM: over
the unique bytes (each slot's live K/V once, as the function needs) and
over the bytes the flattened rows read (each row its slot's live blocks,
about S times the unique bytes), each the larger of bytes over HBM
bandwidth and FLOPs (4 per visible key, head and channel, this run's
valid rows) over the peak of q's type.

`verify_vs_eager` captures the in-place verify over a DecodeState (graph
_cases.build_state) and holds its replays against the eager in-place
step on a clone, per step: packed ids, logits, every KV byte and every
carry. `plain_stream` is the spec-off greedy stream of a pool, eagerly,
with each step's top-2 logit gap.
"""
from __future__ import annotations

import torch

from .graph_cases import DecodeState
from .paged_cases import paged_case
from .paged_timing import H100_HBM_BYTES_S, H100_PEAK_FLOPS, PEAK_NAMES
from ..models.common.cache import paged_gather_layer
from ..models.common.graphs import DecodeCarries, DecodeGraph, SpecCarries


def verify_case(slots: list, s: int, dtype=torch.float32, device="cpu",
                bt: int = 16, hq: int = 16, hkv: int = 8, d: int = 128,
                ctx: int = 4096, shared: bool = False,
                seed: int = 0) -> dict:
    """{q, k, v, pos, tables, frontier} of one paged verify over slots
    [(p, n_input) or None] (the active ones first), plus `slots`, `s` and
    `visible` ([B, S] bool: rows with at least one visible key)."""
    live = [x for x in slots if x is not None]
    if slots[:len(live)] != live:
        raise ValueError("list the active slots first")
    c = paged_case([p + n - 1 for p, n in live], dtype=dtype, device=device,
                   bt=bt, hq=hq, hkv=hkv, d=d, ctx=ctx,
                   null_rows=len(slots) - len(live), shared=shared,
                   seed=seed)
    gen = torch.Generator().manual_seed(seed + 1)
    b = len(slots)
    c["q"] = torch.randn((b, s, hq, d), generator=gen).to(dtype).to(device)
    c["frontier"] = torch.tensor([x[0] if x else 0 for x in slots],
                                 dtype=torch.int32, device=device)
    c["visible"] = torch.tensor([[x is not None] * s for x in slots])
    c["slots"], c["s"] = slots, s
    return c


def verify_bounds(c) -> dict:
    """{unique_ms, read_ms, bound_by}: the least time over the unique bytes
    and over the bytes the flattened rows read (see the module
    docstring)."""
    q, k = c["q"], c["k"]
    b, s, hq, d = q.shape
    bt, hkv = k.shape[1], k.shape[2]
    el = q.element_size()
    per_key = 2 * hkv * d * el + 4              # K and V rows, a position
    live = [x for x in c["slots"] if x is not None]
    unique_keys = sum(p + n for p, n in live)
    unique_blocks = sum(-(-(p + n) // bt) for p, n in live)
    read_keys = sum(p + i + 1 for p, _ in live for i in range(s))
    read_blocks = sum(-(-(p + i + 1) // bt) for p, _ in live
                      for i in range(s))
    io = 2 * q.numel() * el + 4 * b             # q, o, the frontiers
    flops = 4.0 * hq * d * sum(p + i + 1 for p, n in live for i in range(n))
    peak = H100_PEAK_FLOPS[PEAK_NAMES.get(str(q.dtype), "f32")]
    t_ops = flops / peak
    t_unique = (unique_keys * per_key + 4 * unique_blocks + io) \
        / H100_HBM_BYTES_S
    t_read = (read_keys * per_key + 4 * read_blocks + io) / H100_HBM_BYTES_S
    return {"unique_ms": max(t_ops, t_unique) * 1e3,
            "read_ms": max(t_ops, t_read) * 1e3,
            "bound_by": "operations" if t_ops >= t_unique else "bytes"}


def library_args(c):
    """scaled_dot_product_attention over the same function: each slot's
    row gathered beforehand (not timed) into [B, Hkv, T, D] K/V, T its
    longest row, with the causal draft mask [B, 1, S, T]; a yardstick the
    port never calls. Slots with no visible key attend to key 0."""
    s = c["s"]
    view = paged_gather_layer({n: c[n] for n in ("k", "v", "pos")},
                              c["tables"], c["frontier"] + s)
    t = int(c["frontier"].max()) + s
    kk = view["k"][:, :t].transpose(1, 2).contiguous()
    vv = view["v"][:, :t].transpose(1, 2).contiguous()
    kpos = view["pos"][:, :t]
    qpos = c["frontier"][:, None].long() + torch.arange(s, device=kpos.device)
    mask = (kpos[:, None, :] >= 0) & (kpos[:, None, :] <= qpos[:, :, None])
    mask[:, :, 0] |= ~mask.any(-1)
    return (c["q"].transpose(1, 2), kk, vv), dict(attn_mask=mask[:, None],
                                                 enable_gqa=True)


def case_args(c) -> tuple:
    return tuple(c[n] for n in ("q", "k", "v", "pos", "tables", "frontier"))


# -- the captured verify against the eager step ------------------------------


def _verify_fn(model, state: DecodeState, spec: SpecCarries, filt: bool):
    if state.paged:
        return lambda: model.spec_slots_paged_into(
            state.pool, state.rows, state.tables, spec, filt)
    return lambda: model.spec_slots_into(state.layers, spec, filt)


def continuation(model, state: DecodeState, steps: int) -> list[list[int]]:
    """Each row's plain stream after its first token for `steps` decode
    steps, from a clone of `state` (rows not yet active) through a
    captured decode step; the clone is dropped."""
    ref = state.clone()
    graph = DecodeGraph(ref.step_fn(model), model.device)
    ref.activate()
    out = []
    for _ in range(steps):
        graph.step()
        out.append(ref.carries.packed[1].to("cpu", copy=True))
    rows = torch.stack(out, 1).tolist()
    del graph, ref
    return rows


def verify_vs_eager(model, state: DecodeState, k: int, steps: int,
                    plans: list, filt: bool) -> dict:
    """Capture the verify over `state` (rows inactive), clone it, then
    activate both and run `steps` replays against `steps` eager in-place
    verifies with the same drafts. plans[b]: a row's drafts each step,
    "right" (its plain continuation, which greedy accepts), "wrong" (the
    continuation shifted by one), or None (no drafts). Returns {graph,
    eager_fn, spec, tokens [steps, 3, B], n_acc per row, equal (packed
    and logits every step), kv_equal, carries_equal, max_logit_diff}."""
    cont = continuation(model, state, steps * (k + 1) + 1)
    spec = SpecCarries.build(state.carries, k)
    graph = DecodeGraph(_verify_fn(model, state, spec, filt), model.device)
    eager = state.clone()
    espec = SpecCarries.build(eager.carries, k)
    eager_fn = _verify_fn(model, eager, espec, filt)
    state.activate()
    eager.activate()
    b = len(plans)
    done = [0] * b                  # tokens of each row past its first
    toks, equal, max_diff = [], True, 0.0
    accepted = [0] * b
    for _ in range(steps):
        drafts = [[0] * k for _ in range(b)]
        nd = [0] * b
        for r, plan in enumerate(plans):
            if plan is None:
                continue
            right = cont[r][done[r]:done[r] + k]
            drafts[r] = right if plan == "right" else \
                [(t + 1) % model.cfg.vocab_size for t in right]
            nd[r] = k
        spec.load(drafts, nd)
        espec.load(drafts, nd)
        graph.step()
        eager_fn()
        equal &= torch.equal(spec.packed, espec.packed) and \
            torch.equal(spec.logits, espec.logits)
        max_diff = max(max_diff,
                       (spec.logits - espec.logits).abs().max().item())
        packed = spec.packed.to("cpu", copy=True)
        toks.append(packed)
        for r in range(b):
            if plans[r] is not None:
                accepted[r] += int(packed[1, r])
                done[r] += int(packed[1, r]) + 1
    kv_equal = all(torch.equal(x, y) for x, y in zip(state.kv(), eager.kv()))
    carries_equal = all(
        torch.equal(x, y) for x, y in zip(
            list(state.carries.tensors().values())
            + list(spec.tensors().values()),
            list(eager.carries.tensors().values())
            + list(espec.tensors().values())))
    return {"graph": graph, "eager_fn": eager_fn, "spec": spec,
            "tokens": torch.stack(toks), "accepted": accepted,
            "equal": equal, "kv_equal": kv_equal,
            "carries_equal": carries_equal, "max_logit_diff": max_diff,
            "continuation": cont}


# -- the plain stream and its near ties ------------------------------------


@torch.no_grad()
def plain_stream(model, prompts: list[list[int]], n: int, ctx: int,
                 kv_blocks: int = 0, block_tokens: int = 16,
                 chunk: int = 256, keep_logits: bool = False) -> list[dict]:
    """The spec-off greedy stream of each prompt in its own row of a pool
    of len(prompts) rows (contiguous, or paged with kv_blocks), through
    the eager prefill chunks and decode steps the engine's graphs
    replay: per row {tokens (n), gaps (each token's top-2 logit gap)}, and
    with keep_logits each token's float32 logits [V] (logits)."""
    from ..serve.engine import RECENT_N
    from ..serve.paged import PagedKV
    dev = model.device
    b = len(prompts)
    if kv_blocks:
        pk = PagedKV.build(model, b, ctx, kv_blocks, block_tokens, chunk)
    else:
        layers = model.new_cache(b, kv_len=ctx)["layers"]
    c = DecodeCarries.build(b, model.cfg.vocab_size, RECENT_N, dev)
    out = [{"tokens": [], "gaps": []} for _ in prompts]

    def take(row, logits):
        top = torch.topk(logits.float(), 2).values
        out[row]["tokens"].append(int(logits.argmax()))
        out[row]["gaps"].append(float(top[0] - top[1]))
        if keep_logits:
            out[row].setdefault("logits", []).append(logits.float().clone())
    for row, ids in enumerate(prompts):
        for p0 in range(0, len(ids), chunk):
            part = ids[p0:p0 + chunk]
            if kv_blocks:
                if not pk.reserve_range(row, p0, len(part) + n):
                    raise ValueError("paged pool too small")
                logits = pk.prefill_into(row, part, p0)
            else:
                logits, _ = model.prefill_chunk(layers, row, part, p0)
        take(row, logits[0])
        c.toks[row] = out[row]["tokens"][0]
        c.pos[row] = len(ids)
        c.recents[row, -1] = out[row]["tokens"][0]
    c.active.fill_(True)
    for _ in range(n - 1):
        if kv_blocks:
            model.decode_slots_paged_into(pk.pool, pk.rows, pk.tables, c)
        else:
            model.decode_slots_into(layers, c)
        for row in range(b):
            take(row, c.logits[row])
    return out
