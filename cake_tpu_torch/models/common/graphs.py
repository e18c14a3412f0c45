"""Captured decode, verify and prefill programs (counterpart of the
reference's compiled programs: text_model.py `_decode_slots`,
`_decode_slots_paged`, `generate`'s `_decode_chunk`, the speculative
verify `_spec_slots` / `_spec_slots_paged`, and the per-bucket prefill
programs `_prefill_slot` / `_prefill_slot_paged`).

The reference jits its decode step, so the host issues one program per
step. The port's step is hundreds of small torch ops per layer; issued
eagerly from Python, the host sets the step's pace. On a CUDA device
`DecodeGraph` captures the step once into a `torch.cuda.CUDAGraph` and
replays it, so one host call issues the whole step.

A graph reads and writes fixed addresses. `DecodeCarries` holds every
per-row tensor the step reads or writes (the input token, position,
recent window, sampling key and counter, sampling settings, the active
mask, and the step's outputs `packed` and `logits`); the step writes its
results INTO them (TextModel.decode_slots_into). The KV the step touches
(a contiguous pool, or a block pool with its tables and rows) is only
ever written in place between replays. Whoever owns the carries and the
KV writes them in place too (`carries.toks[slot] = ...`), never rebinds.

Capture: the step runs WARMUP times on a side stream first, with every
row inactive, so that every lazy first-use call (kernel library loads,
the paged kernel's shared-memory attribute, cuBLAS handles) happens
outside the capture and nothing is written: an inactive row keeps its
contiguous KV entry and writes the paged pool's sink. Then one step is
captured into a private memory pool with Python's garbage collector held
off: a dead graph that the collector destroyed in mid-capture would free
its graph there, which CUDA refuses while a stream captures (and the
capture is lost). A full collection first frees the dead graphs and
pools of earlier captures; it costs ~0.2 s in a large process, so a set
of programs captured together (an engine's start, `PrefillGraphs.capture`)
runs one for the set (`collect=False` on each graph), and a prefill
program captured at its key's first use runs none (it joins its set's
pool). The capture calls `CUDAGraph.capture_begin` / `capture_end`
itself: `torch.cuda.graph` would also empty the caching allocator before
every capture, and the eager code after it would then allocate afresh
from the device. There is no fallback: a capture or replay error goes up
to the caller.

Launch counts: the kernel wrappers count in Python, where they launch.
The capture runs them once without launching anything, so DecodeGraph
takes that count back out and adds it again on every replay: the counts
keep meaning launches on the device.

On CPU tensors `step()` calls the step itself on the same buffers: the
eager step is the parity reference.

Verify: the speculative verify step is a DecodeGraph too, one per (pool,
k, filt) as the reference compiles one executable per (slot bucket, k,
filt). `SpecCarries` adds the drafts, the verify's packed ids and its
logits to the decode carries it shares; the verify writes its results
into both (TextModel.spec_slots_into).

Prefill: `PrefillGraphs` keeps one `PrefillGraph` per (bucket, flash
mode) of one pool (contiguous or paged), the counterpart of the
reference's one executable per (chunk bucket, flash mode). Every graph of
the set reads one `PrefillIO`: the chunk's {slot, pos0, valid_len} and
tokens in one int32 buffer, which the host fills with one copy before a
replay (from pinned memory on a card), and the logits buffer the program
writes. A graph's warm-up runs with valid_len 0, so it writes no KV byte,
position or table entry. The set's graphs share one private memory pool
(only one runs at a time), apart from the decode graph's.
"""
from __future__ import annotations

import functools
import gc
from dataclasses import dataclass, fields
from typing import Callable

import torch

WARMUP = 1      # side-stream runs of the step before its capture


@dataclass
class DecodeCarries:
    """Per-row state of a decode step over B rows, at fixed addresses.

    toks/pos: [B] int32, each row's input token and its position;
    recents: [B, N] int32 (-1 padded); keys: [B] int64, each row's
    sampling key (ops.sampling.request_key); counters: [B] int64, the
    draw the row's next step takes; temps/top_ps/pens: [B] float32;
    top_ks: [B] int32; active: [B] bool; packed: [2, B] int32, the last
    step's [input token ; sampled token]; logits: [B, V] float32, the
    last step's logits."""
    toks: torch.Tensor
    pos: torch.Tensor
    recents: torch.Tensor
    keys: torch.Tensor
    counters: torch.Tensor
    temps: torch.Tensor
    top_ks: torch.Tensor
    top_ps: torch.Tensor
    pens: torch.Tensor
    active: torch.Tensor
    packed: torch.Tensor
    logits: torch.Tensor

    @staticmethod
    def _fresh(vocab: int) -> dict:
        """Each carry's fill value: every row inactive and greedy."""
        return dict(toks=0, pos=0, recents=-1, keys=0, counters=0,
                    temps=0.0, top_ks=vocab, top_ps=1.0, pens=1.0,
                    active=False, packed=0, logits=0.0)

    @classmethod
    def build(cls, batch: int, vocab: int, recent_n: int,
              device) -> "DecodeCarries":
        """Every row inactive and greedy, on `device`."""
        shapes = dict(recents=(batch, recent_n), packed=(2, batch),
                      logits=(batch, vocab))
        dtypes = dict(toks=torch.int32, pos=torch.int32,
                      recents=torch.int32, keys=torch.int64,
                      counters=torch.int64, temps=torch.float32,
                      top_ks=torch.int32, top_ps=torch.float32,
                      pens=torch.float32, active=torch.bool,
                      packed=torch.int32, logits=torch.float32)
        return cls(**{name: torch.full(shapes.get(name, (batch,)), value,
                                       dtype=dtypes[name], device=device)
                      for name, value in cls._fresh(vocab).items()})

    def tensors(self) -> dict[str, torch.Tensor]:
        return {f.name: getattr(self, f.name) for f in fields(self)}

    def reset(self) -> None:
        """Every row inactive and greedy again, written in place (the
        graphs keep reading these addresses; nothing is allocated)."""
        for name, value in self._fresh(self.logits.shape[1]).items():
            getattr(self, name).fill_(value)

    def clone(self) -> "DecodeCarries":
        return DecodeCarries(**{n: t.clone()
                                for n, t in self.tensors().items()})

    def set_sampling(self, row: int, temperature: float, top_k: int,
                     top_p: float, penalty: float) -> None:
        """Write row `row`'s sampling settings in place."""
        self.temps[row] = temperature
        self.top_ks[row] = top_k
        self.top_ps[row] = top_p
        self.pens[row] = penalty


@dataclass
class SpecCarries:
    """The speculative verify's carries beside the decode step's, at fixed
    addresses. `decode`: the DecodeCarries the verify shares with the
    decode step (toks, pos, recents, keys, counters, the sampling settings
    and the active mask: a slot moves between the two programs from one
    iteration to the next). `io`: int32 [B, 1 + k], column 0 each row's
    draft count and columns 1.. its drafts, so that the host loads an
    iteration's drafts in one copy; `drafts` [B, k] and `n_drafts` [B]
    are views of it. `packed`: int32 [3, B], the last verify's [input
    token ; accepted drafts ; next token]; `logits`: [B, k + 1, V]
    float32, the last verify's logits at every input position."""
    decode: DecodeCarries
    io: torch.Tensor
    packed: torch.Tensor
    logits: torch.Tensor

    @classmethod
    def build(cls, decode: DecodeCarries, k: int) -> "SpecCarries":
        b, vocab = decode.logits.shape
        dev = decode.logits.device
        return cls(decode=decode,
                   io=torch.zeros((b, 1 + k), dtype=torch.int32, device=dev),
                   packed=torch.zeros((3, b), dtype=torch.int32, device=dev),
                   logits=torch.zeros((b, k + 1, vocab), dtype=torch.float32,
                                      device=dev))

    @property
    def drafts(self) -> torch.Tensor:
        return self.io[:, 1:]

    @property
    def n_drafts(self) -> torch.Tensor:
        return self.io[:, 0]

    def load(self, drafts, n_drafts) -> None:
        """Write an iteration's drafts ([B, k] and [B] integers, host
        arrays) in place, in one copy (from pinned memory, without a host
        sync, on a card)."""
        cuda = self.io.device.type == "cuda"
        host = torch.empty(tuple(self.io.shape), dtype=torch.int32,
                           pin_memory=cuda)
        host[:, 0] = torch.as_tensor(n_drafts, dtype=torch.int32)
        host[:, 1:] = torch.as_tensor(drafts, dtype=torch.int32)
        self.io.copy_(host, non_blocking=cuda)

    def tensors(self) -> dict[str, torch.Tensor]:
        """The verify's own buffers (the shared ones are decode's)."""
        return {"io": self.io, "packed": self.packed, "logits": self.logits}

    def reset(self) -> None:
        """No drafts and no outputs, written in place (the decode carries
        reset on their own)."""
        for t in self.tensors().values():
            t.zero_()


def _launch_cells() -> list[tuple[dict, str]]:
    """(dict, key) of every kernel wrapper's launch count."""
    from ...ops import flash, fp8, paged_attention
    cells = [(modes, m) for modes in flash.flash_attention.launches.values()
             for m in modes]
    for pa in (paged_attention.paged_decode_attention.launches,
               paged_attention.paged_verify_attention.launches,
               fp8.dequant_fp8_blockwise.launches):
        cells += [(pa, r) for r in pa]
    return cells


def _read(cells) -> list[int]:
    return [d[k] for d, k in cells]


def _add(cells, delta: list[int], sign: int = 1) -> None:
    for (d, k), n in zip(cells, delta):
        d[k] += sign * n


class DecodeGraph:
    """One decode program: `step_fn()` writes its results into the
    buffers it closes over. On a CUDA device it is captured at
    construction and `step()` replays it; on the CPU `step()` calls it.
    `pool`: a memory pool handle to share with other graphs (None: a
    private pool of its own). `collect`: run a full garbage collection
    before the capture (False where the caller ran one for a set)."""

    def __init__(self, step_fn: Callable[[], None], device,
                 warmup: int = WARMUP, pool=None, collect: bool = True):
        self.step_fn = step_fn
        self.device = torch.device(device)
        self.graph: torch.cuda.CUDAGraph | None = None
        self.steps = 0          # step() calls: replays on a card
        self._cells = _launch_cells()
        self._delta = [0] * len(self._cells)
        self._pool = pool
        if self.device.type == "cuda":
            self._capture(warmup, collect)

    def _capture(self, warmup: int, collect: bool) -> None:
        dev = self.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(warmup):
                self.step_fn()
        torch.cuda.current_stream(dev).wait_stream(side)
        before = _read(self._cells)
        graph = torch.cuda.CUDAGraph()
        if collect:
            gc.collect()
        pool = () if self._pool is None else (self._pool,)
        enabled = gc.isenabled()
        gc.disable()
        try:
            torch.cuda.synchronize(dev)
            with torch.cuda.device(dev), torch.cuda.stream(side):
                graph.capture_begin(*pool, capture_error_mode="thread_local")
                try:
                    self.step_fn()
                finally:
                    graph.capture_end()
        finally:
            if enabled:
                gc.enable()
        self._delta = [a - b for a, b in zip(_read(self._cells), before)]
        _add(self._cells, self._delta, -1)      # the capture launched none
        self.graph = graph

    @property
    def launches_per_step(self) -> list[int]:
        """Each wrapper's launches in one replay (zeros on the CPU)."""
        return list(self._delta)

    def step(self) -> None:
        if self.graph is None:
            self.step_fn()
        else:
            self.graph.replay()
            _add(self._cells, self._delta)
        self.steps += 1


@dataclass
class PrefillIO:
    """The fixed buffers of a pool's prefill programs. `io`: int32 [3 +
    width], the chunk's meta {slot, pos0, valid_len} and then its tokens,
    right-padded with 0; `logits`: [1, V] float32, the logits of the
    chunk's last valid position."""
    io: torch.Tensor
    logits: torch.Tensor

    @classmethod
    def build(cls, width: int, vocab: int, device) -> "PrefillIO":
        return cls(io=torch.zeros(3 + width, dtype=torch.int32, device=device),
                   logits=torch.zeros((1, vocab), dtype=torch.float32,
                                      device=device))

    @property
    def meta(self) -> torch.Tensor:
        """int32 [3] {slot, pos0, valid_len}."""
        return self.io[:3]

    def tokens(self, bucket: int) -> torch.Tensor:
        """[1, bucket] int32: the chunk's tokens."""
        return self.io[3:3 + bucket][None]

    def load(self, slot: int, pos0: int, ids) -> None:
        """Write a chunk's meta and tokens in place, in one copy (from
        pinned memory, without a host sync, on a card)."""
        ids = [int(t) for t in ids]
        width = self.io.shape[0] - 3
        if len(ids) > width:
            raise ValueError(f"chunk of {len(ids)} tokens exceeds the "
                             f"prefill buffer's {width}")
        cuda = self.io.device.type == "cuda"
        host = torch.tensor([slot, pos0, len(ids)] + ids
                            + [0] * (width - len(ids)), dtype=torch.int32,
                            pin_memory=cuda)
        self.io.copy_(host, non_blocking=cuda)

    def tensors(self) -> dict[str, torch.Tensor]:
        return {"io": self.io, "logits": self.logits}


class PrefillGraph(DecodeGraph):
    """One prefill program, `run()`, which reads `io` and writes the KV and
    io.logits in place: captured at construction on a CUDA device (after
    WARMUP side-stream runs with valid_len 0, which write nothing), called
    by step() on the CPU."""

    def __init__(self, run: Callable[[], None], io: PrefillIO, device,
                 pool=None, warmup: int = WARMUP, collect: bool = True):
        io.meta.zero_()             # slot 0, pos0 0, valid_len 0
        super().__init__(run, device, warmup, pool, collect)


class PrefillGraphs:
    """Every prefill program of one pool: a PrefillGraph per (bucket, flash
    mode), built by `capture(keys)` or at a key's first use, all reading
    one PrefillIO and sharing one memory pool on a card. `program(io,
    bucket, mode)` is the pool's in-place prefill; `key(n, pos0)` names
    the program of an n-token chunk at pos0 (text_model.prefill_key). A
    capture or replay error goes up to the caller: there is no eager
    fallback on a card."""

    def __init__(self, program: Callable, key: Callable, width: int,
                 vocab: int, device):
        self.program = program
        self.key = key
        self.device = torch.device(device)
        self.io = PrefillIO.build(width, vocab, self.device)
        self.pool = (torch.cuda.graph_pool_handle()
                     if self.device.type == "cuda" else None)
        self.graphs: dict[tuple[int, str], PrefillGraph] = {}

    def graph(self, key: tuple[int, str]) -> PrefillGraph:
        g = self.graphs.get(key)
        if g is None:
            # bound to the program and buffers, not to this set, so that a
            # dropped set is freed at once (no reference cycle); captured
            # with no collection of its own: it joins the set's pool
            g = PrefillGraph(functools.partial(self.program, self.io, *key),
                             self.io, self.device, self.pool, collect=False)
            self.graphs[key] = g
        return g

    def capture(self, keys, collect: bool = True) -> None:
        """Capture the programs of `keys`, after one full garbage
        collection for the set (none where `collect` is False: the caller
        ran one)."""
        if collect and self.device.type == "cuda":
            gc.collect()
        for key in keys:
            self.graph(key)

    def run(self, slot: int, ids, pos0: int) -> torch.Tensor:
        """Prefill one chunk of `ids` into `slot` at pos0 by replaying its
        program; returns io.logits (overwritten by the next chunk)."""
        g = self.graph(self.key(len(ids), pos0))
        self.io.load(slot, pos0, ids)
        g.step()
        return self.io.logits

    @property
    def replays(self) -> int:
        """step() calls over every graph of the set."""
        return sum(g.steps for g in self.graphs.values())
