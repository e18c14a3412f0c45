"""Captured decode programs (counterpart of the reference's compiled
decode programs: text_model.py `_decode_slots`, `_decode_slots_paged` and
`generate`'s `_decode_chunk`).

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
captured into a private memory pool. There is no fallback: a capture or
replay error goes up to the caller.

Launch counts: the kernel wrappers count in Python, where they launch.
The capture runs them once without launching anything, so DecodeGraph
takes that count back out and adds it again on every replay: the counts
keep meaning launches on the device.

On CPU tensors `step()` calls the step itself on the same buffers: the
eager step is the parity reference.
"""
from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Callable

import torch

WARMUP = 2      # side-stream runs of the step before its capture


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

    @classmethod
    def build(cls, batch: int, vocab: int, recent_n: int,
              device) -> "DecodeCarries":
        """Every row inactive and greedy, on `device`."""
        def full(shape, value, dtype):
            return torch.full(shape, value, dtype=dtype, device=device)
        return cls(
            toks=full((batch,), 0, torch.int32),
            pos=full((batch,), 0, torch.int32),
            recents=full((batch, recent_n), -1, torch.int32),
            keys=full((batch,), 0, torch.int64),
            counters=full((batch,), 0, torch.int64),
            temps=full((batch,), 0.0, torch.float32),
            top_ks=full((batch,), vocab, torch.int32),
            top_ps=full((batch,), 1.0, torch.float32),
            pens=full((batch,), 1.0, torch.float32),
            active=full((batch,), False, torch.bool),
            packed=full((2, batch), 0, torch.int32),
            logits=full((batch, vocab), 0.0, torch.float32))

    def tensors(self) -> dict[str, torch.Tensor]:
        return {f.name: getattr(self, f.name) for f in fields(self)}

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


def _launch_cells() -> list[tuple[dict, str]]:
    """(dict, key) of every kernel wrapper's launch count."""
    from ...ops import flash, paged_attention
    cells = [(modes, m) for modes in flash.flash_attention.launches.values()
             for m in modes]
    pa = paged_attention.paged_decode_attention.launches
    return cells + [(pa, r) for r in pa]


def _read(cells) -> list[int]:
    return [d[k] for d, k in cells]


def _add(cells, delta: list[int], sign: int = 1) -> None:
    for (d, k), n in zip(cells, delta):
        d[k] += sign * n


class DecodeGraph:
    """One decode program: `step_fn()` writes its results into the
    buffers it closes over. On a CUDA device it is captured at
    construction and `step()` replays it; on the CPU `step()` calls it."""

    def __init__(self, step_fn: Callable[[], None], device,
                 warmup: int = WARMUP):
        self.step_fn = step_fn
        self.device = torch.device(device)
        self.graph: torch.cuda.CUDAGraph | None = None
        self.steps = 0          # step() calls: replays on a card
        self._cells = _launch_cells()
        self._delta = [0] * len(self._cells)
        if self.device.type == "cuda":
            self._capture(warmup)

    def _capture(self, warmup: int) -> None:
        dev = self.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(warmup):
                self.step_fn()
        torch.cuda.current_stream(dev).wait_stream(side)
        before = _read(self._cells)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(dev), torch.cuda.graph(
                graph, capture_error_mode="thread_local"):
            self.step_fn()
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
