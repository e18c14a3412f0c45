"""Paged decode attention: a hand-written CUDA kernel for Hopper, with the
plain PyTorch version beside it.

Not a port of a TPU kernel: in the reference this step is XLA. Its paged
decode (models/common/text_model.py:578-641) gathers each slot's whole
logical row from the block pool (`paged_gather_layer`, cache.py:383),
writes the step's entry at position p, and runs `multi_head_attention`
(ops/attention.py:40) over the row with a position mask. The kernel
computes the same function and reads only the slot's live blocks.

Function, per row b of the decode batch: q [B, 1, Hq, D]; the pool's k, v
[NB + 1, bt, Hkv, D] and pos [NB + 1, bt] int32 (the last block is the
sink, id NB = NULL, never visible); tables [B, M] int32; frontier [B]
int32, the step's write position p, whose entry is already in the pool.
A key at table entry j, index i, is visible iff the entry is mapped,
pos // bt == j and 0 <= pos <= p. GQA maps head h to kv head h // (Hq /
Hkv); scale 1/sqrt(D); output [B, 1, Hq, D] in q's dtype. A row with no
visible key is don't-care.

Routes by dtype, one source (csrc/paged_decode.cu): bfloat16 for serving,
float16 for f16 models, float32 for the parity phase. All on FMA: a decode row does about one
FLOP per byte it reads, so bytes bound it and tensor cores buy nothing.
One launch per call: a thread-block cluster of CLUSTER CTAs per (row, KV
head), each rank walking every CLUSTER-th live page block through a TMA
ring, merged in rank order in distributed shared memory. `PagedPlan` is
the launch plan, in Python so the CPU tests can hold it; the wrapper
passes exactly its cluster size, stages and shared-memory bytes.

The wrapper launches the kernel for CUDA tensors (checking device, dtype,
shapes and contiguity, and raising on anything else), and computes the
plain version only for CPU tensors. No host sync: p stays on the device.

The speculative verify's attention runs on the same kernel
(`paged_verify_attention`). In the reference a verify forwards k + 1
tokens per slot, below FLASH_MIN_SEQ, so it is XLA: each slot's whole
logical row gathered (`_paged_row_cache`, text_model.py:697-790) and
masked attention over [row ; chunk]. The kernel's visibility rule gives
that function row by row: the verify's entries are written into the pool
first, its [B, S] queries are flattened to B·S rows, and row (b, i) reads
slot b's table at frontier pos[b] + i, so it sees the committed row and
drafts 0..i (causal among the drafts). Each flattened row reads its
slot's live blocks, about S times the unique bytes of a decode call.
"""
from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass

import torch

from ..models.common.cache import paged_gather_layer
from .attention import make_attention_mask, multi_head_attention

REPLACES = ("cake_tpu/models/common/cache.py:383 paged_gather_layer + "
            "cake_tpu/ops/attention.py:40 multi_head_attention "
            "(XLA in the reference)")
VERIFY_REPLACES = ("cake_tpu/models/common/text_model.py:697-790 "
                   "_spec_slots_paged: _paged_row_cache + masked attention "
                   "over [row ; chunk] (XLA in the reference)")
LIBRARY = "paged_decode"
SOURCE = "cake_tpu_torch/csrc/paged_decode.cu"
ROUTES = {torch.bfloat16: "bf16", torch.float16: "f16",
          torch.float32: "f32"}
ELEMENT_BYTES = {"bf16": 2, "f16": 2, "f32": 4}
# the C entry's dtype argument (0 and 1 as before the f16 route: float32
# and bfloat16)
DTYPE_CODES = {"f32": 0, "bf16": 1, "f16": 2}
MAX_GROUP = 8             # query heads per KV head (MAX_G there)
_HEAD_DIMS = (64, 128, 256)   # one instantiation each, no other

# The kernel's constants (csrc/paged_decode.cu)
CLUSTER = 8               # CTAs per (row, KV head): the portable cluster
CONSUMER_WARPS = 4        # NW; one producer warp besides
THREADS = 32 * (CONSUMER_WARPS + 1)
STEP_KEYS = 4             # keys a consumer warp takes per step
MAX_STAGES = 4            # ring depth the plan takes at most
# CTAs per SM the ring must leave room for: a cluster's 8 CTAs go to one
# GPC, and at 2 per SM an H100 held 30 of the flagship's 32 clusters at
# once, at 3 per SM 45 (PERF.md)
MIN_CTAS_PER_SM = 3
SMEM_LIMIT = 232448       # bytes one block may use on an H100
SM_SMEM = 233472          # shared memory per SM (228 KB)
CTA_RESERVED = 1024       # shared memory the card keeps per resident CTA


def _align128(x: int) -> int:
    return (x + 127) // 128 * 128


@dataclass(frozen=True)
class PagedPlan:
    """Launch plan of csrc/paged_decode.cu for one call: grid (cluster,
    Hkv, B) in clusters of `cluster` CTAs along x. Rank r of the cluster
    of (row b, KV head) walks the row's live page blocks r, r + cluster,
    ... in ascending order; rank 0 merges the ranks in order 0..cluster-1.
    Which blocks a rank takes depends on the row's own frontier alone."""
    route: str
    batch: int
    hkv: int
    group: int
    d: int
    bt: int
    max_blocks: int
    cluster: int = CLUSTER

    @property
    def stage_bytes(self) -> int:
        """One ring stage: a K box, a V box (bt x D each) and bt positions."""
        return (2 * _align128(self.bt * self.d * ELEMENT_BYTES[self.route])
                + _align128(self.bt * 4))

    def _smem(self, stages: int) -> int:
        """The kernel's smem_layout: the ring, its barriers and flags, the
        warps' states, the cluster's slots, 128 bytes to align the base."""
        per_state = self.group * (self.d + 2) * 4
        return (stages * self.stage_bytes + _align128(stages * 20)
                + _align128(CONSUMER_WARPS * per_state)
                + self.cluster * per_state + 128)

    def _ctas_per_sm(self, stages: int) -> int:
        return min(SM_SMEM // (self._smem(stages) + CTA_RESERVED),
                   2048 // THREADS)

    @property
    def stages(self) -> int:
        """The deepest ring, up to MAX_STAGES, that leaves room for
        MIN_CTAS_PER_SM CTAs per SM; 2 at least."""
        for n in range(MAX_STAGES, 2, -1):
            if self._ctas_per_sm(n) >= MIN_CTAS_PER_SM:
                return n
        return 2

    @property
    def smem_bytes(self) -> int:
        """Dynamic shared memory per CTA."""
        return self._smem(self.stages)

    @property
    def grid(self) -> tuple[int, int, int]:
        return (self.cluster, self.hkv, self.batch)

    @property
    def ctas_per_sm(self) -> int:
        """CTAs that fit on one SM by shared memory and threads."""
        return self._ctas_per_sm(self.stages)

    def live_blocks(self, p: int) -> int:
        """Table entries a row at frontier p reads: keys 0..p, cut at the
        row's end."""
        keys = 0 if p < 0 else min(p + 1, self.max_blocks * self.bt)
        return -(-keys // self.bt)

    def rank_blocks(self, rank: int, p: int) -> list[int]:
        """The table entries rank `rank` walks, in order."""
        return list(range(rank, self.live_blocks(p), self.cluster))

    def empty_ranks(self, p: int) -> list[int]:
        """Ranks with no block: they contribute the empty state."""
        return [r for r in range(self.cluster) if not self.rank_blocks(r, p)]


@functools.lru_cache(maxsize=64)
def _plan(route, batch, hkv, group, d, bt, max_blocks) -> PagedPlan:
    return PagedPlan(route, batch, hkv, group, d, bt, max_blocks)


def plan_paged(q_shape, k_shape, tables_shape, dtype) -> PagedPlan:
    """The kernel's plan for q [B, 1, Hq, D], a pool [NB + 1, bt, Hkv, D]
    and tables [B, M]. Raises ValueError on a block size the kernel does
    not take (a multiple of STEP_KEYS, at most 256: one TMA box) and on a
    block whose two-stage ring does not fit a block's shared memory
    (float32 at bt 64, D 256)."""
    b, _, hq, d = q_shape
    bt, hkv = k_shape[1], k_shape[2]
    if bt % STEP_KEYS or not 0 < bt <= 256:
        raise ValueError(f"paged decode kernel takes a block of a multiple "
                         f"of {STEP_KEYS} tokens up to 256, got {bt}")
    plan = _plan(kernel_route(dtype), b, hkv, hq // hkv, d, bt,
                 tables_shape[1])
    if plan.smem_bytes > SMEM_LIMIT:
        raise ValueError(f"paged decode kernel: blocks of {bt} tokens at "
                         f"D {d} ({plan.route}) need {plan.smem_bytes} "
                         f"bytes of shared memory with 2 stages, more than "
                         f"the {SMEM_LIMIT} a block may use")
    return plan


def paged_decode_attention_ref(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, pos: torch.Tensor,
                               tables: torch.Tensor, frontier: torch.Tensor,
                               scale: float | None = None) -> torch.Tensor:
    """Plain version: the reference's arithmetic. Gather every row's whole
    logical view through its table, mask it, and attend with float32
    scores and probabilities cast to the value dtype. The reference gathers
    with frontier p and then writes the step's entry at p; here the entry
    is already in the pool, so the gather takes frontier p + 1, which
    yields the same view."""
    view = paged_gather_layer({"k": k, "v": v, "pos": pos}, tables,
                              frontier + 1)
    mask = make_attention_mask(frontier[:, None].to(view["pos"].dtype),
                               view["pos"])
    return multi_head_attention(q, view["k"], view["v"], mask, scale)


def kernel_route(dtype: torch.dtype) -> str:
    route = ROUTES.get(dtype)
    if route is None:
        raise ValueError(f"paged decode kernel takes float32, bfloat16 or "
                         f"float16, "
                         f"got {dtype}")
    return route


def check_head_dim(d: int) -> None:
    """Raise ValueError on a head dimension the kernel was not built for."""
    if d not in _HEAD_DIMS:
        raise ValueError(f"paged decode kernel takes head_dim in "
                         f"{_HEAD_DIMS}, got {d}")


def _check_kernel_inputs(q, k, v, pos, tables, frontier) -> None:
    for name, x in (("q", q), ("k", k), ("v", v), ("pos", pos),
                    ("tables", tables), ("frontier", frontier)):
        if x.device.type != "cuda" or x.device != q.device:
            raise ValueError(f"paged decode kernel: {name} is on "
                             f"{x.device}, not on q's CUDA device")
        if not x.is_contiguous():
            raise ValueError(f"paged decode kernel: {name} is not "
                             "contiguous")
    for name, x in (("q", q), ("k", k), ("v", v), ("pos", pos)):
        if x.data_ptr() % 16:
            raise ValueError(f"paged decode kernel: {name} is not 16-byte "
                             "aligned (TMA and 16-byte loads)")
    kernel_route(q.dtype)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("paged decode kernel: q, k and v must share a "
                         "dtype")
    for name, x in (("pos", pos), ("tables", tables),
                    ("frontier", frontier)):
        if x.dtype != torch.int32:
            raise ValueError(f"paged decode kernel: {name} must be int32")
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"paged decode kernel: q must be [B, 1, Hq, D], "
                         f"got {tuple(q.shape)}")
    b, _, hq, d = q.shape
    check_head_dim(d)
    if k.dim() != 4 or k.shape != v.shape or k.shape[3] != d:
        raise ValueError(f"paged decode kernel: k {tuple(k.shape)} / v "
                         f"{tuple(v.shape)} do not fit q {tuple(q.shape)}")
    hkv = k.shape[2]
    if hq % hkv or hq // hkv > MAX_GROUP:
        raise ValueError(f"paged decode kernel: Hq {hq} must be a multiple "
                         f"of Hkv {hkv}, at most {MAX_GROUP} times it")
    if tuple(pos.shape) != tuple(k.shape[:2]) or k.shape[0] < 2:
        raise ValueError(f"paged decode kernel: pos {tuple(pos.shape)} does "
                         f"not fit the pool {tuple(k.shape)} (a block and "
                         "the sink at least)")
    if tables.dim() != 2 or tables.shape[0] != b or \
            tuple(frontier.shape) != (b,):
        raise ValueError(f"paged decode kernel: tables {tuple(tables.shape)}"
                         f" / frontier {tuple(frontier.shape)} do not fit "
                         f"batch {b}")


def _raise_on(err: int) -> None:
    if err:
        raise RuntimeError(f"paged decode kernel launch failed: CUDA error "
                           f"{err}")


def _kernel_args(q, k, v, pos, tables, frontier, out, scale, plan):
    b, _, hq, d = q.shape
    nb1, bt, hkv, _ = k.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
            tables.data_ptr(), frontier.data_ptr(), out.data_ptr(), b,
            tables.shape[1], bt, nb1 - 1, hq, hkv, d, plan.cluster,
            plan.stages, plan.smem_bytes, float(scale) * math.log2(math.e),
            DTYPE_CODES[kernel_route(q.dtype)], stream)


def paged_decode_attention_kernel(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, pos: torch.Tensor,
                                  tables: torch.Tensor, frontier: torch.Tensor,
                                  scale: float | None = None) -> torch.Tensor:
    """Launch the kernel (no launch count: callers that compare it with the
    plain version use this entry). One launch, one output allocation.
    Raises on what it does not take."""
    _check_kernel_inputs(q, k, v, pos, tables, frontier)
    plan = plan_paged(q.shape, k.shape, tables.shape, q.dtype)
    from ..kernels.build import load_library
    lib = load_library(LIBRARY, _bind)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        _raise_on(lib.cake_paged_decode_fwd(*_kernel_args(
            q, k, v, pos, tables, frontier, out, scale, plan)))
    return out


def active_clusters(q, k, v, pos, tables, frontier) -> int:
    """How many clusters of this call's launch can be resident on the card
    at once (cudaOccupancyMaxActiveClusters); launches nothing."""
    _check_kernel_inputs(q, k, v, pos, tables, frontier)
    plan = plan_paged(q.shape, k.shape, tables.shape, q.dtype)
    from ..kernels.build import load_library
    lib = load_library(LIBRARY, _bind)
    n = ctypes.c_int(0)
    with torch.cuda.device(q.device):
        _raise_on(lib.cake_paged_decode_clusters(*_kernel_args(
            q, k, v, pos, tables, frontier, q, None, plan), ctypes.byref(n)))
    return n.value


def paged_decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           pos: torch.Tensor, tables: torch.Tensor,
                           frontier: torch.Tensor,
                           scale: float | None = None) -> torch.Tensor:
    """On CUDA tensors, launch the kernel of q's dtype route and count it in
    `paged_decode_attention.launches[route]`; on CPU tensors compute the
    plain version."""
    if q.device.type == "cpu":
        return paged_decode_attention_ref(q, k, v, pos, tables, frontier,
                                          scale)
    out = paged_decode_attention_kernel(q, k, v, pos, tables, frontier,
                                        scale)
    paged_decode_attention.launches[kernel_route(q.dtype)] += 1
    return out


paged_decode_attention.launches = {route: 0 for route in ROUTES.values()}


def verify_rows(tables: torch.Tensor, frontier: torch.Tensor,
                s: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The flattened rows of a verify over S queries per slot: [B·S, M]
    int32 tables (row b·S + i is slot b's table row) and [B·S] int32
    frontiers (frontier[b] + i). Fixed shapes and no host sync, so a
    captured graph replays it."""
    b, m = tables.shape
    rows = tables[:, None, :].expand(b, s, m).reshape(b * s, m)
    front = (frontier.to(torch.int32)[:, None]
             + torch.arange(s, dtype=torch.int32,
                            device=frontier.device)[None, :]).reshape(-1)
    return rows.contiguous(), front


def paged_verify_attention_ref(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, pos: torch.Tensor,
                               tables: torch.Tensor, frontier: torch.Tensor,
                               scale: float | None = None) -> torch.Tensor:
    """Plain version: the reference's paged verify attention. Gather each
    slot's whole logical row (every entry of the verify already written,
    so frontier pos + S), mask it causally at query positions pos[b] + i,
    attend with float32 scores. q: [B, S, Hq, D]."""
    s = q.shape[1]
    view = paged_gather_layer({"k": k, "v": v, "pos": pos}, tables,
                              frontier + s)
    q_pos = (frontier[:, None].long()
             + torch.arange(s, device=q.device)[None, :])
    mask = make_attention_mask(q_pos.to(view["pos"].dtype), view["pos"])
    return multi_head_attention(q, view["k"], view["v"], mask, scale)


def paged_verify_attention_kernel(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, pos: torch.Tensor,
                                  tables: torch.Tensor,
                                  frontier: torch.Tensor,
                                  scale: float | None = None) -> torch.Tensor:
    """The verify on the kernel, uncounted (callers that compare it with
    the plain version use this entry): the flattened rows, one launch of
    the paged decode kernel, the output back to [B, S, Hq, D]. Raises on
    what the kernel does not take."""
    b, s, hq, d = q.shape
    rows, front = verify_rows(tables, frontier, s)
    out = paged_decode_attention_kernel(q.reshape(b * s, 1, hq, d), k, v,
                                        pos, rows, front, scale)
    return out.reshape(b, s, hq, d)


def paged_verify_attention(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, pos: torch.Tensor,
                           tables: torch.Tensor, frontier: torch.Tensor,
                           scale: float | None = None) -> torch.Tensor:
    """The verify's attention, q [B, S, Hq, D] at positions frontier[b] +
    i, over the pool the verify's entries were written into. On CUDA
    tensors, one launch of the paged decode kernel over the B·S flattened
    rows (verify_rows), counted in `paged_verify_attention.launches[route]`
    (not in paged_decode_attention's); on CPU tensors the plain version."""
    if q.device.type == "cpu":
        return paged_verify_attention_ref(q, k, v, pos, tables, frontier,
                                          scale)
    out = paged_verify_attention_kernel(q, k, v, pos, tables, frontier,
                                        scale)
    paged_verify_attention.launches[kernel_route(q.dtype)] += 1
    return out


paged_verify_attention.launches = {route: 0 for route in ROUTES.values()}


def launch_counts() -> dict:
    """A copy of the decode wrapper's launch counts, {route: n}."""
    return dict(paged_decode_attention.launches)


def verify_launch_counts() -> dict:
    """A copy of the verify wrapper's launch counts, {route: n}."""
    return dict(paged_verify_attention.launches)


def reset_launches() -> None:
    """Zero both wrappers' launch counts."""
    for counts in (paged_decode_attention.launches,
                   paged_verify_attention.launches):
        for route in counts:
            counts[route] = 0


def _bind(lib: ctypes.CDLL) -> None:
    """Declare the entry points' signatures (pointers and the stream as
    c_void_p, so ctypes never truncates them to 32 bits)."""
    p, i = ctypes.c_void_p, ctypes.c_int
    args = [p] * 7 + [i] * 10 + [ctypes.c_float, i, p]
    lib.cake_paged_decode_fwd.argtypes = args
    lib.cake_paged_decode_fwd.restype = i
    lib.cake_paged_decode_clusters.argtypes = args + [ctypes.POINTER(i)]
    lib.cake_paged_decode_clusters.restype = i
