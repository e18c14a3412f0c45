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
float32 for the parity phase. Both on FMA: a decode row does about one
FLOP per byte it reads, so bytes bound it and tensor cores buy nothing.

The wrapper launches the kernel for CUDA tensors (checking device, dtype,
shapes and contiguity, and raising on anything else), and computes the
plain version only for CPU tensors. No host sync: p stays on the device.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..models.common.cache import paged_gather_layer
from .attention import make_attention_mask, multi_head_attention

REPLACES = ("cake_tpu/models/common/cache.py:383 paged_gather_layer + "
            "cake_tpu/ops/attention.py:40 multi_head_attention "
            "(XLA in the reference)")
LIBRARY = "paged_decode"
SOURCE = "cake_tpu_torch/csrc/paged_decode.cu"
ROUTES = {torch.bfloat16: "bf16", torch.float32: "f32"}
# keys per CTA by route (csrc/paged_decode.cu: NTILE x TK)
SPLIT_KEYS = {"bf16": 128, "f32": 64}
MAX_GROUP = 8             # query heads per KV head (MAX_G there)
_HEAD_DIMS = (64, 128)


def paged_splits(max_blocks: int, bt: int, route: str) -> int:
    """CTAs along a row's key range in the kernel's grid: the most any
    frontier needs. A row with frontier p uses the first
    live_splits(p, ...) of them."""
    return -(-max_blocks * bt // SPLIT_KEYS[route])


def live_splits(p: int, max_blocks: int, bt: int, route: str) -> int:
    """Key-range pieces the kernel computes and merges, in order, for a
    row at frontier p: set by p alone, never by the batch."""
    keys = 0 if p < 0 else min(p + 1, max_blocks * bt)
    return -(-keys // SPLIT_KEYS[route])


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
        raise ValueError(f"paged decode kernel takes float32 or bfloat16, "
                         f"got {dtype}")
    return route


def _check_kernel_inputs(q, k, v, pos, tables, frontier) -> None:
    for name, x in (("q", q), ("k", k), ("v", v), ("pos", pos),
                    ("tables", tables), ("frontier", frontier)):
        if x.device.type != "cuda" or x.device != q.device:
            raise ValueError(f"paged decode kernel: {name} is on "
                             f"{x.device}, not on q's CUDA device")
        if not x.is_contiguous():
            raise ValueError(f"paged decode kernel: {name} is not "
                             "contiguous")
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
    if d not in _HEAD_DIMS:
        raise ValueError(f"paged decode kernel takes head_dim in "
                         f"{_HEAD_DIMS}, got {d}")
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


def paged_decode_attention_kernel(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, pos: torch.Tensor,
                                  tables: torch.Tensor, frontier: torch.Tensor,
                                  scale: float | None = None) -> torch.Tensor:
    """Launch the kernel (no launch count: callers that compare it with the
    plain version use this entry). Raises on what it does not take."""
    _check_kernel_inputs(q, k, v, pos, tables, frontier)
    from ..kernels.build import load_library
    lib = load_library(LIBRARY, _bind)
    b, _, hq, d = q.shape
    nb1, bt, hkv, _ = k.shape
    m = tables.shape[1]
    splits = paged_splits(m, bt, kernel_route(q.dtype))
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    part_o = torch.empty((b, hq, splits, d), dtype=torch.float32,
                         device=q.device)
    part_ml = torch.empty((b, hq, splits, 2), dtype=torch.float32,
                          device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        _raise_on(lib.cake_paged_decode_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
            tables.data_ptr(), frontier.data_ptr(), out.data_ptr(),
            part_o.data_ptr(), part_ml.data_ptr(), b, m, bt, nb1 - 1, hq,
            hkv, d, splits, float(scale) * math.log2(math.e),
            int(q.dtype == torch.bfloat16), stream))
    return out


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


def launch_counts() -> dict:
    """A copy of the launch counts, {route: n}."""
    return dict(paged_decode_attention.launches)


def reset_launches() -> None:
    for route in paged_decode_attention.launches:
        paged_decode_attention.launches[route] = 0


def _bind(lib: ctypes.CDLL) -> None:
    """Declare the entry point's signature (pointers and the stream as
    c_void_p, so ctypes never truncates them to 32 bits)."""
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = lib.cake_paged_decode_fwd
    fn.argtypes = [p] * 9 + [i] * 8 + [ctypes.c_float, i, p]
    fn.restype = i
