"""Flash prefill attention: two hand-written CUDA kernels for Hopper, one
per dtype route, with the plain PyTorch version beside them.

Replaces `cake_tpu/ops/flash.py:_flash_kernel` (reached through
`flash_attention`, the repo's one Pallas kernel). Same function: causal GQA
attention in the [B, S, H, D] layout with an online-softmax float32
accumulator; a key is valid iff k_pos < q_offset + valid_len, causal
k_pos <= q_pos, optional sliding window k_pos > q_pos - window; GQA maps
query head h to kv head h // (Hq / Hkv); default scale 1/sqrt(D); output
in q's dtype. Query rows with no visible key are don't-care, as there.

Routes, chosen by dtype and nothing else:
  * bfloat16 (the serving dtype) -> csrc/flash_attn_wgmma.cu: wgmma tensor
    cores, a TMA ring of K/V tiles fed by a producer warp, packed GQA rows
    (one CTA per KV head and 64 (query, head) rows). Its launch plan is
    `FlashPlan` below, in Python so that the CPU tests reach it; the kernel
    computes the same row map, tile range and mask rule. Its views must
    obey TMA's rules (`tma_strides`), or the wrapper raises.
  * float32 -> csrc/flash_attn.cu: mma.sync TF32 tensor cores in 3xTF32
    (each operand split as hi + lo, each product taken as hi.hi + hi.lo +
    lo.hi with a float32 accumulator: float32 accuracy, which one TF32
    product lacks), packed GQA rows (one CTA per KV head and 16 packed
    (query, head) rows), four warps splitting the CTA's K/V tiles, each
    loading its own ring of tiles by TMA. Its plan is `F32FlashPlan`; its
    views obey the same TMA rules.

What bounds it on an H100: at the flagship prefill chunk (Sq = 256,
Hq = 16, D = 128) the least time is set by bytes (q, o and the K/V rows
below the limit, once each, against 3.35 TB/s: about a microsecond); the
FLOPs against 989 TFLOP/s of bf16 tensor cores come second. In float32
the FLOPs bound it: three TF32 products per float32-accurate product
against 495 TFLOP/s.

Both kernels take the [B, S, H, D] tensors with their strides instead of
transposing to [B*H, S, D], so append-mode K/V is a view of the KV pool
row with no copy, and both skip the K/V tiles wholly above the diagonal,
below the window or past the valid-key limit (a fully masked tile adds
exactly zero).

The wrapper launches the kernel of the tensor's route for CUDA tensors and
raises on what neither takes; it uses the plain version only for CPU
tensors. There is no fallback from one to another.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from dataclasses import dataclass

import torch

FLASH_MIN_SEQ = 256
NEG_INF = -1e30
LOG2E = math.log2(math.e)

REPLACES = "cake_tpu/ops/flash.py:38"   # _flash_kernel (pl.pallas_call at :153)

# dtype -> route; route -> kernel library and its source
ROUTES = {torch.bfloat16: "bf16", torch.float32: "f32"}
LIBRARIES = {"bf16": "flash_attn_wgmma", "f32": "flash_attn"}
SOURCES = {"bf16": "cake_tpu_torch/csrc/flash_attn_wgmma.cu",
           "f32": "cake_tpu_torch/csrc/flash_attn.cu"}
ENTRIES = {"bf16": "cake_flash_wgmma_fwd",
           "f32": "cake_flash_attention_fwd"}
_KERNEL_HEAD_DIMS = (64, 128, 256)   # one instantiation each, no other

# the bf16 kernel's tiles (csrc/flash_attn_wgmma.cu: BM, BN)
BLOCK_ROWS = 64     # packed (query index, head) rows per CTA: one wgmma M
BLOCK_KEYS = 64     # keys per K/V tile
# the f32 kernel's (csrc/flash_attn.cu: ROWS, NWARP, Layout<D>)
F32_ROWS = 16       # packed rows per CTA: one mma.sync M
F32_WARPS = 4       # warps of a CTA
# a cluster of 2 CTAs splits a row group's tiles where the grid leaves
# SMs idle and each warp would walk at least 4 tiles alone: the cluster's
# launch and merge cost more than a tile or two, and not every cluster of
# 4 is resident at once at D 256 (bench/flash_sweep.py,
# bench/flash_variants.py; PERF.md)
F32_SPLIT = 2
F32_SPLIT_MIN_TILES = 4 * F32_WARPS
TMA_ALIGN = 16      # bytes: TMA's alignment of a base address and a stride
SMEM_LIMIT = 232448   # bytes one block may use on an H100


def _limits(s: int, valid_len, q_offset) -> tuple[int, int]:
    off = 0 if q_offset is None else int(q_offset)
    vl = s if valid_len is None else int(valid_len)
    return off, off + vl


def visible_mask(sq: int, t: int, q_offset: int, limit: int,
                 causal: bool = True, window: int | None = None,
                 device=None) -> torch.Tensor:
    """[sq, t] bool: key index k is visible to query row i, whose position
    is q_offset + i."""
    q_pos = q_offset + torch.arange(sq, device=device)[:, None]
    k_pos = torch.arange(t, device=device)[None, :]
    mask = k_pos < limit
    if causal:
        mask = mask & (k_pos <= q_pos)
    if window is not None:
        mask = mask & (k_pos > q_pos - window)
    return mask.expand(sq, t)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float | None = None, causal: bool = True,
                        valid_len=None, q_offset=None,
                        window: int | None = None) -> torch.Tensor:
    """Plain PyTorch version of the kernels: masked dense attention in
    float32 with the kernels' masks. Keys at or past the limit are masked,
    so they are sliced off before the product."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    off, limit = _limits(s, valid_len, q_offset)
    t = max(min(limit, k.shape[1]), 1)
    k, v = k[:, :t], v[:, :t]
    mask = visible_mask(s, t, off, limit, causal, window, q.device)
    qf = q.float().reshape(b, s, hkv, g, d).permute(0, 2, 3, 1, 4) * scale
    kf = k.float().permute(0, 2, 1, 3)[:, :, None]          # [B,Hkv,1,T,D]
    vf = v.float().permute(0, 2, 1, 3)[:, :, None]
    scores = torch.matmul(qf, kf.transpose(-1, -2))         # [B,Hkv,G,S,T]
    scores = torch.where(mask, scores,
                         torch.full((), NEG_INF, device=q.device))
    out = torch.matmul(torch.softmax(scores, dim=-1), vf)   # [B,Hkv,G,S,D]
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, hq, d).to(q.dtype)


# -- launch plans -------------------------------------------------------------


@dataclass(frozen=True)
class _Plan:
    """What both kernels' plans share: one query [B, Sq, Hq, D] and its
    K/V, CTAs along x for each (KV head, batch row), the K/V tiles each
    CTA loads and which of those it masks. A route's plan says how its
    CTAs pack (query index, head) rows (`row`, `_span`) and how many keys
    a tile holds (`block_keys`)."""
    sq: int
    group: int
    kv_len: int        # min(q_offset + valid_len, Skv)
    q_offset: int
    causal: bool
    window: int        # 0: none
    d: int             # head dimension: 64, 128 or 256

    def tile_range(self, cta: int) -> tuple[int, int]:
        """[lo, hi): the K/V tiles the CTA loads. Past hi every key is
        past kv_len or above the diagonal of its last query; below lo
        every key is outside the window of its first."""
        first, last = self._span(cta)
        bk = self.block_keys
        hi_key = self.kv_len
        if self.causal:
            hi_key = min(hi_key, self.q_offset + last + 1)
        hi = -(-hi_key // bk) if hi_key > 0 else 0
        lo = 0
        if self.window > 0:
            start = self.q_offset + first - self.window + 1
            lo = start // bk if start > 0 else 0
        return lo, hi

    def tile_masked(self, cta: int, kt: int) -> bool:
        """Whether tile kt crosses the limit, the diagonal or the window
        edge for some row of the CTA (the kernel masks only those)."""
        first, last = self._span(cta)
        bk = self.block_keys
        k0 = kt * bk
        full = (k0 + bk <= self.kv_len
                and (not self.causal
                     or k0 + bk - 1 <= self.q_offset + first)
                and (self.window <= 0
                     or k0 > self.q_offset + last - self.window))
        return not full


@dataclass(frozen=True)
class FlashPlan(_Plan):
    """Launch plan of csrc/flash_attn_wgmma.cu (bf16). The grid is (ctas,
    Hkv, B); CTA x of KV head kvh owns `positions` query indices and all G
    heads of the group, packed as rows r = (index cta * positions + r //
    G, head kvh * G + r % G)."""

    rows = BLOCK_ROWS
    block_keys = BLOCK_KEYS

    @property
    def threads(self) -> int:
        """Threads per CTA (Layout<D>::THREADS): two consumer warpgroups
        and a producer warp, or at D = 256 a producer warpgroup, whose
        registers setmaxnreg hands to the consumers."""
        return 256 + (128 if self.d == 256 else 32)

    @property
    def stages(self) -> int:
        """Depth of the K/V ring (Layout<D>::NSTAGE): 4, or 2 at D = 256,
        where 4 slots of 32 KB K and V tiles exceed a block's shared
        memory."""
        return 2 if self.d == 256 else 4

    @property
    def smem_bytes(self) -> int:
        """Dynamic shared memory of one CTA (Layout<D>::ALLOC): Q, the
        ring, the warpgroup merge buffer (inside the drained ring at
        D = 256), the barriers, 1024 bytes to align the base."""
        q = BLOCK_ROWS * 2 * self.d
        ring = 2 * self.stages * BLOCK_KEYS * 2 * self.d
        merge = (self.d // 64 * 32 + 4) * 128 * 4
        bars = 8 * (1 + 3 * self.stages)
        return q + ring + (0 if self.d == 256 else merge) + bars + 1024

    @property
    def positions(self) -> int:
        return BLOCK_ROWS // self.group

    @property
    def ctas(self) -> int:
        return -(-self.sq // self.positions)

    def row(self, cta: int, r: int) -> tuple[int, int] | None:
        """(query index, head within the group) of packed row r, or None
        for a padding row (past Sq, or past positions * G)."""
        if r >= self.positions * self.group:
            return None
        i = cta * self.positions + r // self.group
        return (i, r % self.group) if i < self.sq else None

    def _span(self, cta: int) -> tuple[int, int]:
        first = cta * self.positions
        return first, min(first + self.positions, self.sq) - 1


@dataclass(frozen=True)
class F32FlashPlan(_Plan):
    """Launch plan of csrc/flash_attn.cu (float32, 3xTF32). Row group x
    of KV head kvh is the 16 packed rows R = 16x .. 16x + 15 of that
    head's Sq * G rows, row R being (query index R // G, head kvh * G +
    R % G): any G fits, and only rows past Sq * G are padding. The grid is
    (ctas * split, Hkv, B): each row group is one CTA, or with split = 2 a
    cluster of two. Warp w of rank r walks the group's tiles
    `warp_tiles(cta, r, w)` through its own ring of `slots` K/V tile
    slots; rank 0 merges the ranks."""

    split: int = 1

    rows = F32_ROWS

    @property
    def tile_floats(self) -> int:
        """Floats in one K or V tile (Layout<D>::TILE_FLOATS): 16 KB at
        D 256, 8 KB below, where two CTAs share an SM."""
        return 4096 if self.d == 256 else 2048

    @property
    def block_keys(self) -> int:
        return self.tile_floats // self.d

    @property
    def slots(self) -> int:
        """K/V tile slots of each warp (Layout<D>::NSLOT)."""
        return 3 if self.d == 256 else 2

    @property
    def threads(self) -> int:
        return 32 * F32_WARPS

    @property
    def smem_bytes(self) -> int:
        """Dynamic shared memory of one CTA (Layout<D>::ALLOC): the warps'
        K/V slots (the merge buffer reuses them and Q once drained), Q's hi
        and lo fragments, a barrier per slot, 1024 bytes to align the
        base."""
        nslots = F32_WARPS * self.slots
        return (nslots * self.tile_floats * 4 + 2 * F32_ROWS * self.d * 4
                + 8 * nslots + 1024)

    @property
    def ctas(self) -> int:
        return -(-self.sq * self.group // F32_ROWS)

    def row(self, cta: int, r: int) -> tuple[int, int] | None:
        """(query index, head within the group) of packed row r of the
        CTA, or None past Sq * G."""
        packed = cta * F32_ROWS + r
        if packed >= self.sq * self.group:
            return None
        return packed // self.group, packed % self.group

    def _span(self, cta: int) -> tuple[int, int]:
        first = cta * F32_ROWS
        return (first // self.group,
                min((first + F32_ROWS - 1) // self.group, self.sq - 1))

    def warp_tiles(self, cta: int, rank: int, warp: int) -> range:
        """The tiles warp `warp` of cluster rank `rank` walks for row group
        `cta`: every (split * 4)-th tile of the group's range."""
        lo, hi = self.tile_range(cta)
        return range(lo + rank * F32_WARPS + warp, hi,
                     self.split * F32_WARPS)


PLANS = {"bf16": FlashPlan, "f32": F32FlashPlan}


def plan_flash(q_shape, k_shape, causal: bool = True, valid_len=None,
               q_offset=None, window: int | None = None,
               route: str = "bf16", sms: int | None = None) -> _Plan:
    """The plan of the route's kernel for q [B, Sq, Hq, D] and k [B, Skv,
    Hkv, D]; raises ValueError on shapes the kernel does not take. For
    f32, `sms` (the card's SM count) lets the plan split each row group
    over a cluster of 2 CTAs where twice the grid still fits the SMs and
    the last row group walks at least F32_SPLIT_MIN_TILES tiles; None
    keeps one CTA per row group."""
    batch, s, hq, d = q_shape
    skv, hkv = k_shape[1], k_shape[2]
    if d not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"flash kernel takes head_dim in "
                         f"{_KERNEL_HEAD_DIMS}, got {d}")
    if hkv <= 0 or hq % hkv:
        raise ValueError("flash kernel: Hq must be a multiple of Hkv")
    if route == "bf16" and hq // hkv > BLOCK_ROWS:
        raise ValueError(f"flash kernel: a GQA group of {hq // hkv} heads "
                         f"exceeds the {BLOCK_ROWS} rows of a CTA")
    off, limit = _limits(s, valid_len, q_offset)
    plan = PLANS[route](sq=s, group=hq // hkv, kv_len=min(limit, skv),
                        q_offset=off, causal=bool(causal),
                        window=0 if window is None else int(window), d=d)
    if route == "f32" and sms:
        lo, hi = plan.tile_range(plan.ctas - 1)
        if (plan.ctas * hkv * batch * F32_SPLIT <= sms
                and hi - lo >= F32_SPLIT_MIN_TILES):
            plan = dataclasses.replace(plan, split=F32_SPLIT)
    return plan


def tma_strides(x: torch.Tensor, name: str) -> tuple[int, int, int]:
    """Byte strides (head, seq, batch) of a [B, S, H, D] view as a TMA
    tensor map takes them. Raises ValueError where the view breaks TMA's
    rules: a last dimension that is not contiguous, or a base address or
    stride that is not a multiple of 16 bytes. The stride of a dimension
    of size 1 is never used, so a legal one stands in for it."""
    if x.dim() != 4 or x.stride(-1) != 1:
        raise ValueError(f"flash kernel: {name} must be [B, S, H, D] with "
                         "a contiguous last dimension")
    if x.data_ptr() % TMA_ALIGN:
        raise ValueError(f"flash kernel: {name}'s base address is not "
                         f"{TMA_ALIGN}-byte aligned (TMA)")
    el = x.element_size()
    b, s, h, d = x.shape
    sb, ss, sh = (st * el for st in x.stride()[:3])
    if h == 1:
        sh = d * el
    if s == 1:
        ss = h * sh
    if b == 1:
        sb = s * ss
    for dim, st in (("head", sh), ("seq", ss), ("batch", sb)):
        if st <= 0 or st % TMA_ALIGN:
            raise ValueError(f"flash kernel: {name}'s {dim} stride of {st} "
                             f"bytes is not a positive multiple of "
                             f"{TMA_ALIGN} (TMA)")
    return sh, ss, sb


# -- kernels ---------------------------------------------------------------


def kernel_route(dtype: torch.dtype) -> str:
    """The kernel route of a dtype: "bf16" or "f32" (both on the tensor
    cores; f32 in 3xTF32).
    Raises ValueError on any other dtype: no kernel takes it."""
    route = ROUTES.get(dtype)
    if route is None:
        raise ValueError(f"flash kernel takes float32 or bfloat16, "
                         f"got {dtype}")
    return route


def _check_kernel_inputs(q, k, v):
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device.type != "cuda":
            raise ValueError(f"flash kernel: {name} is on {x.device}, "
                             "not a CUDA device")
        if x.dim() != 4:
            raise ValueError(f"flash kernel: {name} must be [B, S, H, D]")
        if x.stride(-1) != 1:
            raise ValueError(f"flash kernel: {name}'s last dimension is "
                             "not contiguous")
        if x.dtype != q.dtype:
            raise ValueError("flash kernel: q, k and v must share a dtype")
    b, _, hq, d = q.shape
    if d not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"flash kernel takes head_dim in "
                         f"{_KERNEL_HEAD_DIMS}, got {d}")
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"flash kernel: k {tuple(k.shape)} / v "
                         f"{tuple(v.shape)} do not fit q {tuple(q.shape)}")
    if hq % k.shape[2]:
        raise ValueError("flash kernel: Hq must be a multiple of Hkv")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError("flash kernel: q, k and v on different devices")


def _raise_on(err: int) -> None:
    if err == 0:
        return
    if err == 20000:
        raise RuntimeError("flash kernel: the driver has no "
                           "cuTensorMapEncodeTiled")
    if err >= 30000:
        raise RuntimeError(f"flash kernel: the driver refused a tensor map "
                           f"(CUresult {err - 30000})")
    raise RuntimeError(f"flash kernel launch failed: CUDA error {err}")


@functools.lru_cache(maxsize=None)
def _sm_count(index) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launch(route, q, k, v, scale, causal, valid_len, q_offset, window):
    """Plan, check the views against TMA's rules, and launch the route's
    kernel on q's current stream."""
    plan = plan_flash(q.shape, k.shape, causal, valid_len, q_offset, window,
                      route=route, sms=_sm_count(q.device.index))
    b, s, hq, d = q.shape
    out = torch.empty((b, s, hq, d), dtype=q.dtype, device=q.device)
    strides = [st for x, name in ((q, "q"), (k, "k"), (v, "v"), (out, "out"))
               for st in tma_strides(x, name)]
    from ..kernels.build import load_library
    lib = load_library(LIBRARIES[route], _BINDERS[route])
    entry = getattr(lib, ENTRIES[route])
    # the per-CTA arguments: query indices (bf16), or packed rows and the
    # cluster's split (f32)
    per_cta = ((plan.positions,) if route == "bf16"
               else (plan.rows, plan.split))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        _raise_on(entry(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s,
            k.shape[1], hq, k.shape[2], d, *strides, *per_cta, plan.threads,
            plan.smem_bytes, scale * LOG2E, int(plan.causal), plan.window,
            plan.q_offset, plan.kv_len, stream))
    return out


_LAUNCHERS = {route: functools.partial(_launch, route) for route in LIBRARIES}


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           scale: float | None = None, causal: bool = True,
                           valid_len=None, q_offset=None,
                           window: int | None = None) -> torch.Tensor:
    """Launch the kernel of q's route (no launch count: callers that
    compare a kernel with its plain version use this entry). Raises on
    CPU tensors, on a dtype other than float32/bfloat16, on D outside
    {64, 128, 256}, on a non-contiguous last dimension and on a view that
    breaks TMA's rules."""
    route = kernel_route(q.dtype)
    _check_kernel_inputs(q, k, v)
    if scale is None:
        scale = 1.0 / (q.shape[3] ** 0.5)
    return _LAUNCHERS[route](q, k, v, float(scale), bool(causal), valid_len,
                             q_offset, window)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float | None = None, causal: bool = True,
                    valid_len=None, q_offset=None,
                    window: int | None = None) -> torch.Tensor:
    """q: [B, Sq, Hq, D]; k/v: [B, Skv, Hkv, D] (strided views allowed).

    valid_len: number of valid new keys (absolute limit q_offset +
    valid_len); q_offset: absolute position of query row 0 (append mode
    over an unwrapped cache row whose index is the position); window:
    sliding-window size. On CUDA tensors this launches the kernel of the
    dtype's route and counts the launch in
    `flash_attention.launches[route][mode]` (mode "fresh" when q_offset
    is 0/None, else "append"); on CPU tensors it computes the plain
    version."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, scale, causal, valid_len,
                                   q_offset, window)
    out = flash_attention_kernel(q, k, v, scale, causal, valid_len,
                                 q_offset, window)
    mode = "append" if q_offset else "fresh"
    flash_attention.launches[kernel_route(q.dtype)][mode] += 1
    return out


flash_attention.launches = {route: {"fresh": 0, "append": 0}
                            for route in LIBRARIES}


def launch_counts() -> dict:
    """A copy of the launch counts, {route: {mode: n}}."""
    return {r: dict(m) for r, m in flash_attention.launches.items()}


def reset_launches() -> None:
    for modes in flash_attention.launches.values():
        for mode in modes:
            modes[mode] = 0


def _declare(fn, plan_ints: int) -> None:
    """Declare a flash entry point's signature: the routes differ only in
    the number of plan integers before the scale. Every pointer and the
    stream are c_void_p, so ctypes never truncates them to 32 bits."""
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = ([p, p, p, p] + [i] * 6 + [ll] * 12 + [i] * plan_ints
                   + [ctypes.c_float, i, i, i, i, p])
    fn.restype = i


def _bind_wgmma(lib: ctypes.CDLL) -> None:
    """Declare the bf16 entry point's signature (positions, threads,
    shared memory)."""
    _declare(lib.cake_flash_wgmma_fwd, 3)


def _bind_f32(lib: ctypes.CDLL) -> None:
    """Declare the float32 entry point's signature (rows, split, threads,
    shared memory)."""
    _declare(lib.cake_flash_attention_fwd, 4)


_BINDERS = {"bf16": _bind_wgmma, "f32": _bind_f32}
