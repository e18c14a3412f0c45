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
  * float32 -> csrc/flash_attn.cu: plain FMA from shared memory, one block
    per (32-row query tile, head). TF32 tensor cores would break the
    float32 tolerance, and float32 is not the serving dtype.

What bounds it on an H100: at the flagship prefill chunk (Sq = 256,
Hq = 16, D = 128) the least time is set by bytes (q, o and the K/V rows
below the limit, once each, against 3.35 TB/s: about a microsecond); the
FLOPs against 989 TFLOP/s of bf16 tensor cores come second.

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
_KERNEL_HEAD_DIMS = (64, 128, 256)   # one instantiation each, no other

# the bf16 kernel's tiles (csrc/flash_attn_wgmma.cu: BM, BN)
BLOCK_ROWS = 64     # packed (query index, head) rows per CTA: one wgmma M
BLOCK_KEYS = 64     # keys per K/V tile
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


# -- launch plan of the bf16 kernel --------------------------------------------


@dataclass(frozen=True)
class FlashPlan:
    """Launch plan of csrc/flash_attn_wgmma.cu over one [B, Sq, Hq, D]
    query and its K/V. The grid is (ctas, Hkv, B); CTA x of KV head kvh
    owns `positions` query indices and all G heads of the group, packed
    as rows r = (index cta * positions + r // G, head kvh * G + r % G)."""
    sq: int
    group: int
    kv_len: int        # min(q_offset + valid_len, Skv)
    q_offset: int
    causal: bool
    window: int        # 0: none
    d: int             # head dimension: 64, 128 or 256

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

    def tile_range(self, cta: int) -> tuple[int, int]:
        """[lo, hi): the K/V tiles the CTA loads. Past hi every key is
        past kv_len or above the diagonal of its last query; below lo
        every key is outside the window of its first."""
        first, last = self._span(cta)
        hi_key = self.kv_len
        if self.causal:
            hi_key = min(hi_key, self.q_offset + last + 1)
        hi = -(-hi_key // BLOCK_KEYS) if hi_key > 0 else 0
        lo = 0
        if self.window > 0:
            start = self.q_offset + first - self.window + 1
            lo = start // BLOCK_KEYS if start > 0 else 0
        return lo, hi

    def tile_masked(self, cta: int, kt: int) -> bool:
        """Whether tile kt crosses the limit, the diagonal or the window
        edge for some row of the CTA (the kernel masks only those)."""
        first, last = self._span(cta)
        k0 = kt * BLOCK_KEYS
        full = (k0 + BLOCK_KEYS <= self.kv_len
                and (not self.causal
                     or k0 + BLOCK_KEYS - 1 <= self.q_offset + first)
                and (self.window <= 0
                     or k0 > self.q_offset + last - self.window))
        return not full


def plan_flash(q_shape, k_shape, causal: bool = True, valid_len=None,
               q_offset=None, window: int | None = None) -> FlashPlan:
    """The bf16 kernel's plan for q [B, Sq, Hq, D] and k [B, Skv, Hkv, D];
    raises ValueError on shapes the kernel does not take."""
    _, s, hq, d = q_shape
    skv, hkv = k_shape[1], k_shape[2]
    if d not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"flash kernel takes head_dim in "
                         f"{_KERNEL_HEAD_DIMS}, got {d}")
    if hkv <= 0 or hq % hkv:
        raise ValueError("flash kernel: Hq must be a multiple of Hkv")
    if hq // hkv > BLOCK_ROWS:
        raise ValueError(f"flash kernel: a GQA group of {hq // hkv} heads "
                         f"exceeds the {BLOCK_ROWS} rows of a CTA")
    off, limit = _limits(s, valid_len, q_offset)
    return FlashPlan(sq=s, group=hq // hkv, kv_len=min(limit, skv),
                     q_offset=off, causal=bool(causal),
                     window=0 if window is None else int(window), d=d)


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
    """The kernel route of a dtype: "bf16" (tensor cores) or "f32" (FMA).
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


def _launch_wgmma(q, k, v, scale, causal, valid_len, q_offset, window):
    plan = plan_flash(q.shape, k.shape, causal, valid_len, q_offset, window)
    b, s, hq, d = q.shape
    out = torch.empty((b, s, hq, d), dtype=q.dtype, device=q.device)
    strides = [st for x, name in ((q, "q"), (k, "k"), (v, "v"), (out, "out"))
               for st in tma_strides(x, name)]
    from ..kernels.build import load_library
    lib = load_library(LIBRARIES["bf16"], _bind_wgmma)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        _raise_on(lib.cake_flash_wgmma_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s,
            k.shape[1], hq, k.shape[2], d, *strides, plan.positions,
            plan.threads, plan.smem_bytes, scale * LOG2E, int(plan.causal), plan.window, plan.q_offset,
            plan.kv_len, stream))
    return out


def _launch_fma(q, k, v, scale, causal, valid_len, q_offset, window):
    from ..kernels.build import load_library
    lib = load_library(LIBRARIES["f32"], _bind_fma)
    b, s, hq, d = q.shape
    off, limit = _limits(s, valid_len, q_offset)
    out = torch.empty((b, s, hq, d), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        _raise_on(lib.cake_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s,
            k.shape[1], hq, k.shape[2], d, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], *out.stride()[:3], scale, int(causal),
            0 if window is None else int(window), off, limit, stream))
    return out


_LAUNCHERS = {"bf16": _launch_wgmma, "f32": _launch_fma}


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           scale: float | None = None, causal: bool = True,
                           valid_len=None, q_offset=None,
                           window: int | None = None) -> torch.Tensor:
    """Launch the kernel of q's route (no launch count: callers that
    compare a kernel with its plain version use this entry). Raises on
    CPU tensors, on a dtype other than float32/bfloat16, on D outside
    {64, 128, 256}, on a non-contiguous last dimension and, for bfloat16,
    on a view that breaks TMA's rules."""
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


def _bind_wgmma(lib: ctypes.CDLL) -> None:
    """Declare the bf16 entry point's signature (every pointer and the
    stream as c_void_p, so ctypes never truncates them to 32 bits)."""
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn = lib.cake_flash_wgmma_fwd
    fn.argtypes = ([p, p, p, p] + [i] * 6 + [ll] * 12
                   + [i, i, i, ctypes.c_float, i, i, i, i, p])
    fn.restype = i


def _bind_fma(lib: ctypes.CDLL) -> None:
    """Declare the float32 entry point's signature."""
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn = lib.cake_flash_attention_fwd
    fn.argtypes = ([p, p, p, p] + [i] * 6 + [ll] * 12
                   + [ctypes.c_float, i, i, i, i, p])
    fn.restype = i
