"""Flash prefill attention: a hand-written CUDA kernel for Hopper, with its
plain PyTorch version beside it.

Replaces `cake_tpu/ops/flash.py:_flash_kernel` (reached through
`flash_attention`, the repo's one Pallas kernel). Same function: causal GQA
attention in the [B, S, H, D] layout with an online-softmax float32
accumulator; a key is valid iff k_pos < q_offset + valid_len, causal
k_pos <= q_pos, optional sliding window k_pos > q_pos - window; GQA maps
query head h to kv head h // (Hq / Hkv); default scale 1/sqrt(D); output
in q's dtype. Query rows with no visible key are don't-care, as there.

What bounds it on an H100: at the flagship prefill chunk (Sq = 256,
Hq = 16, D = 128) the work is about 4 * Sq * Skv_visible * Hq * D FLOPs
against 989 TFLOP/s of bf16 tensor cores, and in append mode the K/V rows
it must read (q_offset + valid_len of the 4096-row slot) against
3.35 TB/s. Both are microseconds; this first kernel is far from either.

Design (csrc/flash_attn.cu), rethought rather than carried block by block:
  * the Pallas kernel maps a head's whole [Skv, D] K/V into VMEM; a 4096-row
    bf16 append row is 1 MB and no SM holds that, so the CUDA kernel
    streams 64-row K/V tiles through shared memory;
  * it takes the [B, S, H, D] tensors with their strides instead of
    transposing to [B*H, S, D], so append-mode K/V is a view of the KV pool
    row with no copy;
  * one block per (query tile of 32 rows, q_head, batch), no carry between
    blocks; the K-tile loop bounds reproduce the causal and window skips,
    and stop at the valid-key limit (fully masked tiles contribute exactly
    zero, so skipping them changes nothing);
  * float32 scores, running max and sum, plain FMA (no tensor cores yet:
    mma/wgmma and TMA come in a later PR).

The wrapper launches the kernel for CUDA tensors and raises on what it does
not take; it uses the plain version only for CPU tensors. There is no
fallback from one to the other.
"""
from __future__ import annotations

import ctypes

import torch

FLASH_MIN_SEQ = 256
NEG_INF = -1e30

SOURCE = "cake_tpu_torch/csrc/flash_attn.cu"
REPLACES = "cake_tpu/ops/flash.py:38"   # _flash_kernel (pl.pallas_call at :153)

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_HEAD_DIMS = (64, 128)


def _limits(s: int, valid_len, q_offset) -> tuple[int, int]:
    off = 0 if q_offset is None else int(q_offset)
    vl = s if valid_len is None else int(valid_len)
    return off, off + vl


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float | None = None, causal: bool = True,
                        valid_len=None, q_offset=None,
                        window: int | None = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel: masked dense attention in
    float32 with the kernel's masks. Keys at or past the limit are masked,
    so they are sliced off before the product."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    off, limit = _limits(s, valid_len, q_offset)
    t = max(min(limit, k.shape[1]), 1)
    k, v = k[:, :t], v[:, :t]
    q_pos = off + torch.arange(s, device=q.device)[:, None]
    k_pos = torch.arange(t, device=q.device)[None, :]
    mask = k_pos < limit
    if causal:
        mask = mask & (k_pos <= q_pos)
    if window is not None:
        mask = mask & (k_pos > q_pos - window)
    qf = q.float().reshape(b, s, hkv, g, d).permute(0, 2, 3, 1, 4) * scale
    kf = k.float().permute(0, 2, 1, 3)[:, :, None]          # [B,Hkv,1,T,D]
    vf = v.float().permute(0, 2, 1, 3)[:, :, None]
    scores = torch.matmul(qf, kf.transpose(-1, -2))         # [B,Hkv,G,S,T]
    scores = torch.where(mask, scores,
                         torch.full((), NEG_INF, device=q.device))
    out = torch.matmul(torch.softmax(scores, dim=-1), vf)   # [B,Hkv,G,S,D]
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, hq, d).to(q.dtype)


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
    if q.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"flash kernel takes float32 or bfloat16, "
                         f"got {q.dtype}")
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


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           scale: float | None = None, causal: bool = True,
                           valid_len=None, q_offset=None,
                           window: int | None = None) -> torch.Tensor:
    """Launch the CUDA kernel (no launch count: callers that compare it
    with its plain version use this entry). Raises on CPU tensors, on a
    dtype other than float32/bfloat16, on D outside {64, 128} and on a
    non-contiguous last dimension."""
    _check_kernel_inputs(q, k, v)
    from ..kernels.build import load_library
    lib = load_library("flash_attn", bind)
    b, s, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    off, limit = _limits(s, valid_len, q_offset)
    out = torch.empty((b, s, hq, d), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.cake_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _KERNEL_DTYPES[q.dtype], b, s, skv, hq, hkv, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3], float(scale), int(bool(causal)),
            0 if window is None else int(window), off, limit, stream)
    if err != 0:
        raise RuntimeError(f"flash kernel launch failed: CUDA error {err}")
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float | None = None, causal: bool = True,
                    valid_len=None, q_offset=None,
                    window: int | None = None) -> torch.Tensor:
    """q: [B, Sq, Hq, D]; k/v: [B, Skv, Hkv, D] (strided views allowed).

    valid_len: number of valid new keys (absolute limit q_offset +
    valid_len); q_offset: absolute position of query row 0 (append mode
    over an unwrapped cache row whose index is the position); window:
    sliding-window size. On CUDA tensors this launches the kernel and
    counts the launch in `flash_attention.launches` by mode ("fresh" when
    q_offset is 0/None, else "append"); on CPU tensors it computes the
    plain version."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, scale, causal, valid_len,
                                   q_offset, window)
    out = flash_attention_kernel(q, k, v, scale, causal, valid_len,
                                 q_offset, window)
    flash_attention.launches["append" if q_offset else "fresh"] += 1
    return out


flash_attention.launches = {"fresh": 0, "append": 0}


def reset_launches() -> None:
    for mode in flash_attention.launches:
        flash_attention.launches[mode] = 0


def bind(lib: ctypes.CDLL) -> None:
    """Declare the C entry point's signature (every pointer and the stream
    as c_void_p, so ctypes never truncates them to 32 bits)."""
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn = lib.cake_flash_attention_fwd
    fn.argtypes = ([p, p, p, p, i, i, i, i, i, i, i] + [ll] * 12
                   + [ctypes.c_float, i, i, i, i, p])
    fn.restype = i
