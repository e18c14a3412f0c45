"""FP8 (e4m3) block-wise dequantization: a hand-written CUDA kernel for
Hopper, with the plain PyTorch version beside it (counterpart of
cake_tpu/ops/fp8.py: FP8_BLOCK, dequant_fp8_blockwise,
quant_fp8_blockwise).

An FP8 checkpoint stores each projection as w [O, I] float8_e4m3fn and a
per-128x128-block scale `weight_scale_inv` [ceil(O/128), ceil(I/128)]
float32; the weight is

    out[o, i] = RNE_out(float(w[o, i]) * scale_inv[o // 128, i // 128])

with the edge blocks cropped. Not a port of a TPU kernel: in the
reference this is XLA, a cast and a broadcast multiply that XLA fuses
into the consuming einsum (ops/linear.py:12-24), so the weight is never
written out. The kernel (csrc/fp8_dequant.cu) computes the same function
in one pass: each thread loads 16 fp8 values with one 16-byte load,
converts them exactly (e4m3 -> f16 -> f32), multiplies by its block's
scale in float32 and stores them rounded to nearest even in the output
type, so it gives the plain version's bits. It moves 1 byte in and 2 (bf16,
f16) or 4 (f32) bytes out per parameter: bytes bound it. A fused dequant-GEMM
(e4m3 into wgmma) that never writes the weight is later work (ROADMAP).

`dequant_fp8_blockwise` launches the kernel for CUDA tensors (checking
device, dtypes, shapes and contiguity, raising on anything else) and
counts the launch in `dequant_fp8_blockwise.launches[route]`, and by
the weight's shape in `.shape_launches[(O, I)]`; it computes the plain
version only for CPU tensors. No host sync, no host read: it
runs inside captured graphs.
"""
from __future__ import annotations

import collections
import ctypes

import torch
import torch.nn.functional as F

FP8_BLOCK = 128            # 128 x 128 blocks, one float32 scale each
FP8_MAX = 448.0            # e4m3's largest normal
REPLACES = ("cake_tpu/ops/fp8.py:17 dequant_fp8_blockwise, consumed at "
            "cake_tpu/ops/linear.py:12-24 (XLA in the reference)")
LIBRARY = "fp8_dequant"
SOURCE = "cake_tpu_torch/csrc/fp8_dequant.cu"
ROUTES = {torch.bfloat16: "bf16", torch.float16: "f16",
          torch.float32: "f32"}
OUT_KINDS = {"f32": 0, "bf16": 1, "f16": 2}   # the C entry's out_kind


def scale_shape(o: int, i: int, block: int = FP8_BLOCK) -> tuple[int, int]:
    return (-(-o // block), -(-i // block))


def dequant_fp8_blockwise_plain(w: torch.Tensor, scale_inv: torch.Tensor,
                                out_dtype: torch.dtype = torch.bfloat16,
                                block: int = FP8_BLOCK) -> torch.Tensor:
    """The plain version: w in float32, viewed as blocks (zero-padded to
    whole blocks) times each block's scale, cropped and cast."""
    o, i = w.shape
    nbo, nbi = scale_inv.shape
    if (nbo, nbi) != scale_shape(o, i, block):
        raise ValueError(f"scale_inv {tuple(scale_inv.shape)} does not fit "
                         f"weight {tuple(w.shape)} in blocks of {block}")
    wf = F.pad(w.float(), (0, nbi * block - i, 0, nbo * block - o))
    out = wf.view(nbo, block, nbi, block) * \
        scale_inv.float()[:, None, :, None]
    return out.view(nbo * block, nbi * block)[:o, :i].to(out_dtype)


def quant_fp8_blockwise(weight: torch.Tensor, block: int = FP8_BLOCK
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """(w float8_e4m3fn [O, I], scale_inv float32 [ceil(O/b), ceil(I/b)])
    with each block's largest magnitude at e4m3's 448: the reference's
    arithmetic step for step (for the checkpoint writer and the tests)."""
    o, i = weight.shape
    po, pi = (-o) % block, (-i) % block
    wp = F.pad(weight.float(), (0, pi, 0, po))
    blocks = wp.view((o + po) // block, block, (i + pi) // block,
                     block).permute(0, 2, 1, 3)
    amax = blocks.abs().amax(dim=(2, 3)).clamp_min(1e-12)
    # tensor over tensor: a rounded division (a scalar over a tensor
    # multiplies by a reciprocal and can miss it by an ulp)
    scale = torch.full_like(amax, FP8_MAX) / amax
    scale_inv = 1.0 / scale
    wq = (blocks * scale[:, :, None, None]).permute(0, 2, 1, 3)
    wq = wq.reshape(o + po, i + pi)[:o, :i]
    return wq.to(torch.float8_e4m3fn).contiguous(), scale_inv


def _check_kernel_inputs(w, scale_inv, out_dtype) -> None:
    if w.device.type != "cuda" or scale_inv.device != w.device:
        raise ValueError(f"fp8 dequant kernel: w on {w.device}, scale_inv "
                         f"on {scale_inv.device}; both must be on one card")
    if w.dtype != torch.float8_e4m3fn or scale_inv.dtype != torch.float32:
        raise ValueError(f"fp8 dequant kernel takes float8_e4m3fn weights "
                         f"and float32 scales, not {w.dtype} / "
                         f"{scale_inv.dtype}")
    if out_dtype not in ROUTES:
        raise ValueError(f"fp8 dequant kernel writes bfloat16, float16 or "
                         f"float32, "
                         f"not {out_dtype}")
    if w.dim() != 2 or tuple(scale_inv.shape) != scale_shape(*w.shape):
        raise ValueError(f"fp8 dequant kernel: weight {tuple(w.shape)} and "
                         f"scale_inv {tuple(scale_inv.shape)} do not fit "
                         f"blocks of {FP8_BLOCK}")
    if not (w.is_contiguous() and scale_inv.is_contiguous()):
        raise ValueError("fp8 dequant kernel takes contiguous tensors")
    if max(w.shape) >= 2 ** 31:
        raise ValueError(f"fp8 dequant kernel: {tuple(w.shape)} exceeds "
                         "its 32-bit extents")


def _raise_on(err: int) -> None:
    if err:
        raise RuntimeError(f"fp8 dequant kernel launch failed: CUDA error "
                           f"{err}")


def dequant_fp8_blockwise_kernel(w: torch.Tensor, scale_inv: torch.Tensor,
                                 out_dtype: torch.dtype = torch.bfloat16
                                 ) -> torch.Tensor:
    """Launch the kernel (no launch count: callers that compare it with
    the plain version use this entry). One launch, one output allocation.
    Raises on what it does not take."""
    _check_kernel_inputs(w, scale_inv, out_dtype)
    from ..kernels.build import load_library
    lib = load_library(LIBRARY, _bind)
    out = torch.empty(tuple(w.shape), dtype=out_dtype, device=w.device)
    if w.numel():
        stream = torch.cuda.current_stream(w.device).cuda_stream
        with torch.cuda.device(w.device):
            _raise_on(lib.cake_fp8_dequant(
                w.data_ptr(), scale_inv.data_ptr(), out.data_ptr(),
                w.shape[0], w.shape[1], OUT_KINDS[ROUTES[out_dtype]],
                stream))
    return out


def dequant_fp8_blockwise(w: torch.Tensor, scale_inv: torch.Tensor,
                          out_dtype: torch.dtype = torch.bfloat16
                          ) -> torch.Tensor:
    """On CUDA tensors, launch the kernel and count it in
    `dequant_fp8_blockwise.launches[route]` (route: the output dtype) and
    `.shape_launches[(O, I)]`; on CPU tensors compute the plain version."""
    if w.device.type == "cpu":
        return dequant_fp8_blockwise_plain(w, scale_inv, out_dtype)
    out = dequant_fp8_blockwise_kernel(w, scale_inv, out_dtype)
    dequant_fp8_blockwise.launches[ROUTES[out_dtype]] += 1
    dequant_fp8_blockwise.shape_launches[tuple(w.shape)] += 1
    return out


dequant_fp8_blockwise.launches = {route: 0 for route in ROUTES.values()}
dequant_fp8_blockwise.shape_launches = collections.Counter()


def launch_counts() -> dict:
    """A copy of the wrapper's launch counts, {route: n}."""
    return dict(dequant_fp8_blockwise.launches)


def shape_launch_counts() -> dict:
    """A copy of the wrapper's launch counts by weight shape, {(O, I): n}.
    Eager launches only: a captured graph's replays add to the route
    counts (models/common/graphs.py), not to these."""
    return dict(dequant_fp8_blockwise.shape_launches)


def reset_launches() -> None:
    for route in dequant_fp8_blockwise.launches:
        dequant_fp8_blockwise.launches[route] = 0
    dequant_fp8_blockwise.shape_launches.clear()


def is_fp8(weight) -> bool:
    """A native FP8 weight: {"fp8": e4m3 [O, I], "scale_inv": f32}, the
    reference's marker dict."""
    return isinstance(weight, dict) and "fp8" in weight


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.cake_fp8_dequant.argtypes = [p, p, p, i, i, i, p]
    lib.cake_fp8_dequant.restype = i
