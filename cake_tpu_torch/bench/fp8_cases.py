"""Inputs of the FP8 dequant kernel's checks (chip_smoke.py phase 14(a),
tests/test_torch_fp8_card.py): the shapes the main path gives it and the
edge cases, each with seeded e4m3 bytes that hold every code (NaN, -0 and
the subnormals included) and positive float32 scales over five decades.

`dequant_bound_ms` is the least time an H100 could take for one call:
the bytes it must move (each e4m3 byte and scale read once, each output
written once) over 3.35 TB/s; its one multiply per value is far below
the card's float32 rate, so bytes bound it.
"""
from __future__ import annotations

import torch

from ..ops.fp8 import scale_shape

H100_HBM_BYTES_S = 3.35e12

# (name, O, I): the flagship's (Qwen3-0.6B) q_proj and gate/up_proj,
# Qwen3-8B's gate/up_proj and down_proj, cropped edge blocks and a tail
# of I not a multiple of 16, and a small one that holds every code
SHAPES = [("q_proj_0.6b", 2048, 1024), ("gate_proj_0.6b", 3072, 1024),
          ("gate_proj_8b", 12288, 4096), ("down_proj_8b", 4096, 12288),
          ("edge_200x300", 200, 300), ("tail_129x17", 129, 17),
          ("codes_2x128", 2, 128)]


# FLUX.1-dev's FP8 weights (the MMDiT at hidden 3072, 24 x 128 heads, MLP
# 12288): a double-stream block's qkv (and a single-stream block's
# modulation), modulation, projection, MLP in and out; a single-stream
# block's fused linear1 and linear2; the final modulation, txt_in, the
# pooled vector's MLP in, and the edges img_in and final_out, whose one
# scale block is cropped to 64
FLUX_SHAPES = [("flux_qkv", 9216, 3072), ("flux_mod", 18432, 3072),
               ("flux_proj", 3072, 3072), ("flux_mlp_in", 12288, 3072),
               ("flux_mlp_out", 3072, 12288), ("flux_linear1", 21504, 3072),
               ("flux_linear2", 3072, 15360), ("flux_final_mod", 6144, 3072),
               ("flux_txt_in", 3072, 4096), ("flux_vec_in", 3072, 768),
               ("flux_time_in", 3072, 256), ("flux_img_in", 3072, 64),
               ("flux_final_out", 64, 3072)]
FLUX_TIMED = ("flux_linear1", "flux_img_in", "flux_final_out")


def per_tensor_case(o: int, i: int, seed: int = 0, device="cuda"
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """fp8_case's bytes with ONE scale broadcast over the whole grid (a
    scaled-FP8 checkpoint read natively)."""
    w, s = fp8_case(o, i, seed, device)
    return w, s.reshape(-1)[:1].reshape(1, 1).expand(s.shape).contiguous()


def fp8_case(o: int, i: int, seed: int = 0, device="cuda"
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """(w float8_e4m3fn [O, I], scale_inv float32) drawn on the host from
    `seed`; the first min(256, O*I) bytes run through every code."""
    gen = torch.Generator().manual_seed(seed)
    raw = torch.randint(0, 256, (o * i,), dtype=torch.uint8, generator=gen)
    n = min(256, o * i)
    raw[:n] = torch.arange(n, dtype=torch.uint8)
    s = 10.0 ** (-5 * torch.rand(scale_shape(o, i), generator=gen))
    return (raw.view(torch.float8_e4m3fn).reshape(o, i).to(device),
            s.to(torch.float32).to(device))


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """NaN at the same places and every other value bit for bit (the NaN
    payloads of two roundings may differ)."""
    na, nb = torch.isnan(a), torch.isnan(b)
    ib = {torch.bfloat16: torch.int16, torch.float16: torch.int16,
          torch.float32: torch.int32}[a.dtype]
    return a.dtype == b.dtype and torch.equal(na, nb) and \
        torch.equal(a[~na].view(ib), b[~nb].view(ib))


def dequant_bytes(o: int, i: int, out_dtype: torch.dtype) -> int:
    so, si = scale_shape(o, i)
    return o * i * (1 + torch.finfo(out_dtype).bits // 8) + 4 * so * si


def dequant_bound_ms(o: int, i: int, out_dtype: torch.dtype) -> float:
    return dequant_bytes(o, i, out_dtype) / H100_HBM_BYTES_S * 1e3
