"""Seeded random weights drawn on their device (the image models' and text
encoders' initializers; the reference draws them with jax.random, whose
values the port cannot reproduce, so parity tests carry the reference's
weights across with utils/weights.py instead).

A "meta" device gives shape-only tensors: the loaders validate a
checkpoint against them without allocating anything.
"""
from __future__ import annotations

import torch

from ..ops.fp8 import FP8_MAX, scale_shape


def generator(seed: int, device) -> torch.Generator | None:
    dev = torch.device(device)
    if dev.type == "meta":
        return None
    return torch.Generator(device=dev).manual_seed(seed)


def normal(gen, shape, dtype, device, std: float = 0.02) -> torch.Tensor:
    """N(0, std^2) drawn in float32 on `device`, cast to dtype."""
    if gen is None:
        return torch.empty(shape, dtype=dtype, device="meta")
    return (torch.randn(shape, generator=gen, device=device) * std).to(dtype)


def fp8_normal(gen, shape, device, std: float = 0.02) -> dict:
    """A native FP8 weight {"fp8", "scale_inv"} of N(0, std^2) values with
    one per-tensor scale broadcast over the 128 x 128 grid (the layout of
    a ComfyUI scaled-FP8 export read natively)."""
    if gen is None:
        return {"fp8": torch.empty(shape, dtype=torch.float8_e4m3fn,
                                   device="meta"),
                "scale_inv": torch.empty(scale_shape(*shape),
                                         device="meta")}
    w = torch.randn(shape, generator=gen, device=device) * std
    s = w.abs().amax().clamp_min(1e-12) / FP8_MAX
    fp8 = (w / s).to(torch.float8_e4m3fn)
    return {"fp8": fp8, "scale_inv": s.reshape(1, 1).expand(
        scale_shape(*shape)).contiguous()}
