"""2-D convolution for the image VAE (counterpart of cake_tpu/ops/conv.py:
conv2d; its conv1d and depthwise variants serve the audio stack, which is
not ported yet).

Layout: channels first, [B, C, H, W] with weights [Cout, Cin/groups, Kh,
Kw], as the reference. The product is cuDNN's (`F.conv2d`, with PyTorch's
default of TF32 products for float32 on the card), as XLA's was the
reference's.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _pairs(v) -> tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def conv2d(x: torch.Tensor, weight: torch.Tensor,
           bias: torch.Tensor | None = None, stride=1, padding=0,
           dilation=1, groups: int = 1) -> torch.Tensor:
    """x: [B, Cin, H, W], weight: [Cout, Cin/groups, Kh, Kw]. padding: an
    int, or [(top, bottom), (left, right)] as the reference takes it."""
    if not isinstance(padding, int):
        (t, b), (lft, r) = padding
        x = F.pad(x, (lft, r, t, b))
        padding = 0
    y = F.conv2d(x, weight, None, _pairs(stride), padding, _pairs(dilation),
                 groups)
    if bias is not None:
        y = y + bias[None, :, None, None]
    return y
