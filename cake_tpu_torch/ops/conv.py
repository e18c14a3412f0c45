"""Convolutions for the image VAEs and the audio stack (counterpart of
cake_tpu/ops/conv.py: conv2d, conv1d, conv_transpose1d,
depthwise_conv1d).

Layout: channels first, [B, C, H, W] / [B, C, T] with weights [Cout,
Cin/groups, K...], and a transposed convolution's weight [Cin, Cout, K]
(torch's convention), as the reference. The product is cuDNN's
(`F.conv2d` / `F.conv1d` / `F.conv_transpose1d`, with PyTorch's default
of TF32 products for float32 on the card), as XLA's was the reference's.
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


def conv1d(x: torch.Tensor, weight: torch.Tensor,
           bias: torch.Tensor | None = None, stride: int = 1,
           padding: int = 0, dilation: int = 1,
           groups: int = 1) -> torch.Tensor:
    """x: [B, Cin, T], weight: [Cout, Cin/groups, K]; symmetric padding."""
    y = F.conv1d(x, weight, None, stride, padding, dilation, groups)
    if bias is not None:
        y = y + bias[None, :, None]
    return y


def conv_transpose1d(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor | None = None, stride: int = 1,
                     padding: int = 0) -> torch.Tensor:
    """x: [B, Cin, T], weight: [Cin, Cout, K]; out_len = (T - 1) * stride
    + K - 2 * padding (`padding` cropped from both ends), torch's
    semantics, which the reference reproduces with a flipped kernel."""
    y = F.conv_transpose1d(x, weight, None, stride, padding)
    if bias is not None:
        y = y + bias[None, :, None]
    return y


def depthwise_conv1d(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor | None = None,
                     padding: int = 0) -> torch.Tensor:
    """x: [B, C, T], weight: [C, 1, K]: one filter per channel."""
    return conv1d(x, weight, bias, padding=padding, groups=x.shape[1])
