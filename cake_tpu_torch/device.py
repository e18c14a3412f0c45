"""Device and dtype helpers (counterpart of cake_tpu/utils/dtypes.py).

The port's entry points default to the GPU. Asking for `cuda` on a host
without one raises: a silent fall back to the CPU would turn every timing
and every "ran on the card" claim into a CPU number.
"""
from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"

# The model dtypes the port supports: the flash kernel takes these three
# (the reference's bf16 | f16 | f32, cake_tpu/cli.py:27).
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}

# the reference's aliases of these (cake_tpu/utils/dtypes.py: parse_dtype)
_ALIASES = {"f32": "float32", "float": "float32", "bf16": "bfloat16",
            "f16": "float16", "half": "float16"}


def parse_dtype(s: str) -> torch.dtype:
    """Parse a user dtype string ("bf16", "float32", ...)."""
    name = s.lower().strip()
    name = _ALIASES.get(name, name)
    if name not in _DTYPES:
        raise ValueError(f"unsupported dtype {s!r}")
    return _DTYPES[name]


def resolve_device(device: str | torch.device | None) -> torch.device:
    """`None` means the default (`cuda`). A CUDA device that is not there
    raises instead of falling back to the CPU."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' explicitly to run on the CPU")
    return dev
