"""Wire dtype tags and tensor <-> wire bytes (counterpart of
cake_tpu/utils/dtypes.py: WIRE_DTYPES, WIRE_TAGS, to_numpy_bytes,
from_numpy_bytes; the dtype names are device.py's parse_dtype and the
safetensors names utils/safetensors_io.py's).

The tags are the cluster protocol's contract and are copied exactly: a
hidden state the port packs decodes in the JAX package and the other way
round. A tensor crosses as its raw little-endian bytes. bfloat16 goes
through its int16 bits and float8_e4m3fn through its uint8 bits, since
numpy has neither type without ml_dtypes (which the card's machine may
lack); the bytes are the same as the reference's.
"""
from __future__ import annotations

import torch

# Stable u8 wire tags. Never reorder: these are a protocol contract.
WIRE_DTYPES = {
    0: "float32",
    1: "float16",
    2: "bfloat16",
    3: "float64",
    4: "uint8",
    5: "uint32",
    6: "int64",
    7: "int32",
    8: "float8_e4m3fn",
    9: "int8",
    10: "int16",
    11: "uint16",
    12: "bool",
}
WIRE_TAGS = {v: k for k, v in WIRE_DTYPES.items()}

# canonical name -> torch dtype
TORCH_DTYPES = {
    "float32": torch.float32, "float16": torch.float16,
    "bfloat16": torch.bfloat16, "float64": torch.float64,
    "uint8": torch.uint8, "uint32": torch.uint32, "int64": torch.int64,
    "int32": torch.int32, "float8_e4m3fn": torch.float8_e4m3fn,
    "int8": torch.int8, "int16": torch.int16, "uint16": torch.uint16,
    "bool": torch.bool,
}
TORCH_NAMES = {v: k for k, v in TORCH_DTYPES.items()}

# a type numpy cannot hold without ml_dtypes -> the integer type of its bits
_BITS = {torch.bfloat16: torch.int16, torch.float8_e4m3fn: torch.uint8}


def wire_name(dtype: torch.dtype) -> str:
    """The canonical name of a torch dtype; ValueError for one the wire
    has no tag for."""
    name = TORCH_NAMES.get(dtype)
    if name is None:
        raise ValueError(f"unsupported wire dtype {dtype}")
    return name


def to_wire_bytes(t: torch.Tensor) -> bytes:
    """The tensor's raw little-endian bytes (copied to the host)."""
    t = t.detach().to("cpu").contiguous()
    if t.dtype in _BITS:
        t = t.view(_BITS[t.dtype])
    return t.numpy().tobytes()


def from_wire_bytes(data: bytes, name: str, shape) -> torch.Tensor:
    """Inverse of to_wire_bytes: a CPU tensor of the canonical `name`
    dtype and `shape` that owns its memory."""
    dt = TORCH_DTYPES[name]
    raw = torch.frombuffer(bytearray(data), dtype=_BITS.get(dt, dt)) \
        if len(data) else torch.empty(0, dtype=_BITS.get(dt, dt))
    if dt in _BITS:
        raw = raw.view(dt)
    return raw.reshape(tuple(shape))
