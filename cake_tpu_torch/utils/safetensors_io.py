"""Safetensors reading and writing in plain Python and torch (counterpart
of cake_tpu/utils/safetensors_io.py: read_header, index_file,
TensorStorage, layer_of, save_safetensors).

A file is an 8-byte little-endian header length, a JSON header
{name: {dtype, shape, data_offsets}} and the raw little-endian tensor
bytes. The reader maps each file once (`mmap`, copy-on-write so that
`torch.frombuffer` gets a writable buffer and the file is never written)
and views a tensor's bytes in its stored dtype: bfloat16 stays bfloat16,
with no float32 detour on the host. `read(name, device, dtype)` copies
that one tensor to the device and casts it there, so the host holds about
one tensor at a time beyond the page cache.

`F8_E4M3` tensors (FP8 checkpoints' weights) read as
torch.float8_e4m3fn and are written back as such; `F8_E5M2`, which the
reference's table lacks, is refused.
"""
from __future__ import annotations

import json
import mmap
import os
import struct
from dataclasses import dataclass

import torch

# safetensors header dtype -> torch dtype
DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool, "F8_E4M3": torch.float8_e4m3fn,
}
REFUSED = ("F8_E5M2",)
NAMES = {v: k for k, v in DTYPES.items()}
MAX_HEADER = 100 * 1024 * 1024   # bytes; a larger length is a corrupt file


@dataclass(frozen=True)
class TensorRecord:
    file: str
    dtype: str            # safetensors dtype name ("BF16", ...)
    shape: tuple[int, ...]
    start: int            # absolute byte offset in the file
    end: int

    @property
    def nbytes(self) -> int:
        return self.end - self.start


def read_header(path: str) -> tuple[dict, int]:
    """(header dict, offset of the first data byte). Raises ValueError on a
    file too short for its header or a header that is not JSON."""
    with open(path, "rb") as f:
        raw = f.read(8)
        if len(raw) != 8:
            raise ValueError(f"{path}: not a safetensors file (no header)")
        n = struct.unpack("<Q", raw)[0]
        if n > MAX_HEADER:
            raise ValueError(f"{path}: header length {n} is not plausible")
        blob = f.read(n)
    if len(blob) != n:
        raise ValueError(f"{path}: truncated header ({len(blob)} of {n} "
                         "bytes)")
    try:
        header = json.loads(blob)
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ValueError(f"{path}: header is not JSON: {e}") from e
    if not isinstance(header, dict):
        raise ValueError(f"{path}: header is not a JSON object")
    return header, 8 + n


def index_file(path: str) -> dict[str, TensorRecord]:
    """name -> TensorRecord of one file, every record checked against the
    file's size and its dtype and shape."""
    header, base = read_header(path)
    size = os.path.getsize(path)
    out = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        dt = meta["dtype"]
        if dt in REFUSED:
            raise NotImplementedError(
                f"{path}: tensor {name} is {dt}, which is not read (FP8 "
                "checkpoints are read in F8_E4M3)")
        if dt not in DTYPES:
            raise ValueError(f"{path}: tensor {name} has unknown dtype {dt}")
        b, e = meta["data_offsets"]
        shape = tuple(int(x) for x in meta["shape"])
        numel = 1
        for x in shape:
            numel *= x
        if e - b != numel * DTYPES[dt].itemsize or b < 0 or e < b:
            raise ValueError(f"{path}: tensor {name}: offsets {b}..{e} do "
                             f"not hold {dt}{list(shape)}")
        if base + e > size:
            raise ValueError(f"{path}: truncated: tensor {name} ends at "
                             f"byte {base + e} of {size}")
        out[name] = TensorRecord(file=path, dtype=dt, shape=shape,
                                 start=base + b, end=base + e)
    return out


class TensorStorage:
    """name -> TensorRecord over one or many .safetensors files; reads one
    tensor at a time through a map of its file. Close it (or use it as a
    context manager) to drop the maps."""

    def __init__(self, records: dict[str, TensorRecord]):
        self.records = records
        self._maps: dict[str, mmap.mmap] = {}

    @classmethod
    def from_model_dir(cls, model_dir: str) -> "TensorStorage":
        """The shards of model.safetensors.index.json if there is one,
        else every *.safetensors file of the directory."""
        records: dict[str, TensorRecord] = {}
        idx = os.path.join(model_dir, "model.safetensors.index.json")
        if os.path.exists(idx):
            with open(idx) as f:
                weight_map = json.load(f)["weight_map"]
            files = sorted(set(weight_map.values()))
        else:
            files = sorted(f for f in os.listdir(model_dir)
                           if f.endswith(".safetensors"))
        for fname in files:
            records.update(index_file(os.path.join(model_dir, fname)))
        if not records:
            raise FileNotFoundError(f"no .safetensors files in {model_dir}")
        return cls(records)

    def __enter__(self) -> "TensorStorage":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def names(self):
        return self.records.keys()

    def __contains__(self, name) -> bool:
        return name in self.records

    def nbytes(self, name: str) -> int:
        """Stored bytes of one tensor."""
        return self.records[name].nbytes

    def _map(self, path: str) -> mmap.mmap:
        if path not in self._maps:
            with open(path, "rb") as f:
                self._maps[path] = mmap.mmap(f.fileno(), 0,
                                             access=mmap.ACCESS_COPY)
        return self._maps[path]

    def read(self, name: str, device="cpu",
             dtype: torch.dtype | None = None) -> torch.Tensor:
        """One tensor on `device`, cast there to `dtype` when it is a
        float tensor and dtype is given. The result owns its memory (it
        is never a view of the file's map)."""
        if name not in self.records:
            raise KeyError(f"tensor {name} is not in the checkpoint")
        r = self.records[name]
        dt = DTYPES[r.dtype]
        if r.nbytes == 0:
            t = torch.empty(r.shape, dtype=dt)
        elif r.start % dt.itemsize:
            # unaligned for its type (an odd-sized tensor before it): copy
            t = torch.frombuffer(bytearray(self._map(r.file)[r.start:r.end]),
                                 dtype=dt).reshape(r.shape)
        else:
            t = torch.frombuffer(self._map(r.file), dtype=dt,
                                 count=r.nbytes // dt.itemsize,
                                 offset=r.start).reshape(r.shape)
        t = t.to(device=device, copy=True)
        if dtype is not None and t.is_floating_point() and t.dtype != dtype:
            t = t.to(dtype)
        return t

    def close(self) -> None:
        for m in self._maps.values():
            m.close()
        self._maps.clear()


def layer_of(name: str, prefix: str = "model") -> int | None:
    """The decoder-layer index in a weight name, None for tensors outside
    the layers."""
    marker = ".layers."
    i = name.find(marker)
    if i < 0:
        return None
    head = name[i + len(marker):].split(".", 1)[0]
    return int(head) if head.isdigit() else None


def save_safetensors(path: str, tensors: dict[str, torch.Tensor],
                     metadata: dict | None = None) -> int:
    """Write `tensors` (any device, bfloat16 included) as one file, each
    tensor copied to the host as it is written. Returns the bytes of
    tensor data written."""
    header: dict = {}
    if metadata:
        header["__metadata__"] = metadata
    offset = 0
    for name, t in tensors.items():
        if t.dtype not in NAMES:
            raise ValueError(f"tensor {name}: dtype {t.dtype} cannot be "
                             "written")
        n = t.numel() * t.element_size()
        header[name] = {"dtype": NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    hjson = json.dumps(header).encode()
    hjson += b" " * ((-len(hjson)) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hjson)))
        f.write(hjson)
        for t in tensors.values():
            host = t.detach().to("cpu").contiguous()
            if host.numel():
                # reinterpret as bytes (numpy has no bfloat16), no copy
                f.write(host.reshape(-1).view(torch.uint8).numpy().data)
    return offset
