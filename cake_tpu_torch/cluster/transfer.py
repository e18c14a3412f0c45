"""Master -> worker weight streaming with CRC32 integrity, resume and a
content-keyed worker-side cache (counterpart of
cake_tpu/cluster/transfer.py: the same chunk messages, header and cache
layout, so either package's receiver takes the other's stream).

  * chunked streaming with a CRC32 per chunk, zstd level 1 gated by a
    compressibility probe on each chunk's first 4 KB;
  * the worker's cache keyed {cluster_hash}-{model_hash}, model_hash =
    sha256(config.json)[:8], validated before any re-transfer
    (has_valid_model_cache);
  * resume of a partial transfer from the bytes already received.

The master streams a synthesized safetensors file holding exactly the
worker's layer subset, built from the checkpoint's index without reading
the whole model.

zstandard is optional, behind the reference's own gate: without it a
sender sends every chunk uncompressed (CRC, resume and caching all still
work) and a receiver raises on a compressed chunk.
"""
from __future__ import annotations

import hashlib
import json
import os
import struct
from typing import Iterable, Iterator

try:
    import zstandard
except ImportError:
    # gated dependency: without zstd the stream is uncompressed; a
    # compressed chunk received without it is a protocol error
    zstandard = None

from ..utils.safetensors_io import TensorStorage, layer_of
from . import proto

CHUNK_SIZE = 8 * 1024 * 1024
PROBE_LEN = 4096


def model_hash(model_dir: str) -> str:
    with open(os.path.join(model_dir, "config.json"), "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()[:8]


def cache_key(cluster_key_hash: str, mhash: str) -> str:
    return f"{cluster_key_hash}-{mhash}"


def subset_tensor_names(storage: TensorStorage, start: int, end: int,
                        num_layers: int, include_embed: bool | None = None,
                        include_head: bool | None = None) -> list[str]:
    """The names a worker holding layers [start, end) needs."""
    if include_embed is None:
        include_embed = start == 0
    if include_head is None:
        include_head = end == num_layers
    names = []
    for name in storage.names():
        li = layer_of(name)
        if li is not None:
            if start <= li < end:
                names.append(name)
        elif "embed_tokens" in name:
            if include_embed or include_head:   # tied heads read the table
                names.append(name)
        elif include_head:
            names.append(name)
    return sorted(names)


def synthesize_safetensors(storage: TensorStorage, names: list[str],
                           chunk_size: int = CHUNK_SIZE
                           ) -> tuple[int, Iterator[bytes]]:
    """A valid safetensors byte stream of a tensor subset, built without
    holding it whole: (total size, chunk iterator)."""
    header: dict = {}
    offset = 0
    for n in names:
        r = storage.records[n]
        header[n] = {"dtype": r.dtype, "shape": list(r.shape),
                     "data_offsets": [offset, offset + r.nbytes]}
        offset += r.nbytes
    hjson = json.dumps(header).encode()
    hjson += b" " * ((-len(hjson)) % 8)
    total = 8 + len(hjson) + offset

    def gen() -> Iterator[bytes]:
        buf = bytearray(struct.pack("<Q", len(hjson)) + hjson)
        for n in names:
            buf += storage.read_bytes(n)
            view = memoryview(buf)
            off = 0
            while len(buf) - off >= chunk_size:
                yield bytes(view[off:off + chunk_size])
                off += chunk_size
            del view
            if off:
                buf = bytearray(buf[off:])
        if buf:
            yield bytes(buf)

    return total, gen()


def should_compress(sample: bytes) -> bool:
    """zstd only where it pays: probe the first 4 KB."""
    probe = sample[:PROBE_LEN]
    if not probe or zstandard is None:
        return False
    compressed = zstandard.ZstdCompressor(level=1).compress(probe)
    return len(compressed) < int(len(probe) * 0.9)


def encode_chunks(file_name: str, total: int, chunks: Iterable[bytes],
                  start_offset: int = 0) -> Iterator[dict]:
    """bytes chunks -> model_chunk messages, from start_offset on (the
    chunk stream always starts at file byte 0)."""
    cctx = zstandard.ZstdCompressor(level=1) if zstandard else None
    offset = 0
    n_total = max(1, (total + CHUNK_SIZE - 1) // CHUNK_SIZE)
    i = 0
    for chunk in chunks:
        if offset + len(chunk) <= start_offset:
            offset += len(chunk)       # resume: skip already-sent bytes
            continue
        if offset < start_offset:      # partial overlap
            chunk = chunk[start_offset - offset:]
            offset = start_offset
        compress = should_compress(chunk)
        data = cctx.compress(chunk) if compress else chunk
        yield proto.model_chunk(file_name, i, n_total, data,
                                proto.crc32(data), compress, offset)
        offset += len(chunk)
        i += 1


class ModelReceiver:
    """Worker-side chunk sink: checks each CRC, decompresses, writes into
    the content-keyed cache directory."""

    def __init__(self, cache_root: str, key: str):
        self.dir = os.path.join(cache_root, key)
        os.makedirs(self.dir, exist_ok=True)
        self._files: dict[str, object] = {}
        self._dctx = zstandard.ZstdDecompressor() if zstandard else None

    def path(self, file_name: str) -> str:
        return os.path.join(self.dir, os.path.basename(file_name))

    def resume_offset(self, file_name: str) -> int:
        """How many bytes are already here (partial-transfer resume)."""
        p = self.path(file_name) + ".part"
        return os.path.getsize(p) if os.path.exists(p) else 0

    def on_chunk(self, msg: dict):
        data = msg["d"]
        if proto.crc32(data) != msg["crc"]:
            raise proto.ProtocolError(
                f"CRC mismatch on {msg['file']} chunk {msg['i']}")
        if msg["z"]:
            if self._dctx is None:
                raise proto.ProtocolError(
                    "compressed chunk received but zstandard is unavailable")
            data = self._dctx.decompress(data, max_output_size=2 * CHUNK_SIZE)
        p = self.path(msg["file"]) + ".part"
        f = self._files.get(p)
        if f is None:
            f = open(p, "r+b" if os.path.exists(p) else "wb")
            self._files[p] = f
        f.seek(msg["off"])
        f.write(data)

    def finalize(self):
        for p, f in self._files.items():
            f.close()
            os.replace(p, p[:-len(".part")])
        self._files.clear()

    def write_json(self, name: str, obj: dict):
        with open(os.path.join(self.dir, name), "w") as f:
            json.dump(obj, f)


def has_valid_model_cache(cache_root: str, key: str,
                          expected: dict[str, int]) -> bool:
    """expected: file name -> exact byte size, checked against the cached
    files before any re-transfer."""
    d = os.path.join(cache_root, key)
    for name, size in expected.items():
        p = os.path.join(d, os.path.basename(name))
        if not os.path.exists(p) or os.path.getsize(p) != size:
            return False
    return True
