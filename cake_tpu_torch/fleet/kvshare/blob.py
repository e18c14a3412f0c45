"""Fleet-shared KV wire format (the port's copy of
cake_tpu/fleet/kvshare/blob.py): versioned, checksummed blobs of paged KV
state.

One codec carries both transfer kinds of the kvshare tier:

  * kind="prefix" — a prefix-cache chain's pinned blocks (per-layer
    block arrays + the boundary row snapshot), exported by a warm
    replica and installed into a cold peer's PagedPrefixCache so the
    peer's next admission splices instead of re-prefilling;
  * kind="stream" — a live slot's swap blob (PagedKV.swap_out layout:
    block arrays + row snapshot + decode carries + the generated-token
    record), shipped to a new owner on drain so a sampled stream resumes
    bit-exactly (its key and counter carries ride the blob).

Layout: MAGIC + version byte + blake2b-16 digest of the payload +
payload, where payload = 4-byte big-endian header length + compact JSON
header + the concatenated raw array bytes in header-manifest order. The
header's "arrays" manifest records each array's key, dtype and shape;
every other header field is kind-specific.

Arrays go in as numpy arrays or torch tensors and come out as CPU torch
tensors. Dtypes travel under numpy's names ("float32", "int32",
"bfloat16", ...), and a bfloat16 array as its raw 2-byte words, so the
same header and array bytes make the same blob in the JAX package (whose
numpy names bfloat16 through ml_dtypes) and here, where the card's
machine has no ml_dtypes. Importing this module loads neither numpy nor
torch: the router tier imports the package for the directory codec.

Every failure mode — bad magic, version skew, checksum mismatch, a
manifest that disagrees with the body, or a pool-shape signature that
does not match the importing replica — raises the typed KVBlobMismatch.
Callers treat that as "recompute honestly": a fetched blob can never
corrupt a pool, only fail to help.
"""
from __future__ import annotations

import hashlib
import json
import math

__all__ = ["KVBlobMismatch", "MAGIC", "VERSION", "encode_blob",
           "decode_blob", "pool_signature", "dtype_name"]

MAGIC = b"CAKEKV"
VERSION = 1
_DIGEST = 16

# numpy's dtype names, as the reference's str(array.dtype) writes them
_ITEMSIZE = {"bool": 1, "int8": 1, "uint8": 1, "int16": 2, "uint16": 2,
             "int32": 4, "uint32": 4, "int64": 8, "uint64": 8,
             "float16": 2, "bfloat16": 2, "float32": 4, "float64": 8}


class KVBlobMismatch(ValueError):
    """Typed reject: this blob cannot be installed here. The fallback is
    ALWAYS honest recompute — never a partial or corrupted install."""


def dtype_name(dtype) -> str:
    """numpy's name of a torch or numpy dtype ("torch.bfloat16" ->
    "bfloat16")."""
    return str(dtype).rsplit(".", 1)[-1]


def _raw(arr) -> tuple[str, list, object]:
    """(dtype name, shape, C-order bytes as a buffer) of a torch tensor
    or a numpy array, without importing either package here. A tensor
    already on the host and contiguous is not copied: its buffer is a
    view of the tensor's own memory."""
    if hasattr(arr, "untyped_storage"):             # a torch tensor
        import torch
        t = arr.detach().to("cpu").contiguous()
        shape = list(t.shape)
        flat = t.reshape(-1)
        if flat.dtype == torch.bool:
            flat = flat.to(torch.uint8)
        data = memoryview(flat.view(torch.uint8).numpy()) if flat.numel() \
            else b""
        return dtype_name(arr.dtype), shape, data
    shape = [int(s) for s in arr.shape]
    return str(arr.dtype), shape, arr.tobytes(order="C")


def encode_blob(header: dict, arrays: dict) -> bytes:
    """Serialize `arrays` (name -> tensor or array, order-significant)
    under `header` (JSON-safe dict; an "arrays" manifest is added here).
    The manifest records each array's own shape: a 0-d carry comes back
    0-d. The digest is taken piece by piece and the blob joined once, so
    the array bytes are copied once."""
    manifest = []
    chunks = []
    for key, arr in arrays.items():
        name, shape, data = _raw(arr)
        manifest.append({"key": key, "dtype": name, "shape": shape})
        chunks.append(data)
    head = dict(header)
    head["arrays"] = manifest
    hj = json.dumps(head, separators=(",", ":"), sort_keys=True).encode()
    lead = len(hj).to_bytes(4, "big") + hj
    h = hashlib.blake2b(lead, digest_size=_DIGEST)
    for data in chunks:
        h.update(data)
    return b"".join([MAGIC, bytes([VERSION]), h.digest(), lead, *chunks])


def _tensor(body: bytearray, pos: int, n: int, name: str, shape: tuple):
    """The CPU tensor of body[pos:pos + n]: a view of `body` where the
    offset is aligned to the element size, else a copy of its own."""
    import torch
    dt = torch.uint8 if name == "bool" else getattr(torch, name)
    size = _ITEMSIZE[name]
    if n == 0:
        t = torch.empty(0, dtype=dt)
    elif pos % size:
        t = torch.frombuffer(bytearray(body[pos:pos + n]), dtype=dt)
    else:
        t = torch.frombuffer(body, dtype=dt, count=n // size, offset=pos)
    if name == "bool":
        t = t.to(torch.bool)
    return t.reshape(shape)


def decode_blob(data: bytes) -> tuple[dict, dict]:
    """Verify and parse a wire blob; returns (header, arrays), each array
    a CPU torch tensor over one copy of the blob's body (the arrays share
    it). Raises KVBlobMismatch on any structural problem — the checksum
    covers the whole payload, so a passing decode is byte-exact."""
    pre = len(MAGIC) + 1 + _DIGEST
    if not isinstance(data, (bytes, bytearray)) or len(data) < pre + 4:
        raise KVBlobMismatch("kv blob truncated")
    view = memoryview(data)
    if bytes(view[:len(MAGIC)]) != MAGIC:
        raise KVBlobMismatch("kv blob: bad magic")
    ver = data[len(MAGIC)]
    if ver != VERSION:
        raise KVBlobMismatch(f"kv blob version {ver} != {VERSION}")
    digest = bytes(view[len(MAGIC) + 1:pre])
    payload = view[pre:]
    if hashlib.blake2b(payload, digest_size=_DIGEST).digest() != digest:
        raise KVBlobMismatch("kv blob checksum mismatch")
    hlen = int.from_bytes(payload[:4], "big")
    if 4 + hlen > len(payload):
        raise KVBlobMismatch("kv blob header truncated")
    try:
        header = json.loads(bytes(payload[4:4 + hlen]).decode())
    except Exception as e:
        raise KVBlobMismatch(f"kv blob header unreadable: {e}")
    body = bytearray(payload[4 + hlen:])
    arrays = {}
    pos = 0
    for m in header.get("arrays") or []:
        try:
            name = str(m["dtype"])
            size = _ITEMSIZE[name]
            shape = tuple(int(s) for s in m["shape"])
            if any(s < 0 for s in shape):
                raise ValueError(f"negative dimension in {shape}")
        except Exception as e:
            raise KVBlobMismatch(f"kv blob manifest unreadable: {e}")
        n = math.prod(shape) * size
        if pos + n > len(body):
            raise KVBlobMismatch("kv blob body truncated")
        arrays[m["key"]] = _tensor(body, pos, n, name, shape)
        pos += n
    if pos != len(body):
        raise KVBlobMismatch("kv blob: trailing bytes past manifest")
    return header, arrays


def pool_signature(paged) -> list:
    """JSON-safe shape/dtype signature of a PagedKV pool's per-layer
    block arrays (block axis excluded — block COUNT may differ between
    peers; per-block geometry and dtype must not), under numpy's dtype
    names as the reference writes them. Import refuses any blob whose
    recorded signature differs from the local one."""
    sig = []
    for pl in paged.pool:
        if not pl:
            sig.append(None)
        else:
            sig.append({n: [list(pl[n].shape[1:]), dtype_name(pl[n].dtype)]
                        for n in ("k", "v", "pos")})
    return sig
