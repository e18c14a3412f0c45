"""Wire protocol: length-prefixed binary framing, msgpack-encoded control
messages and raw-buffer tensor payloads (counterpart of
cake_tpu/cluster/proto.py).

The bytes are the reference's: a frame is `<II` (MAGIC, payload length,
at most MAX_FRAME) and a msgpack payload, and every message constructor
builds the same map in the same key order, so a port master drives a JAX
worker and a JAX master a port worker. The msgpack subset is the port's
own (cluster/codec.py); the tensor dtype tags are utils/dtypes.py's.
The reference's native header parse (cakekit) is not ported: its own
Python parse is the one here.

Message types:
  hello, worker_info          handshake and capability report
  layer_assignment, ack       setup
  model_chunk, model_done, model_resume   weight streaming (CRC32)
  worker_ready, worker_error  readiness / per-op failure
  forward                     a hidden state for a worker's layer range,
                              one round trip
  tensor                      the result
  goodbye                     clear the connection's state
"""
from __future__ import annotations

import asyncio
import struct
import zlib

import torch

from ..obs import now
from ..utils.dtypes import (WIRE_DTYPES, WIRE_TAGS, from_wire_bytes,
                            to_wire_bytes, wire_name)
from .codec import packb, unpackb

MAGIC = 0x54504B31          # "TPK1"
MAX_FRAME = 512 * 1024 * 1024
_HDR = struct.Struct("<II")

# fault-injection seam (cluster/faults.py installs a FaultInjector here;
# None in production: one attribute check per frame). Write hooks fire
# before the frame hits the wire, read hooks see (and may corrupt) the
# raw payload before decode.
FAULT_HOOK = None


class ProtocolError(Exception):
    pass


def _parse_header(hdr: bytes) -> int:
    magic, length = _HDR.unpack(hdr)
    if magic != MAGIC:
        raise ProtocolError(f"bad magic {magic:#x}")
    if length > MAX_FRAME:
        raise ProtocolError(f"frame too large: {length}")
    return length


# -- tensors ----------------------------------------------------------------

def pack_tensor(t: torch.Tensor) -> dict:
    """A tensor (any device) -> the wire dict {dt, sh, d}: its dtype tag,
    shape and raw bytes."""
    return {"dt": WIRE_TAGS[wire_name(t.dtype)], "sh": list(t.shape),
            "d": to_wire_bytes(t)}


def unpack_tensor(obj: dict) -> torch.Tensor:
    """The wire dict -> a CPU tensor."""
    name = WIRE_DTYPES.get(obj["dt"])
    if name is None:
        raise ProtocolError(f"unknown dtype tag {obj['dt']}")
    return from_wire_bytes(obj["d"], name, tuple(obj["sh"]))


# -- framing ----------------------------------------------------------------

def encode_frame(msg: dict) -> bytes:
    payload = packb(msg)
    if len(payload) > MAX_FRAME:
        raise ProtocolError(f"frame too large: {len(payload)}")
    return _HDR.pack(MAGIC, len(payload)) + payload


def decode_payload(payload: bytes) -> dict:
    try:
        msg = unpackb(payload)
    except Exception as e:
        # garbage on the wire (bit flips, a desynced stream) surfaces as a
        # classifiable protocol failure
        raise ProtocolError(f"undecodable frame: {e}") from e
    if not isinstance(msg, dict):
        raise ProtocolError(f"undecodable frame: a {type(msg).__name__}, "
                            "not a map")
    return msg


async def read_frame(reader: asyncio.StreamReader) -> dict:
    return (await read_frame_timed(reader))[0]


async def read_frame_timed(reader: asyncio.StreamReader
                           ) -> tuple[dict, float, float]:
    """read_frame that also reports (payload-read seconds, decode seconds).
    The clock starts after the header arrives, so the idle wait for the
    next request is not counted."""
    hdr = await reader.readexactly(_HDR.size)
    length = _parse_header(hdr)
    t0 = now()
    payload = await reader.readexactly(length)
    t1 = now()
    if FAULT_HOOK is not None:
        payload = FAULT_HOOK.on_read(reader, payload)
    msg = decode_payload(payload)
    return msg, t1 - t0, now() - t1


async def write_frame(writer: asyncio.StreamWriter, msg: dict):
    if FAULT_HOOK is not None:
        FAULT_HOOK.on_write(writer, msg)
    writer.write(encode_frame(msg))
    await writer.drain()


def read_frame_sync(sock) -> dict:
    buf = b""
    while len(buf) < _HDR.size:
        chunk = sock.recv(_HDR.size - len(buf))
        if not chunk:
            raise ConnectionError("socket closed mid-header")
        buf += chunk
    length = _parse_header(buf)
    payload = bytearray(length)
    view = memoryview(payload)
    got = 0
    while got < length:
        n = sock.recv_into(view[got:], min(1 << 20, length - got))
        if not n:
            raise ConnectionError("socket closed mid-frame")
        got += n
    payload = bytes(payload)
    if FAULT_HOOK is not None:
        payload = FAULT_HOOK.on_read(sock, payload)
    return decode_payload(payload)


def write_frame_sync(sock, msg: dict):
    if FAULT_HOOK is not None:
        FAULT_HOOK.on_write(sock, msg)
    sock.sendall(encode_frame(msg))


# -- message constructors ---------------------------------------------------

def hello(name: str, version: str = "1") -> dict:
    return {"t": "hello", "name": name, "v": version}


def worker_info(name: str, layers: list[int], backend: str, device: str,
                memory_bytes: int, tflops: float,
                heartbeat_age_s: float | None = None,
                ops: int | None = None) -> dict:
    """heartbeat_age_s: seconds since this worker last handled any message
    on its own monotonic clock (an age is the only liveness field that
    means the same across nodes); ops: forwards served since start."""
    out = {"t": "worker_info", "name": name, "layers": layers,
           "backend": backend, "device": device,
           "memory_bytes": memory_bytes, "tflops": tflops}
    if heartbeat_age_s is not None:
        out["heartbeat_age_s"] = round(heartbeat_age_s, 3)
    if ops is not None:
        out["ops"] = int(ops)
    return out


def layer_assignment(model_id: str, arch: str, config: dict,
                     start: int, end: int, dtype: str,
                     cache_key: str, push_weights: bool,
                     fp8_native: bool = False) -> dict:
    return {"t": "layer_assignment", "model_id": model_id, "arch": arch,
            "config": config, "start": start, "end": end, "dtype": dtype,
            "cache_key": cache_key, "push_weights": push_weights,
            "fp8_native": fp8_native}


def model_chunk(file_name: str, index: int, total: int, data: bytes,
                crc32: int, compressed: bool, offset: int) -> dict:
    return {"t": "model_chunk", "file": file_name, "i": index, "n": total,
            "d": data, "crc": crc32, "z": compressed, "off": offset}


def model_done() -> dict:
    return {"t": "model_done"}


def model_resume(file_name: str, offset: int) -> dict:
    """Partial-transfer resume point."""
    return {"t": "model_resume", "file": file_name, "off": offset}


def worker_ready(ok: bool = True, error: str | None = None) -> dict:
    return {"t": "worker_ready", "ok": ok, "error": error}


def worker_error(message: str) -> dict:
    return {"t": "worker_error", "error": message}


def forward(x, pos0: int, valid_len: int | None, request_id: int = 0,
            kv_hint: int | None = None) -> dict:
    """x: a tensor or an already-packed wire dict. kv_hint: the master's
    current KV bucket; workers size their per-connection cache to
    max(pos0 + width, kv_hint)."""
    packed = x if isinstance(x, dict) and "dt" in x else pack_tensor(x)
    out = {"t": "forward", "x": packed, "pos0": int(pos0),
           "valid_len": None if valid_len is None else int(valid_len),
           "rid": request_id}
    if kv_hint is not None:
        out["kv"] = int(kv_hint)
    return out


def tensor_result(arr, request_id: int = 0,
                  fwd_ms: float | None = None,
                  timing: dict | None = None) -> dict:
    """fwd_ms: the worker's compute time for this request. timing: the
    per-phase echo {read_ms, deser_ms, fwd_ms, ser_ms}; the master
    subtracts it from its observed RTT and calls the rest the wire. arr
    may be a tensor or an already-packed wire dict (the worker times
    pack_tensor as its `ser` phase)."""
    packed = arr if isinstance(arr, dict) and "dt" in arr \
        else pack_tensor(arr)
    out = {"t": "tensor", "x": packed, "rid": request_id}
    if fwd_ms is not None:
        out["fwd_ms"] = round(fwd_ms, 3)
    if timing:
        out["tm"] = {k: round(float(v), 3) for k, v in timing.items()}
    return out


def goodbye() -> dict:
    return {"t": "goodbye"}


def ack() -> dict:
    return {"t": "ack"}


def crc32(data: bytes) -> int:
    return zlib.crc32(data) & 0xFFFFFFFF
