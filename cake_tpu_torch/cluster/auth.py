"""Mutual HMAC-SHA256 challenge-response over the raw socket, before any
protocol framing (counterpart of cake_tpu/cluster/auth.py; the same
bytes, so each package's worker authenticates the other's master).

Both sides prove knowledge of the cluster's pre-shared key without
sending it:
  worker  -> master: 32-byte random challenge Cw
  master  -> worker: HMAC(key, Cw) || 32-byte challenge Cm
  worker  -> master: HMAC(key, Cm)          (checked in constant time)
No confidentiality: this authenticates membership only.
"""
from __future__ import annotations

import asyncio
import hashlib
import hmac
import os

CHALLENGE_LEN = 32
MAC_LEN = 32
AUTH_TIMEOUT = 10.0


class AuthError(Exception):
    pass


def mac(key: str, challenge: bytes) -> bytes:
    return hmac.new(key.encode(), challenge, hashlib.sha256).digest()


def cluster_hash(cluster_key: str) -> str:
    """8-hex-char cluster id derived from the key: the discovery filter
    and a part of the worker cache's key."""
    return hashlib.sha256(cluster_key.encode()).hexdigest()[:8]


async def _read(reader, n: int, what: str) -> bytes:
    """Exactly n bytes; EOF or a timeout during the handshake is an auth
    failure (the peer bailed after a bad MAC)."""
    try:
        return await asyncio.wait_for(reader.readexactly(n), AUTH_TIMEOUT)
    except (asyncio.IncompleteReadError, ConnectionError) as e:
        raise AuthError(f"peer closed during {what}") from e
    except (TimeoutError, asyncio.TimeoutError) as e:
        raise AuthError(f"timeout waiting for {what}") from e


async def authenticate_as_worker(reader: asyncio.StreamReader,
                                 writer: asyncio.StreamWriter,
                                 cluster_key: str):
    """Worker side: challenge the master, answer the master's challenge."""
    cw = os.urandom(CHALLENGE_LEN)
    writer.write(cw)
    await writer.drain()
    data = await _read(reader, MAC_LEN + CHALLENGE_LEN, "master response")
    their_mac, cm = data[:MAC_LEN], data[MAC_LEN:]
    if not hmac.compare_digest(their_mac, mac(cluster_key, cw)):
        raise AuthError("master failed authentication")
    writer.write(mac(cluster_key, cm))
    await writer.drain()


async def authenticate_as_master(reader: asyncio.StreamReader,
                                 writer: asyncio.StreamWriter,
                                 cluster_key: str):
    """Master side: answer the worker's challenge, then challenge back."""
    cw = await _read(reader, CHALLENGE_LEN, "worker challenge")
    cm = os.urandom(CHALLENGE_LEN)
    writer.write(mac(cluster_key, cw) + cm)
    await writer.drain()
    their_mac = await _read(reader, MAC_LEN, "worker MAC")
    if not hmac.compare_digest(their_mac, mac(cluster_key, cm)):
        raise AuthError("worker failed authentication")
