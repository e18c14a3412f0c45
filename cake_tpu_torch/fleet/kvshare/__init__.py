"""Fleet-shared KV tier (the port's copy of cake_tpu/fleet/kvshare/):
prefix-blob export and fetch between replicas, a probe-piggybacked peer
directory, and live stream-blob migration.

Module map:

  * blob.py      — versioned + checksummed wire format (KVBlobMismatch
                   is the typed reject; the fallback is always
                   recompute);
  * directory.py — the X-Cake-KV-Peers header codec (the router builds
                   it from registry-mirrored inventories per attempt)
                   and the tier's three header names;
  * replica.py   — the per-engine agent: a scheduler-thread mailbox for
                   export/import/park/adopt, fetch-before-recompute on
                   admission, and the StreamMigrated severing signal.
"""
from .blob import (KVBlobMismatch, MAGIC, VERSION, decode_blob,
                   encode_blob, pool_signature)
from .directory import (KV_DIR_HEADER, KV_RESUME_HEADER, KV_RESUMED_HEADER,
                        encode_directory, parse_directory)

# replica.py imports torch (it moves pool tensors); the router tier
# imports this package for the directory codec alone and stays torch-free,
# so the replica-side names resolve lazily (PEP 562)
_REPLICA_NAMES = ("KVShareReplica", "StreamMigrated")


def __getattr__(name):
    if name in _REPLICA_NAMES:
        from . import replica as _replica
        return getattr(_replica, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "KVBlobMismatch", "MAGIC", "VERSION", "encode_blob", "decode_blob",
    "pool_signature", "encode_directory", "parse_directory",
    "KVShareReplica", "StreamMigrated", "KV_DIR_HEADER",
    "KV_RESUME_HEADER", "KV_RESUMED_HEADER",
]
