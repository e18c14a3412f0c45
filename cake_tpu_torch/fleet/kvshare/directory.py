"""Peer directory of the fleet-shared KV tier (the port's copy of
cake_tpu/fleet/kvshare/directory.py).

Each replica's /health already rides the router's probe scrape; with
kvshare on, the health body carries a `kvshare.chains` inventory (the
hex chain keys the replica can export, newest-first, capped by
CAKE_KVSHARE_INVENTORY). The registry mirrors that inventory per
replica, and the router injects a compact JSON directory of WARM peers
into each forwarded request (the X-Cake-KV-Peers header, built here), so
the directory is never more stale than one probe interval, and a stale
or ejected replica's inventory is retracted with its probe state.

Wire shape (compact on purpose — it lives in a request header):

    {"p": [{"u": "http://host:port", "k": ["<hex>", ...]}, ...]}
"""
from __future__ import annotations

import json

__all__ = ["encode_directory", "parse_directory", "KV_DIR_HEADER",
           "KV_RESUME_HEADER", "KV_RESUMED_HEADER"]

# the tier's three handshake headers, named once here (this module
# imports neither torch nor numpy, so the router tier reads them too):
# router -> replica: the peer directory (compact JSON of warm peers and
# their advertised chain keys), injected per attempt like the QoS header
KV_DIR_HEADER = "X-Cake-KV-Peers"
# router -> replica: adopt the posted stream blob for this request id
# before treating the body as a plain continuation
KV_RESUME_HEADER = "X-Cake-KV-Resume"
# replica -> router: this response replays the stream from token 0 out
# of an adopted blob; strip everything the client already saw
KV_RESUMED_HEADER = "X-Cake-KV-Resumed"


def encode_directory(peers: list) -> str | None:
    """Header value for a list of (base_url, chain_hex_iterable) pairs;
    None when no peer has anything to advertise (the header is simply
    not injected)."""
    out = []
    for url, chains in peers:
        chains = list(chains)
        if not url or not chains:
            continue
        out.append({"u": url, "k": chains})
    if not out:
        return None
    return json.dumps({"p": out}, separators=(",", ":"))


def parse_directory(header: str) -> list:
    """(base_url, frozenset(chain_hex)) pairs out of a header value;
    malformed input parses as empty (the fetch path treats that as "no
    warm peers" and recomputes)."""
    try:
        doc = json.loads(header)
        peers = []
        for p in doc.get("p") or []:
            url = p.get("u")
            keys = p.get("k") or []
            if isinstance(url, str) and url and isinstance(keys, list):
                peers.append((url, frozenset(
                    k for k in keys if isinstance(k, str))))
        return peers
    except Exception:
        return []
