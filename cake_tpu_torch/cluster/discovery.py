"""Zero-config cluster discovery over UDP broadcast (counterpart of
cake_tpu/cluster/discovery.py: the same datagrams, so the JAX master
finds a port worker and the other way round).

  master -> broadcast:  {"magic": "CTPU", "hash": <8-hex>, "q": "discover"}
  worker -> unicast:    {"magic": "CTPU", "hash": ..., "name": ...,
                         "port": <service port>, "caps": {...}, ...}

`detect_capabilities` reads the card through torch.cuda: its name, its
memory and the count of cards. The reference's TPU table is not kept.
"""
from __future__ import annotations

import json
import os
import socket
import threading
import time

from .auth import cluster_hash

DISCOVERY_PORT = 18337
MAGIC = "CTPU"
MAX_DATAGRAM = 4096

# card name -> dense bf16 TFLOP/s, the figure the assignment strategy
# weighs workers by. NVIDIA H100 80GB HBM3 (SXM) at its 700 W power
# limit: 989 TFLOP/s, NVIDIA's data sheet (a card set below 700 W runs
# slower under load; the figure is a weight, not a measurement).
CARD_TFLOPS = {"NVIDIA H100 80GB HBM3": 989.0}
# the weight of a card not in the table
DEFAULT_CARD_TFLOPS = 100.0


def detect_capabilities() -> dict:
    """{backend, device, n_devices, memory_bytes, tflops} of this host:
    the CUDA cards torch sees, else the CPU."""
    import torch
    if torch.cuda.is_available():
        n = torch.cuda.device_count()
        props = torch.cuda.get_device_properties(0)
        tf = CARD_TFLOPS.get(props.name, DEFAULT_CARD_TFLOPS)
        return {"backend": "cuda", "device": props.name, "n_devices": n,
                "memory_bytes": int(props.total_memory) * n,
                "tflops": tf * n}
    return {"backend": "cpu", "device": "cpu", "n_devices": 1,
            "memory_bytes": _host_memory_bytes(), "tflops": 1.0}


def _host_memory_bytes() -> int:
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return 8 << 30


def get_broadcast_addresses() -> list[str]:
    """Interface-directed broadcast addresses (from `ip -json addr`), the
    limited broadcast and loopback."""
    addrs = {"255.255.255.255", "127.0.0.1"}
    try:
        import subprocess
        out = subprocess.run(["ip", "-json", "addr"], capture_output=True,
                             timeout=2, text=True)
        if out.returncode == 0:
            for iface in json.loads(out.stdout):
                for a in iface.get("addr_info", []):
                    if a.get("family") == "inet" and a.get("broadcast"):
                        addrs.add(a["broadcast"])
    except Exception:
        pass
    return sorted(addrs)


class WorkerAdvertiser:
    """Background UDP listener answering discovery queries."""

    def __init__(self, name: str, cluster_key: str, service_port: int,
                 discovery_port: int = DISCOVERY_PORT,
                 caps: dict | None = None):
        self.name = name
        self.hash = cluster_hash(cluster_key)
        self.service_port = service_port
        self.discovery_port = discovery_port
        self.caps = caps or detect_capabilities()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._sock: socket.socket | None = None

    def start(self):
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
        except OSError:
            pass
        self._sock.bind(("0.0.0.0", self.discovery_port))
        self._sock.settimeout(0.5)
        self._thread = threading.Thread(target=self._serve, daemon=True,
                                        name=f"advertiser-{self.name}")
        self._thread.start()
        return self

    def _serve(self):
        while not self._stop.is_set():
            try:
                data, addr = self._sock.recvfrom(MAX_DATAGRAM)
            except socket.timeout:
                continue
            except OSError:
                break
            try:
                msg = json.loads(data)
            except ValueError:
                continue
            if not isinstance(msg, dict) or msg.get("magic") != MAGIC \
                    or msg.get("hash") != self.hash \
                    or msg.get("q") != "discover":
                continue
            reply = {"magic": MAGIC, "hash": self.hash, "name": self.name,
                     "port": self.service_port, "caps": self.caps,
                     "hostname": socket.gethostname(),
                     "os": os.uname().sysname}
            try:
                self._sock.sendto(json.dumps(reply).encode(), addr)
            except OSError:
                pass

    def stop(self):
        self._stop.set()
        if self._sock:
            self._sock.close()
        if self._thread:
            self._thread.join(timeout=2)


def discover_workers(cluster_key: str, timeout: float = 2.0,
                     discovery_port: int = DISCOVERY_PORT,
                     expected: int | None = None,
                     addresses: list[str] | None = None) -> list[dict]:
    """Broadcast a query and collect worker replies, each with the
    sender's ip added as "host". `addresses`: where to send the query
    (default: get_broadcast_addresses())."""
    h = cluster_hash(cluster_key)
    query = json.dumps({"magic": MAGIC, "hash": h, "q": "discover"}).encode()
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_BROADCAST, 1)
    sock.settimeout(0.25)
    found: dict[tuple, dict] = {}
    baddrs = addresses or get_broadcast_addresses()
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        for baddr in baddrs:
            try:
                sock.sendto(query, (baddr, discovery_port))
            except OSError:
                continue
        while True:
            try:
                data, addr = sock.recvfrom(MAX_DATAGRAM)
            except (socket.timeout, OSError):
                break
            try:
                msg = json.loads(data)
            except ValueError:
                continue
            if not isinstance(msg, dict) or msg.get("magic") != MAGIC \
                    or msg.get("hash") != h or "name" not in msg:
                continue
            msg["host"] = addr[0]
            found[(msg["name"],)] = msg
        if expected is not None and len(found) >= expected:
            break
    sock.close()
    return list(found.values())
