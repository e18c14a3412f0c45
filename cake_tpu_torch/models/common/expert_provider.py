"""MoE expert providers, resident and offloaded to disk, and the routed
experts over a provider (counterpart of
cake_tpu/models/common/expert_provider.py: ResidentExpertProvider,
IndividualResidentProvider, DiskExpertProvider, moe_ffn_offloaded).

An offloaded model keeps its trunk on the device (attention, norms,
routers, shared experts, embeddings, head) and reads each routed expert
when a token selects it: `DiskExpertProvider` reads the expert's three
projections from the checkpoint through the model's quantization
strategy (none: the file's map, as every other tensor is read; FP8
dequantized on the device through the dequant kernel on a card, GPTQ and
GGUF in torch), and keeps the last `lru_size` experts of its layer on
the device. The reference reads an unquantized expert with one batched
`preadv`; in pure Python that read 0.46 GB/s against the map's 3.05 GB/s
on an H100's host (bench/expert_reads.py), so the port keeps the map. So the device holds the trunk plus one LRU per MoE
layer, whatever the number of experts.

`moe_ffn_offloaded` routes on the device and fetches the top-k indices
to the host once per call (the reference's host round trip), so it runs
eagerly only: inside a CUDA-graph capture it raises. Its arithmetic is
the resident routes' (ops/moe.py), not the reference's running sum in
the model dtype, so that an offloaded model gives the resident model's
bits on the card: decode and verify rows take the gathered route over a
bank of just the experts they selected; a prefill chunk runs each
selected expert over its own tokens in turn (in bfloat16 through the
same grouped GEMM the resident grouped route calls, one group), writes
the outputs in assignment order and combines the k of each token in
float32 as the resident routes do.
"""
from __future__ import annotations

import collections
import threading
import time

import torch

from ...ops.moe import _act, _combine, moe_gathered, router_topk

PROJS = ("gate_proj", "up_proj", "down_proj")


def eager_only(what: str) -> None:
    """Raise inside a CUDA-graph capture: an offloaded expert's read and
    the routing fetch are host work that a graph cannot replay."""
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(f"{what} reads experts on the host and runs "
                           "eagerly only; it cannot be captured in a CUDA "
                           "graph")


class ResidentExpertProvider:
    """Every expert stacked on the device ({"gate_proj": [E, I, H],
    ...}), as the resident model holds them."""

    def __init__(self, experts: dict):
        self.experts = experts

    def num_experts(self) -> int:
        return self.experts["gate_proj"].shape[0]

    def get(self, expert_idx: int) -> dict:
        return {k: v[expert_idx] for k, v in self.experts.items()}

    def prefetch(self, expert_indices) -> None:
        pass


class IndividualResidentProvider:
    """One dict of host tensors per expert, copied to `device` (and cast
    to `dtype`) on access."""

    def __init__(self, expert_list: list[dict], device="cpu",
                 dtype: torch.dtype | None = None):
        self.expert_list = expert_list
        self.device = device
        self.dtype = dtype

    def num_experts(self) -> int:
        return len(self.expert_list)

    def get(self, expert_idx: int) -> dict:
        return {k: v.to(self.device, self.dtype)
                for k, v in self.expert_list[expert_idx].items()}

    def prefetch(self, expert_indices) -> None:
        pass


class DiskExpertProvider:
    """One MoE layer's experts read from `storage` (a TensorStorage or a
    GgufStorage) on demand, through `quant` (a utils/quant.py strategy),
    cast to `dtype` on `device`, and kept in an LRU of `lru_size` experts. `name_fmt` names
    an expert's projection from {lp}, {e} and {proj}.

    Counts (under the lock): `hits` and `misses` of get(), `reads` (every
    expert read, prefetches included), `bytes_read` (stored bytes of the
    tensors those reads took) and `read_s` (seconds spent reading)."""

    def __init__(self, storage, layer_prefix: str, num_experts: int,
                 quant=None, dtype: torch.dtype = torch.bfloat16,
                 device="cpu", lru_size: int = 32,
                 name_fmt: str = "{lp}.mlp.experts.{e}.{proj}.weight"):
        from ...utils.quant import NoQuantization
        if lru_size < 1:
            raise ValueError(f"expert LRU size must be >= 1, got {lru_size}")
        self.storage = storage
        self.lp = layer_prefix
        self._n = num_experts
        self.quant = quant or NoQuantization()
        self.dtype = dtype
        self.device = torch.device(device)
        self.name_fmt = name_fmt
        self._lru: collections.OrderedDict[int, dict] = \
            collections.OrderedDict()
        self._lru_size = lru_size
        self._lock = threading.Lock()
        self._prefetcher: threading.Thread | None = None
        self.hits = self.misses = self.reads = self.bytes_read = 0
        self.read_s = 0.0

    def num_experts(self) -> int:
        return self._n

    def names(self, e: int) -> list[str]:
        return [self.name_fmt.format(lp=self.lp, e=e, proj=p) for p in PROJS]

    def _read_expert(self, e: int) -> dict:
        names = self.names(e)
        t0 = time.perf_counter()
        ws = [self.quant.load(self.storage, n, self.device, self.dtype)
              for n in names]
        nbytes = sum(self.storage.nbytes(s) for n in names
                     for s in self.quant.sources(self.storage, n))
        with self._lock:
            self.reads += 1
            self.bytes_read += nbytes
            self.read_s += time.perf_counter() - t0
        return dict(zip(PROJS, ws))

    def _insert(self, e: int, w: dict) -> None:
        with self._lock:
            self._lru[e] = w
            self._lru.move_to_end(e)
            while len(self._lru) > self._lru_size:
                self._lru.popitem(last=False)

    def get(self, expert_idx: int) -> dict:
        """Expert `expert_idx`'s {"gate_proj", "up_proj", "down_proj"} on
        the device: from the LRU (moved to its most recent end), else read
        and inserted, evicting the least recently used."""
        eager_only("DiskExpertProvider.get")
        e = int(expert_idx)
        with self._lock:
            w = self._lru.get(e)
            if w is not None:
                self._lru.move_to_end(e)
                self.hits += 1
                return w
            self.misses += 1
        w = self._read_expert(e)
        self._insert(e, w)
        return w

    def prefetch(self, expert_indices) -> None:
        """Read the given experts into the LRU on a background thread
        (the reference's prefetch hint), skipping those it holds; counted
        as reads, not as hits or misses."""
        idxs = [int(i) for i in expert_indices]

        def run():
            for e in idxs:
                with self._lock:
                    held = e in self._lru
                if not held:
                    self._insert(e, self._read_expert(e))
        t = threading.Thread(target=run, daemon=True,
                             name="cake-torch-expert-prefetch")
        t.start()
        self._prefetcher = t

    def stats(self) -> dict:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "reads": self.reads, "bytes_read": self.bytes_read,
                    "read_s": self.read_s, "resident": len(self._lru)}


def _expert_chunk(x: torch.Tensor, w: dict, act: str) -> torch.Tensor:
    """One expert's FFN over its own tokens x [M, H]: in bfloat16 through
    the grouped GEMM as one group (the resident grouped route's call),
    else plain products."""
    if x.dtype == torch.bfloat16 and hasattr(torch, "_grouped_mm"):
        offs = torch.tensor([x.shape[0]], dtype=torch.int32, device=x.device)

        def mm(a, b):
            return torch._grouped_mm(a, b.t()[None], offs=offs)
        a = _act(mm(x, w["gate_proj"]), mm(x, w["up_proj"]), act).to(x.dtype)
        return mm(a, w["down_proj"])
    a = _act(x @ w["gate_proj"].t(), x @ w["up_proj"].t(), act)
    return a @ w["down_proj"].t()


def moe_ffn_offloaded(x: torch.Tensor, router_weight: torch.Tensor,
                      provider, k: int, norm_topk_prob: bool,
                      gate_act: str = "softmax", act: str = "silu",
                      rows: bool = False) -> torch.Tensor:
    """Routed experts over any provider: x [T, H] -> [T, H] in x.dtype.
    The router as moe_ffn's (float32 logits, top-k on the device); the
    indices fetched to the host once; then each selected expert taken
    from the provider. `rows` (decode or verify rows): the gathered route
    over a bank of the selected experts; else (a prefill chunk) one
    expert at a time over its tokens."""
    eager_only("moe_ffn_offloaded")
    t = x.shape[0]
    logits = torch.matmul(x.float(), router_weight.float().t())
    weights, idx = router_topk(logits, k, norm_topk_prob, gate_act)
    flat = idx.reshape(-1).cpu()                # the one host fetch
    unique, local = torch.unique(flat, sorted=True, return_inverse=True)
    experts = unique.tolist()
    if rows:
        ws = [provider.get(e) for e in experts]
        bank = {p: torch.stack([w[p] for w in ws]) for p in PROJS}
        return moe_gathered(x, weights,
                            local.to(x.device, torch.int32).view(t, k),
                            bank["gate_proj"], bank["up_proj"],
                            bank["down_proj"], act)
    order = torch.argsort(flat, stable=True)
    counts = torch.bincount(local, minlength=len(experts)).tolist()
    order_dev = order.to(x.device)
    y = torch.empty(t * k, x.shape[1], dtype=x.dtype, device=x.device)
    start = 0
    for e, n in zip(experts, counts):
        assign = order_dev[start:start + n]     # this expert's assignments
        start += n
        xs = x.index_select(0, torch.div(assign, k, rounding_mode="floor"))
        y.index_copy_(0, assign, _expert_chunk(xs, provider.get(e), act)
                      .to(x.dtype))
    return _combine(y, weights, x.dtype)
