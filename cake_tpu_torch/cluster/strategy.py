"""Layer-assignment strategy: TFLOPS-proportional contiguous ranges capped
by per-device memory, the layers that fit nowhere left to the master
(counterpart of cake_tpu/cluster/strategy.py, the same plans).

Memory reserves by backend, the fraction withheld from a device's
capacity (the reference's table: 5% CUDA, 28% unified memory, 20% CPU,
10% TPU):
"""
from __future__ import annotations

from dataclasses import dataclass

MEMORY_RESERVE = {"tpu": 0.10, "cuda": 0.05, "metal": 0.28, "cpu": 0.20}
DEFAULT_RESERVE = 0.15


@dataclass
class WorkerCapacity:
    name: str
    memory_bytes: int
    tflops: float
    backend: str = "cuda"

    @property
    def usable_bytes(self) -> int:
        r = MEMORY_RESERVE.get(self.backend, DEFAULT_RESERVE)
        return int(self.memory_bytes * (1.0 - r))


class Strategy:
    """Pluggable assignment interface."""

    def assign_layers(self, workers: list[WorkerCapacity], layers: list[int],
                      layer_bytes: list[int]) -> dict[str, list[int]]:
        raise NotImplementedError


class DefaultStrategy(Strategy):
    """Contiguous ranges proportional to TFLOPS, each capped by the worker's
    usable memory; layers that fit nowhere stay unassigned (the master keeps
    them)."""

    def assign_layers(self, workers, layers, layer_bytes):
        plan: dict[str, list[int]] = {w.name: [] for w in workers}
        if not workers or not layers:
            return plan
        total_tflops = sum(max(w.tflops, 1e-9) for w in workers)
        remaining = list(layers)
        # strongest workers first: they take their proportional share from
        # the front so ranges stay contiguous
        order = sorted(workers, key=lambda w: -w.tflops)
        n_total = len(layers)
        for idx, w in enumerate(order):
            if not remaining:
                break
            share = max(w.tflops, 1e-9) / total_tflops
            want = max(1, round(share * n_total))
            if idx == len(order) - 1:
                want = len(remaining)          # last worker offered the rest
            take: list[int] = []
            used = 0
            budget = w.usable_bytes if w.memory_bytes else None
            for li in remaining[:want]:
                b = layer_bytes[li] if li < len(layer_bytes) else 0
                if budget is not None and used + b > budget:
                    break
                take.append(li)
                used += b
            plan[w.name] = take
            remaining = remaining[len(take):]
        return plan


def estimate_layer_bytes(storage, num_layers: int,
                         quant_factor: float = 1.0) -> list[int]:
    """Per-layer parameter bytes from safetensors headers, no tensor data
    read (utils/safetensors_io.py); quant_factor is the dequantization's
    expansion in device memory."""
    from ..utils.safetensors_io import layer_of
    sizes = [0] * num_layers
    for name in storage.names():
        li = layer_of(name)
        if li is not None and li < num_layers:
            sizes[li] += storage.nbytes(name)
    return [int(s * quant_factor) for s in sizes]
