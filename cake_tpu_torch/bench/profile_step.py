"""Where the serving time goes on the card: one decode step of the full
slot pool (contiguous and paged) and one prefill chunk of each flash mode,
on the flagship.

    python -m cake_tpu_torch.bench.profile_step [--layers N] [--out PATH]

Builds the flagship (bf16, seeded random weights) with a 4-slot, 4096-row
pool, fills every slot with a 600-token prompt through prefill_chunk, and
the same into a paged pool (1024 blocks of 16 tokens) through
prefill_chunk_paged, then for each program (decode step over the
contiguous pool, paged decode step over 4 slots, a fresh 256-token chunk,
an append 256-token chunk, the 128-wide masked tail) reports:
  * wall ms per call (host clock around calls that end in a synchronize),
  * device ms per call from torch.profiler (sum of kernel time),
  * the device idle share (1 - device / wall),
  * the flash kernels' and the paged decode kernel's device ms per call,
  * the top kernels by device time.
Prints one JSON object and writes it to --out (default
chiprun_out/profile_step.json). Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import torch

from ..cli import build_flagship
from ..ops.sampling import SamplingConfig
from ..serve.engine import RECENT_N
from ..serve.paged import PagedKV
from .timing import kernel_times


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def _profile(fn, iters: int) -> dict:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / iters * 1e3
    rows = kernel_times(fn, iters, warmup=0)
    if not rows:
        raise RuntimeError("torch.profiler shows no device time")
    device = sum(r[0] for r in rows)
    return {"wall_ms": wall, "device_ms": device,
            "idle_share": max(0.0, 1.0 - device / wall),
            "flash_ms": sum(ms for ms, _, k in rows if "flash" in k),
            "paged_decode_ms": sum(ms for ms, _, k in rows
                                   if "paged_decode" in k),
            "top": [{"ms": round(ms, 4), "calls": round(n), "kernel": k[:90]}
                    for ms, n, k in rows[:12]]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--out", default="chiprun_out/profile_step.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_step needs a CUDA card")
    model = build_flagship(args.layers, "bf16", 0, "cuda")
    slots, ctx, n = 4, 4096, 600
    layers = model.new_cache(slots, kv_len=ctx)["layers"]
    gen = torch.Generator().manual_seed(0)
    ids = torch.randint(0, 256, (n,), generator=gen).tolist()
    for s in range(slots):
        for p0 in range(0, n, 256):
            _, layers = model.prefill_chunk(layers, s, ids[p0:p0 + 256], p0)
    dev = model.device
    toks = torch.ones(slots, dtype=torch.int32, device=dev)
    pos = torch.full((slots,), n, dtype=torch.int32, device=dev)
    recents = torch.full((slots, RECENT_N), -1, dtype=torch.int32,
                         device=dev)
    g = SamplingConfig()
    carries = [torch.full((slots,), v, dtype=dt, device=dev) for v, dt in (
        (g.temperature, torch.float32), (model.cfg.vocab_size, torch.int32),
        (1.0, torch.float32), (g.repeat_penalty, torch.float32))]
    active = torch.ones(slots, dtype=torch.bool, device=dev)

    def decode():   # positions stay put: the same step, re-run
        model.decode_slots(layers, toks, pos, recents, *carries, active)
    paged = PagedKV.build(model, slots, ctx, 1024, 16, 256)
    for s in range(slots):
        for p0 in range(0, n, 256):
            paged.reserve_range(s, p0, min(256, n - p0) + 1)
            paged.prefill_into(s, ids[p0:p0 + 256], p0)

    def decode_paged():
        model.decode_slots_paged(paged.pool, paged.rows, paged.tables, toks,
                                 pos, recents, *carries, active)
    scratch = model.new_cache(1, kv_len=ctx)["layers"]
    report = {"card": _card(), "layers": model.cfg.num_hidden_layers,
              "slots": slots, "ctx": ctx, "prompt": n,
              "decode_step": _profile(decode, args.iters),
              "paged_decode_step": _profile(decode_paged, args.iters)}
    for name, p0, width in (("prefill_fresh_256", 0, 256),
                            ("prefill_append_256", 256, 256),
                            ("prefill_tail_88", 512, 88)):
        report[name] = _profile(
            lambda: model.prefill_chunk(scratch, 0, ids[p0:p0 + width], p0),
            args.iters)
    text = json.dumps(report, indent=1)
    print(text)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        f.write(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
