"""Where the bf16 flash kernel's time goes: device time against the number
of K/V tiles its longest CTA walks, at the flagship's heads (Hq/Hkv 16/8,
D 128), beside a one-element kernel as the floor of any launch.

    python -m cake_tpu_torch.bench.flash_sweep [--out PATH]

Fresh chunks of Sq in {64, 128, 256, 512} and append chunks of 256 rows at
q_offset in {0, 256, 768, 1792} over a 4096-row pool view. A straight line
through (tiles, device ms) splits the kernel into a fixed cost and a cost
per tile of the longest CTA. Prints one JSON object, and writes it to
--out when given. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess

import torch

from ..ops import flash
from .timing import device_ms


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def _case(sq, q_offset, pool_rows, gen):
    q = torch.randn((1, sq, 16, 128), generator=gen, device="cuda")
    k = torch.randn((3, pool_rows, 8, 128), generator=gen, device="cuda")
    v = torch.randn((3, pool_rows, 8, 128), generator=gen, device="cuda")
    kw = dict(q_offset=q_offset or None, valid_len=sq)
    return (q.bfloat16(), k.bfloat16()[1:2], v.bfloat16()[1:2]), kw


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("flash_sweep needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(0)
    one = torch.zeros(1, device="cuda")
    floor = device_ms(lambda: one.add_(1.0))
    rows = []
    for mode, sq, off, pool in ([("fresh", s, 0, s) for s in
                                 (64, 128, 256, 512)]
                                + [("append", 256, o, 4096) for o in
                                   (0, 256, 768, 1792)]):
        (q, k, v), kw = _case(sq, off, pool, gen)
        plan = flash.plan_flash(q.shape, k.shape, **kw)
        tiles = max(hi - lo for lo, hi in map(plan.tile_range,
                                              range(plan.ctas)))
        ms = device_ms(lambda: flash.flash_attention_kernel(q, k, v, **kw))
        rows.append({"mode": mode, "sq": sq, "q_offset": off,
                     "ctas": plan.ctas * k.shape[2], "max_tiles": tiles,
                     "ms": ms})
    xs = [r["max_tiles"] for r in rows]
    ys = [r["ms"] for r in rows]
    mx, my = sum(xs) / len(xs), sum(ys) / len(ys)
    slope = (sum((x - mx) * (y - my) for x, y in zip(xs, ys))
             / sum((x - mx) ** 2 for x in xs))
    report = {"card": _card(), "one_element_kernel_ms": floor,
              "ms_per_tile": slope, "fixed_ms": my - slope * mx,
              "rows": rows}
    text = json.dumps(report, indent=1)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
