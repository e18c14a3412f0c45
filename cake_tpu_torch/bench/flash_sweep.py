"""Where a flash kernel's time goes: device time against the number of K/V
tiles its longest CTA walks, at the flagship's heads (Hq/Hkv 16/8, D 128)
and Gemma-3-1B's (4/1, D 256), beside a one-element kernel as the floor of
any launch.

    python -m cake_tpu_torch.bench.flash_sweep [--dtype bf16|f32] [--out PATH]

Per head shape: a launch with no visible key (valid_len 0: the kernel's
prologue and epilogue alone), fresh chunks of Sq in {16, 64, 128, 256,
512} and append chunks of 256 rows at q_offset in {256, 768, 1792} over a
4096-row pool view. A straight line through (tiles, device ms) of the
chunks splits the kernel into a fixed cost and a cost per tile of the
longest CTA. The f32 kernel's warps split a row group's tiles (4 warps,
or 8 where the plan gives the group a cluster of two CTAs), so for f32 a
second line is fitted through the tiles of the longest warp. Prints one
JSON object, and writes it to --out when given. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess

import torch

from ..ops import flash
from .timing import device_ms

HEADS = {"flagship": (16, 8, 128), "gemma3": (4, 1, 256)}
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
# (mode, Sq, q_offset, valid_len): None takes valid_len = Sq
CHUNKS = ([("empty", 256, 0, 0)]
          + [("fresh", s, 0, None) for s in (16, 64, 128, 256, 512)]
          + [("append", 256, o, None) for o in (256, 768, 1792)])


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def _case(heads, sq, q_offset, valid_len, dtype, gen):
    hq, hkv, d = heads
    q = torch.randn((1, sq, hq, d), generator=gen, device="cuda")
    k = torch.randn((3, 4096, hkv, d), generator=gen, device="cuda")
    v = torch.randn((3, 4096, hkv, d), generator=gen, device="cuda")
    kw = dict(q_offset=q_offset or None,
              valid_len=sq if valid_len is None else valid_len)
    return (q.to(dtype), k.to(dtype)[1:2], v.to(dtype)[1:2]), kw


def _fit(rows, key="max_tiles") -> dict:
    xs = [r[key] for r in rows]
    ys = [r["ms"] for r in rows]
    mx, my = sum(xs) / len(xs), sum(ys) / len(ys)
    slope = (sum((x - mx) * (y - my) for x, y in zip(xs, ys))
             / sum((x - mx) ** 2 for x in xs))
    return {"ms_per_tile": slope, "fixed_ms": my - slope * mx}


def sweep(route: str, heads) -> dict:
    """Device ms of each chunk and the fit over the chunks with tiles."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for mode, sq, off, vl in CHUNKS:
        (q, k, v), kw = _case(heads, sq, off, vl, DTYPES[route], gen)
        plan = flash.plan_flash(q.shape, k.shape, route=route, sms=sms,
                                **kw)
        tiles = max(max(0, hi - lo) for lo, hi in map(plan.tile_range,
                                                      range(plan.ctas)))
        ms = device_ms(lambda: flash.flash_attention_kernel(q, k, v, **kw))
        row = {"mode": mode, "sq": sq, "q_offset": off,
               "ctas": plan.ctas * k.shape[2], "max_tiles": tiles,
               "block_keys": plan.block_keys, "ms": ms}
        if route == "f32":
            row["split"] = plan.split
            row["max_tiles_per_warp"] = -(-tiles // (flash.F32_WARPS
                                                     * plan.split))
        rows.append(row)
    fitted = [r for r in rows if r["max_tiles"]]
    report = {"heads": dict(zip(("hq", "hkv", "d"), heads)), "rows": rows,
              **_fit(fitted)}
    if route == "f32":
        report["per_warp"] = _fit(fitted, "max_tiles_per_warp")
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="bf16")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("flash_sweep needs a CUDA card")
    one = torch.zeros(1, device="cuda")
    report = {"card": _card(), "dtype": args.dtype,
              "source": flash.SOURCES[args.dtype],
              "one_element_kernel_ms": device_ms(lambda: one.add_(1.0)),
              **{name: sweep(args.dtype, heads)
                 for name, heads in HEADS.items()}}
    text = json.dumps(report, indent=1)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
