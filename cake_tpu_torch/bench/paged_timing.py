"""Time the paged decode kernel on the card at the shapes `chip_smoke.py`
reports, and compare two checkouts' kernels in turns. Needs a CUDA card.

    python -m cake_tpu_torch.bench.paged_timing
    python -m cake_tpu_torch.bench.paged_timing --turns OTHER_ROOT \\
        [--out build/bench/paged_turns.json]

Shapes: 4 rows at frontier p, bt 16, Hq/Hkv 16/8, D 128, blocks scattered
over the pool (`paged_case`, seed p): bf16 at p = 620 (the serving shape),
float32 at p = 620 (the parity route), bf16 at p = 4000. For each: the
kernel's device ms (`timing.device_ms`, warm L2) and issue ms
(`timing.issue_ms`: one reading, as `chip_smoke.py` reports it; the best
of ISSUE_REPEATS readings with --turns, where both sides run this same
code), the library
call's device ms (`scaled_dot_product_attention` over rows gathered
beforehand: a yardstick, never called by the port), the bound (bytes or
operations at the H100 SXM's peaks) and the kernel's max abs error against
the plain version.

With --turns, each measurement runs in a process of its own, in the order
OTHER, this, this, OTHER, where OTHER is the root of another checkout
(for example `git archive` of a parent commit unpacked under build/): the
two kernels are compared inside one call on one card. The processes run
this file by path and import `cake_tpu_torch` from the root they are
given, so OTHER needs only the kernel's public entry points.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

H100_PEAK_FLOPS = {"bf16": 989e12,   # dense tensor-core peak, H100 SXM
                   "f32": 67e12}     # float32 outside the tensor cores
H100_HBM_BYTES_S = 3.35e12
SHAPES = (("bf16", "bfloat16", 620), ("f32", "float32", 620),
          ("bf16_p4000", "bfloat16", 4000))
ROOT = Path(__file__).resolve().parents[2]
ISSUE_REPEATS = 5   # readings of issue_ms per side with --turns


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]


def bound_ms(c) -> tuple[float, str]:
    """Least time on an H100 SXM for one paged decode call: the larger of
    bytes (each row's live K/V entries, their positions and table entries,
    q and o, once each) over HBM bandwidth and FLOPs (4 per visible key,
    head and channel) over the peak of q's type."""
    import torch
    q, k = c["q"], c["k"]
    b, _, hq, d = q.shape
    bt, hkv = k.shape[1], k.shape[2]
    el = q.element_size()
    fr = [int(p) for p in c["frontier"].tolist()]
    live = sum(p + 1 for p in fr)
    nbytes = (live * (2 * hkv * d * el + 4) + 2 * q.numel() * el
              + 4 * sum(p // bt + 1 for p in fr) + 4 * b)
    flops = 4.0 * live * hq * d
    peak = H100_PEAK_FLOPS["bf16" if q.dtype == torch.bfloat16 else "f32"]
    t_ops, t_bytes = flops / peak, nbytes / H100_HBM_BYTES_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def library_args(c):
    """scaled_dot_product_attention's inputs for the same function: each
    row's live rows gathered (outside the timed call) into contiguous
    [B, Hkv, T, D] K/V, T = the longest row, with a boolean mask."""
    from cake_tpu_torch.models.common.cache import paged_gather_layer
    view = paged_gather_layer({n: c[n] for n in ("k", "v", "pos")},
                              c["tables"], c["frontier"] + 1)
    t = int(c["frontier"].max()) + 1
    kk = view["k"][:, :t].transpose(1, 2).contiguous()
    vv = view["v"][:, :t].transpose(1, 2).contiguous()
    mask = (view["pos"][:, :t] >= 0)[:, None, None, :]
    return (c["q"].transpose(1, 2), kk, vv), dict(attn_mask=mask,
                                                 enable_gqa=True)


def measure(with_plain: bool = False, issue_repeats: int = 1) -> dict:
    """{entry: timings} at SHAPES for the imported package's kernel;
    issue_ms is the least of `issue_repeats` readings."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend
    from cake_tpu_torch.bench.paged_cases import case_args, paged_case
    from cake_tpu_torch.bench.timing import device_ms, issue_ms
    from cake_tpu_torch.ops import paged_attention as pa
    timings = {}
    for entry, dtype_name, p in SHAPES:
        dtype = getattr(torch, dtype_name)
        c = paged_case([p] * 4, dtype=dtype, device="cuda", seed=p)
        args = case_args(c)
        err = (pa.paged_decode_attention_kernel(*args).float()
               - pa.paged_decode_attention_ref(*args).float()).abs().max()
        lib_args, lib_kw = library_args(c)

        def kern():
            return pa.paged_decode_attention_kernel(*args)
        t = {"p": p, "max_abs_err": err.item(), "ms": device_ms(kern),
             "issue_ms": min(issue_ms(kern) for _ in range(issue_repeats)),
             "library_ms": device_ms(
                 lambda: F.scaled_dot_product_attention(*lib_args,
                                                        **lib_kw)),
             "library_backend": SDPBackend(torch._fused_sdp_choice(
                 *lib_args, **lib_kw)).name}
        if with_plain:
            t["plain_ms"] = device_ms(
                lambda: pa.paged_decode_attention_ref(*args), iters=10)
        t["bound_ms"], t["bound_by"] = bound_ms(c)
        if hasattr(pa, "active_clusters"):
            plan = pa.plan_paged(c["q"].shape, c["k"].shape,
                                 c["tables"].shape, dtype)
            t.update(stages=plan.stages, smem_bytes=plan.smem_bytes,
                     active_clusters=pa.active_clusters(*args))
        timings[entry] = t
    return timings


def sweep(frontiers) -> list[dict]:
    """The bf16 kernel's device ms at 4 rows of each frontier (bt 16,
    scattered blocks), and at p = max(frontiers) with each row's blocks
    adjacent in the pool; beside the device ms of one library reduction
    reading a 256 MiB bf16 tensor (the card's streaming read rate)."""
    import torch
    from cake_tpu_torch.bench.paged_cases import case_args, paged_case
    from cake_tpu_torch.bench.timing import device_ms
    from cake_tpu_torch.ops import paged_attention as pa
    rows = []
    for p, scatter in [(p, True) for p in frontiers] + [
            (max(frontiers), False)]:
        c = paged_case([p] * 4, dtype=torch.bfloat16, device="cuda", seed=p,
                       scatter=scatter)
        args = case_args(c)
        ms = device_ms(lambda: pa.paged_decode_attention_kernel(*args))
        rows.append({"p": p, "scatter": scatter, "ms": ms,
                     "bound_ms": bound_ms(c)[0]})
    x = torch.ones(128 << 20, dtype=torch.bfloat16, device="cuda")
    ms = device_ms(lambda: x.sum(dtype=torch.float32))
    rows.append({"stream_read_bytes": x.numel() * 2, "ms": ms,
                 "tb_per_s": x.numel() * 2 / ms / 1e9})
    return rows


def _measure_main(root: str) -> int:
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print("paged_timing: needs a CUDA card", file=sys.stderr)
        return 1
    print(json.dumps({"root": root, "card": card_line(),
                      "timings": measure(issue_repeats=ISSUE_REPEATS)}),
          flush=True)
    return 0


def _run_measure(root: Path) -> dict:
    cmd = [sys.executable, str(Path(__file__).resolve()), "--measure",
           str(root)]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=900,
                         cwd=root)
    if out.returncode != 0:
        raise RuntimeError(f"measure in {root} failed:\n{out.stdout}\n"
                           f"{out.stderr}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--turns", metavar="OTHER_ROOT",
                    help="compare with another checkout: OTHER, this, "
                         "this, OTHER")
    ap.add_argument("--sweep", type=int, nargs="*", default=[],
                    metavar="P", help="also time this checkout's bf16 "
                    "kernel at these frontiers (see sweep())")
    ap.add_argument("--measure", metavar="ROOT", help=argparse.SUPPRESS)
    ap.add_argument("--out", default="build/bench/paged_timing.json")
    args = ap.parse_args()
    if args.measure:
        return _measure_main(args.measure)
    runs = []
    if args.turns:
        other = Path(args.turns).resolve()
        order = [("other", other), ("this", ROOT), ("this", ROOT),
                 ("other", other)]
    else:
        order = [("this", ROOT)]
    for label, root in order:
        runs.append({"label": label, **_run_measure(root)})
        print(json.dumps(runs[-1]), flush=True)
    if args.sweep:
        runs.append({"label": "sweep", "card": card_line(),
                     "rows": sweep(args.sweep)})
        print(json.dumps(runs[-1]), flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(runs, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
