"""Time to first token of the serve engine on the card, and two checkouts
compared in turns. Needs a CUDA card.

    python -m cake_tpu_torch.bench.serve_ttft [--rounds N]
    python -m cake_tpu_torch.bench.serve_ttft --turns OTHER_ROOT \\
        [--out build/bench/serve_ttft.json]

The flagship at full depth (28 layers, bf16, seed 0) behind a ServeEngine
of 4 slots with ctx 4096 and the prefix cache at its default, contiguous
and then paged (1024 blocks of 16 tokens), as chip_smoke.py's phases 5
and 6(a) serve it, but through `submit` instead of HTTP. After one
warm-up request, each round submits 4 requests at once, each a distinct
620-token prompt (seeded token ids, so no round hits the prefix cache)
and 32 greedy tokens, then one request alone. Reported per pool: each
round's TTFT p50 of the 4 and the lone request's TTFT, in ms (the
engine's own `ttft_s`: from submit to the first token's fan-out), the
decode tok/s p50, and the engine's start time.

With --turns, each side runs in a process of its own, in the order
OTHER, this, this, OTHER, where OTHER is the root of another checkout
(`git archive` of a parent commit unpacked under build/): the processes
run this file by path and import `cake_tpu_torch` from the root they are
given, so OTHER needs only ServeEngine and build_flagship.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
PROMPT_TOKENS, NEW_TOKENS, CONCURRENT = 620, 32, 4
POOLS = (("contiguous", {}), ("paged", {"kv_blocks": 1024,
                                        "kv_block_tokens": 16}))


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]


def _p50(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def measure(rounds: int) -> dict:
    import torch
    from cake_tpu_torch.cli import build_flagship
    from cake_tpu_torch.ops.sampling import SamplingConfig
    from cake_tpu_torch.serve import ServeEngine
    greedy = SamplingConfig(temperature=0.0)
    model = build_flagship(layers=None, dtype="bf16", seed=0, device="cuda")

    def prompt(seed):
        gen = torch.Generator().manual_seed(seed)
        return torch.randint(3, 256, (PROMPT_TOKENS,), generator=gen).tolist()

    def serve(eng, prompts):
        reqs = [eng.submit(p, NEW_TOKENS, greedy) for p in prompts]
        for r in reqs:
            if not r.wait(600) or "error" in r.result:
                raise RuntimeError(f"request failed: {r.result}")
        return [r.result["stats"] for r in reqs]
    out = {}
    for label, kw in POOLS:
        t0 = time.perf_counter()
        eng = ServeEngine(model, slots=4, ctx_len=4096, **kw)
        start_s = time.perf_counter() - t0
        try:
            serve(eng, [prompt(1)])
            rows = []
            for r in range(rounds):
                many = serve(eng, [prompt(100 * r + 10 + i)
                                   for i in range(CONCURRENT)])
                alone = serve(eng, [prompt(100 * r + 50)])[0]
                rows.append({
                    "ttft_p50_ms": _p50([s["ttft_s"] for s in many]) * 1e3,
                    "ttft_ms": sorted(s["ttft_s"] * 1e3 for s in many),
                    "tok_per_s_p50": _p50([s["tok_per_s"] for s in many]),
                    "alone_ttft_ms": alone["ttft_s"] * 1e3})
            health = eng.health()
        finally:
            eng.close()
        out[label] = {"engine_start_s": start_s, "rounds": rows,
                      "ttft_p50_ms": _p50([r["ttft_p50_ms"] for r in rows]),
                      "alone_ttft_ms": _p50([r["alone_ttft_ms"]
                                             for r in rows]),
                      "prefill_graphs": health.get("prefill_graphs")}
    return out


def _measure_main(root: str, rounds: int) -> int:
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print("serve_ttft: needs a CUDA card", file=sys.stderr)
        return 1
    print(json.dumps({"root": root, "card": card_line(),
                      "pools": measure(rounds)}), flush=True)
    return 0


def _run_measure(root: Path, rounds: int) -> dict:
    cmd = [sys.executable, str(Path(__file__).resolve()), "--measure",
           str(root), "--rounds", str(rounds)]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=1200,
                         cwd=root)
    if out.returncode != 0:
        raise RuntimeError(f"measure in {root} failed:\n{out.stdout[-4000:]}"
                           f"\n{out.stderr[-4000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--turns", metavar="OTHER_ROOT",
                    help="compare with another checkout: OTHER, this, "
                         "this, OTHER")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--measure", metavar="ROOT", help=argparse.SUPPRESS)
    ap.add_argument("--out", default="build/bench/serve_ttft.json")
    args = ap.parse_args()
    if args.measure:
        return _measure_main(args.measure, args.rounds)
    if args.turns:
        other = Path(args.turns).resolve()
        order = [("other", other), ("this", ROOT), ("this", ROOT),
                 ("other", other)]
    else:
        order = [("this", ROOT)]
    runs = []
    for label, root in order:
        runs.append({"label": label, **_run_measure(root, args.rounds)})
        print(json.dumps(runs[-1]), flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(runs, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
