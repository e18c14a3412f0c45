"""Where the serving time goes on the card: the decode step of the full
slot pool (contiguous and paged), eager and as a captured graph, generate's
captured chunk, and one prefill chunk of each flash mode, on the flagship.

    python -m cake_tpu_torch.bench.profile_step [--layers N] [--out PATH]

Builds the flagship (bf16, seeded random weights) with a 4-slot, 4096-row
pool, fills every slot with a 600-token prompt through prefill_chunk, and
the same into a paged pool (1024 blocks of 16 tokens) through
prefill_chunk_paged (bench/graph_cases.build_state). Each step writes
into its carries, so every call advances the rows by one position. For
each program it reports:
  * wall_ms: host clock per call over back-to-back calls ending in a
    synchronize;
  * device_ms: the summed kernel time from torch.profiler, and the top
    kernels (null and empty where the profiler sees no kernel). An eager
    program's ~1,000 launches fill the launch queue, so a spin ahead of
    them (timing.device_ms) cannot hold them back;
  * idle_share: 1 - device_ms / wall_ms;
and for the decode steps the same three for one replay of the step's
captured graph (replay_ms: CUDA events around replays queued behind a
spin, timing.device_ms; replay_wall_ms; replay_idle_share). For
generate: one 16-step chunk replay's time by CUDA events around
back-to-back replays (timing.issue_ms: a chunk's ~16,000 graph nodes do
not queue behind a spin), per token, beside the wall time per token of a
64-token generate and the profiler's kernels of one eager batch-1 step
of the same state (`step`). Prints one JSON object and
writes it to --out (default chiprun_out/profile_step.json). Needs a CUDA
card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess

import torch

from ..cli import build_flagship
from ..models.common.graphs import DecodeGraph
from ..models.common.text_model import GEN_CHUNK
from ..ops.sampling import SamplingConfig
from .graph_cases import build_state
from .timing import device_ms, issue_ms, kernel_times, wall_ms


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def _profile(fn, iters: int) -> dict:
    """An eager program: wall time and the profiler's kernel time."""
    wall = wall_ms(fn, iters)
    rows = kernel_times(fn, iters, warmup=0)
    device = sum(r[0] for r in rows) if rows else None
    return {"wall_ms": wall, "device_ms": device,
            "idle_share": None if device is None
            else max(0.0, 1.0 - device / wall),
            "flash_ms": sum(ms for ms, _, k in rows if "flash" in k),
            "paged_decode_ms": sum(ms for ms, _, k in rows
                                   if "paged_decode" in k),
            "top": [{"ms": round(ms, 4), "calls": round(n),
                     "kernel": k[:90]} for ms, n, k in rows[:12]]}


def _decode(model, kv_blocks: int, iters: int) -> dict:
    """Eager step and graph replay over one state of 4 rows at 600."""
    greedy = SamplingConfig(temperature=0.0)
    state = build_state(model, [600] * 4, [greedy] * 4, 4096,
                        kv_blocks=kv_blocks)
    graph = DecodeGraph(state.step_fn(model), model.device)
    state.activate()
    out = _profile(state.step_fn(model), iters)
    replay = device_ms(graph.step)
    wall = wall_ms(graph.step, 4 * iters)
    out.update({"replay_ms": replay, "replay_wall_ms": wall,
                "replay_idle_share": max(0.0, 1.0 - replay / wall)})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--out", default="chiprun_out/profile_step.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_step needs a CUDA card")
    model = build_flagship(args.layers, "bf16", 0, "cuda")
    n = 600
    ids = torch.randint(0, 256, (n,),
                        generator=torch.Generator().manual_seed(0)).tolist()
    report = {"card": _card(), "layers": model.cfg.num_hidden_layers,
              "slots": 4, "ctx": 4096, "prompt": n,
              "decode_step": _decode(model, 0, args.iters),
              "paged_decode_step": _decode(model, 1024, args.iters)}
    _, stats = model.generate(ids, 64, SamplingConfig(temperature=0.0))
    run = next(iter(model._runners.values()))
    chunk = issue_ms(run.graph.step, iters=5, warmup=1)
    report["generate"] = {
        "tokens": 64, "chunk_steps": GEN_CHUNK, "chunk_replay_ms": chunk,
        "replay_ms_per_token": chunk / GEN_CHUNK,
        "wall_ms_per_token": 1e3 / stats["tok_per_s"],
        "step": _profile(lambda: model.decode_slots_into(run.layers,
                                                         run.carries),
                         args.iters)}
    scratch = model.new_cache(1, kv_len=4096)["layers"]
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
