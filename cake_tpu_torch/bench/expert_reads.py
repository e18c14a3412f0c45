"""Expert reads from a safetensors checkpoint onto the card, two ways on
the same experts: the file's map (`TensorStorage.read`, one tensor at a
time, as the expert provider reads through `quant.load`) and one
`os.preadv` of an expert's three adjacent projections into fresh
buffers (`preadv_read`, the reference's batched read in pure Python,
which the provider does not use because it reads slower). One MoE layer at
Qwen3-Next-80B-A3B's widths: 512 experts, hidden 2048, intermediate 512,
bf16 (6.3 MB an expert, 3.2 GB the layer). Needs a CUDA card.

    python -m cake_tpu_torch.bench.expert_reads [--per-trial 64] [--dir D]

Warm: the file's pages in the host's page cache (it was just written).
Cold: the file flushed and dropped from the page cache (posix_fadvise
DONTNEED, advisory) before each trial. Trials alternate map, preadv,
preadv, map over disjoint sets of experts, each through a fresh storage,
and end in a synchronize. Prints one JSON line: each path's GB/s in each
mode, every trial's, and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import tempfile
import time

import torch

from ..utils.safetensors_io import TensorStorage, save_safetensors

HIDDEN, INTER, EXPERTS = 2048, 512, 512
PROJS = ("gate_proj", "up_proj", "down_proj")
NAME = "model.layers.0.mlp.experts.{e}.{proj}.weight"


def write_layer(path: str) -> int:
    """One layer's experts, random bf16 (eight distinct experts repeated:
    the bytes read do not depend on the values). Returns bytes written."""
    g = torch.Generator(device="cuda").manual_seed(0)
    bank = [{p: torch.randn(*((HIDDEN, INTER) if p == "down_proj"
                              else (INTER, HIDDEN)), generator=g,
                            device="cuda").to(torch.bfloat16)
             for p in PROJS} for _ in range(8)]
    n = save_safetensors(path, {NAME.format(e=e, proj=p): bank[e % 8][p]
                                for e in range(EXPERTS) for p in PROJS})
    with open(path, "rb+") as f:
        os.fsync(f.fileno())
    return n


def preadv_read(st: TensorStorage, fd: int, names: list[str], device,
                dtype: torch.dtype) -> list[torch.Tensor]:
    """The tensors `names`, adjacent in one file in this order, by one
    `os.preadv` into a fresh buffer each, then copied to `device`."""
    recs = [st.records[n] for n in names]
    if any(a.end != b.start for a, b in zip(recs, recs[1:])):
        raise ValueError(f"{names} are not adjacent")
    bufs = [bytearray(r.nbytes) for r in recs]
    if os.preadv(fd, bufs, recs[0].start) != sum(r.nbytes for r in recs):
        raise ValueError(f"short read of {names}")
    return [torch.frombuffer(b, dtype=dtype).reshape(r.shape)
            .to(device=device, copy=True) for b, r in zip(bufs, recs)]


def drop_cache(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
    finally:
        os.close(fd)


def trial(path: str, experts: range, how: str) -> tuple[float, int]:
    """(seconds, bytes) of reading `experts` onto the card through a fresh
    storage, by `how`: "map" or "preadv"."""
    st = TensorStorage.from_model_dir(os.path.dirname(path))
    fd = os.open(path, os.O_RDONLY)
    try:
        nbytes = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for e in experts:
            names = [NAME.format(e=e, proj=p) for p in PROJS]
            if how == "map":
                ws = [st.read(n, "cuda", torch.bfloat16) for n in names]
            else:
                ws = preadv_read(st, fd, names, "cuda", torch.bfloat16)
            nbytes += sum(w.numel() * w.element_size() for w in ws)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, nbytes
    finally:
        os.close(fd)
        st.close()


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    return out.stdout.strip()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--per-trial", type=int, default=64,
                    help="experts read in one trial (8 trials a mode)")
    ap.add_argument("--dir", default=None,
                    help="where the layer is written (default: a new "
                    "temporary directory, removed after)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("expert_reads needs a CUDA card")
    k = args.per_trial
    if 8 * k > EXPERTS:
        raise SystemExit(f"--per-trial {k}: 8 trials need {8 * k} of "
                         f"{EXPERTS} experts")
    d = args.dir or tempfile.mkdtemp(prefix="expert_reads_")
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, "layer.safetensors")
    try:
        written = write_layer(path)
        st = TensorStorage.from_model_dir(d)
        fd = os.open(path, os.O_RDONLY)
        names = [NAME.format(e=3, proj=p) for p in PROJS]
        same = all(torch.equal(a, b) for a, b in zip(
            [st.read(n, "cuda", torch.bfloat16) for n in names],
            preadv_read(st, fd, names, "cuda", torch.bfloat16)))
        os.close(fd)
        st.close()
        if not same:
            raise SystemExit("the preadv read disagrees with the map's")
        trial(path, range(0, 8), "map")           # warm-up: CUDA context, allocator
        trial(path, range(0, 8), "preadv")
        out: dict = {"card": card(), "file_bytes": written,
                     "experts_per_trial": k}
        for mode in ("warm", "cold"):
            times = {"map": [], "preadv": []}
            for i, how in enumerate(("map", "preadv", "preadv", "map") * 2):
                if mode == "cold":
                    drop_cache(path)
                s, n = trial(path, range(i * k, (i + 1) * k), how)
                times[how].append(n / s / 1e9)
            out[mode] = {h: {"gb_s": sum(v) / len(v), "trials": v}
                         for h, v in times.items()}
        print(json.dumps(out), flush=True)
    finally:
        if args.dir is None:
            shutil.rmtree(d, ignore_errors=True)
        else:
            os.remove(path)


if __name__ == "__main__":
    main()
