"""The float32 flash kernel's design choices, measured: the card's
mma.sync TF32 rate, and csrc/flash_attn.cu against variants of itself
built from the same source with one choice changed.

    python -m cake_tpu_torch.bench.flash_variants [--out PATH]

  * mma rate: a one-instruction-type kernel (written to build/ and built
    with nvcc) issues m16n8k8 TF32 mma.sync on 1, 4, 8 or 16 independent
    accumulators from 1 to 16 warps per SM: cycles per instruction per
    warp and per SM sub-partition, and the card-wide TFLOP/s.
  * variants, each built into build/ and timed in a process of its own
    (a hang costs one variant): `no_split` keeps one CTA per row group
    where the plan splits it over a cluster; `cvt_rna` splits operands
    with cvt.rna.tf32.f32; `w8_8k` has 8 warps and 8 KB tiles at every D;
    `one_layout` gives D 64 and 128 the D 256 layout (3 slots of 16 KB:
    one CTA per SM).
    Each at the f32 rows of chip_smoke.py, device ms (bench/timing.py),
    max abs error against the plain version, and whether two launches
    give the same bits.

Prints one JSON object, and writes it to --out when given. Needs a CUDA
card and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

from ..kernels.build import BUILD_DIR, CSRC_DIR, NVCC_FLAGS, nvcc_path

OUT_DIR = BUILD_DIR / "flash_variants"
SOURCE = CSRC_DIR / "flash_attn.cu"

MMA_BENCH = r"""
#include <cuda_runtime.h>
#include <stdint.h>
template <int NC>
__global__ void bench(float* out, long long* clk, int iters) {
  float d[NC][4] = {};
  const uint32_t a[4] = {0x3f800000u, 0x3f000000u, 0x3e800000u, threadIdx.x};
  const uint32_t b0 = 0x3f800000u, b1 = 0x3c000000u;
  __syncthreads();
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int c = 0; c < NC; ++c)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
          : "+f"(d[c][0]), "+f"(d[c][1]), "+f"(d[c][2]), "+f"(d[c][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  const long long t1 = clock64();
  float s = 0.f;
  for (int c = 0; c < NC; ++c) s += d[c][0] + d[c][1] + d[c][2] + d[c][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
  if (threadIdx.x % 32 == 0)
    clk[blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32] = t1 - t0;
}
extern "C" int run(int chains, int blocks, int threads, int iters,
                   float* out, long long* clk) {
  switch (chains) {
    case 1: bench<1><<<blocks, threads>>>(out, clk, iters); break;
    case 4: bench<4><<<blocks, threads>>>(out, clk, iters); break;
    case 8: bench<8><<<blocks, threads>>>(out, clk, iters); break;
    case 16: bench<16><<<blocks, threads>>>(out, clk, iters); break;
    default: return -1;
  }
  return static_cast<int>(cudaGetLastError());
}
"""

# the shipped layout's lines and each variant's replacements
SPLIT = """  hi = __float_as_uint(x) & kTf32;
  lo = __float_as_uint(x - __uint_as_float(hi)) & kTf32;"""
RNA = """  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(x - __uint_as_float(hi)));"""
NWARP = "constexpr int NWARP = 4;"
NSLOT = "static constexpr int NSLOT = D == 256 ? 3 : 2;"
TILE = "static constexpr int TILE_FLOATS = D == 256 ? 4096 : 2048;"
SHIPPED = ({}, 4, lambda d: 3 if d == 256 else 2,
           lambda d: 4096 if d == 256 else 2048)
# name: (replacements, warps, slots(D), tile floats(D)), and whether the
# plan may split a row group over a cluster
VARIANTS = {
    "shipped": (*SHIPPED, True),
    "no_split": (*SHIPPED, False),
    "cvt_rna": ({SPLIT: RNA}, *SHIPPED[1:], True),
    "w8_8k": ({NWARP: "constexpr int NWARP = 8;",
               NSLOT: "static constexpr int NSLOT = 3;",
               TILE: "static constexpr int TILE_FLOATS = 2048;"},
              8, lambda d: 3, lambda d: 2048, True),
    "one_layout": ({NSLOT: "static constexpr int NSLOT = 3;",
                    TILE: "static constexpr int TILE_FLOATS = 4096;"},
                   4, lambda d: 3, lambda d: 4096, True),
}


def _nvcc(src: Path, out: Path) -> str:
    r = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o",
                        str(out), str(src)], capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed for {src}:\n{r.stdout}{r.stderr}")
    return r.stdout + r.stderr


def mma_rate() -> dict:
    import torch
    src = OUT_DIR / "mma_bench.cu"
    src.write_text(MMA_BENCH)
    _nvcc(src, OUT_DIR / "libmma_bench.so")
    lib = ctypes.CDLL(str(OUT_DIR / "libmma_bench.so"))
    lib.run.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
    iters = 4096
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for chains in (1, 4, 8, 16):
        for warps in (1, 4, 8, 16):
            out = torch.empty(32 * warps * sms, device="cuda")
            clk = torch.zeros(warps * sms, dtype=torch.int64, device="cuda")
            for _ in range(2):
                assert lib.run(chains, sms, 32 * warps, iters, out.data_ptr(),
                               clk.data_ptr()) == 0
                torch.cuda.synchronize()
            per_warp = clk.float().mean().item() / (iters * chains)
            rows.append({"chains": chains, "warps_per_sm": warps,
                         "cycles_per_mma_per_warp": per_warp,
                         "cycles_per_mma_per_subpartition":
                             per_warp / max(1, warps // 4)})
    blocks, threads = 4 * sms, 256
    out = torch.empty(blocks * threads, device="cuda")
    clk = torch.zeros(blocks * threads // 32, dtype=torch.int64, device="cuda")
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    lib.run(8, blocks, threads, iters, out.data_ptr(), clk.data_ptr())
    start.record()
    lib.run(8, blocks, threads, iters, out.data_ptr(), clk.data_ptr())
    end.record()
    torch.cuda.synchronize()
    flops = blocks * threads // 32 * iters * 8 * 2 * 16 * 8 * 8
    return {"rows": rows, "card_tflops":
            flops / (start.elapsed_time(end) * 1e-3) / 1e12}


def _library(name: str) -> str:
    """The variant whose library `name` runs: the first of the same
    source."""
    return next(n for n, v in VARIANTS.items() if v[0] == VARIANTS[name][0]
                and v[1] == VARIANTS[name][1])


def _time_variant(name: str) -> dict:
    """In a child process: the variant's library against the plain
    version at chip_smoke.py's f32 rows."""
    import torch
    sys.path.insert(0, str(CSRC_DIR.parents[1]))
    import chip_smoke as cs
    from ..ops import flash
    from .timing import device_ms
    _, warps, slots, tile, may_split = VARIANTS[name]
    lib = ctypes.CDLL(str(OUT_DIR / f"lib{_library(name)}.so"))
    flash._bind_f32(lib)
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def run(q, k, v, kw):
        plan = flash.plan_flash(q.shape, k.shape, route="f32",
                                sms=sms if may_split else None, **kw)
        b, s, hq, d = q.shape
        out = torch.empty_like(q)
        st = [x for t, n in ((q, "q"), (k, "k"), (v, "v"), (out, "o"))
              for x in flash.tma_strides(t, n)]
        smem = (warps * slots(d) * tile(d) * 4 + 2 * 16 * d * 4
                + 8 * warps * slots(d) + 1024)
        err = lib.cake_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s,
            k.shape[1], hq, k.shape[2], d, *st, 16, plan.split, 32 * warps,
            smem,
            flash.LOG2E / d ** 0.5, 1, plan.window, plan.q_offset,
            plan.kv_len, torch.cuda.current_stream().cuda_stream)
        flash._raise_on(err)
        return out
    fam = dict(cs.family_flash_cases())
    rows = {}
    for entry, spec in (("f32", {}), ("f32_append", cs.FLASH_CASES[4][1]),
                        ("phi4_f32", fam["phi4_fresh"]),
                        ("phi4_f32_append", fam["phi4_append"]),
                        ("exaone4_f32", fam["exaone4_fresh"]),
                        ("gemma3_f32", fam["gemma3_fresh"]),
                        ("gemma3_f32_append", fam["gemma3_append"]),
                        ("gemma3_f32_window", fam["gemma3_fresh_window"])):
        q, k, v, kw = cs.flash_case(entry, torch.float32, **spec)
        got, again = run(q, k, v, kw), run(q, k, v, kw)
        torch.cuda.synchronize()
        rows[entry] = {
            "split": flash.plan_flash(q.shape, k.shape, route="f32", sms=sms
                                      if may_split else None, **kw).split,
            "ms": min(device_ms(lambda: run(q, k, v, kw)) for _ in range(3)),
            "max_abs_err": (got - flash.flash_attention_ref(q, k, v, **kw)
                            ).abs().max().item(),
            "same_bits": torch.equal(got, again)}
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--variant", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.variant:   # the child of one variant
        print(json.dumps(_time_variant(args.variant)))
        return 0
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("flash_variants needs a CUDA card")
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    report = {"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), "mma_sync_tf32": mma_rate(),
        "variants": {}}
    text = SOURCE.read_text()
    for name, (repl, *_) in VARIANTS.items():
        if _library(name) == name:
            src = text
            for old, new in repl.items():
                if src.count(old) != 1:
                    raise RuntimeError(f"variant {name}: {old!r} not found "
                                       "once")
                src = src.replace(old, new)
            path = OUT_DIR / f"{name}.cu"
            path.write_text(src)
            _nvcc(path, OUT_DIR / f"lib{name}.so")
        try:
            child = subprocess.run(
                [sys.executable, "-m", __spec__.name, "--variant", name],
                capture_output=True, text=True, timeout=120,
                cwd=str(CSRC_DIR.parents[1]))
            report["variants"][name] = (
                json.loads(child.stdout.strip().splitlines()[-1])
                if child.returncode == 0 else {"error": child.stderr[-800:]})
        except subprocess.TimeoutExpired:
            report["variants"][name] = {"error": "timed out"}
    out = json.dumps(report, indent=1)
    print(out)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
