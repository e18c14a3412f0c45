#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py    # every phase (needs one card)

Phases (any failure exits non-zero and prints no result line):
  1. device: require CUDA; print `nvidia-smi` name and power limit;
  2. build: compile every CUDA kernel of the port from this checkout (the
     two flash sources and the paged decode source, one nvcc each, all
     started together), print each source's ptxas report (registers,
     shared memory, spills) and the count of tensor-core instructions in
     each flash kernel's SASS: HGMMA (wgmma) in the bf16 one and HMMA
     .TF32 (mma.sync, 3xTF32) in the f32 one, neither of which may be 0;
  3. kernels: hold each kernel against its plain PyTorch version on the
     card (flash: bf16 on the wgmma kernel, f32 on the 3xTF32 kernel;
     paged decode: its launch plan (cluster, stages, shared memory, the
     clusters the card holds at once) and ptxas report first, then both
     routes over ragged frontiers, an all-NULL row, stale tenants and a
     shared block, bt 16 and 64, D 128 and 64, and block counts around
     the cluster size, each case launched twice with bit-identical
     results), then time kernel, plain version and the PyTorch library
     call as device time (CUDA events around calls queued behind a spin
     kernel, so the card runs them back to back), beside the issue rate of
     back-to-back calls, the card's bound and the library call's backend;
  4. model parity: the flagship at full width and 2 layers in f32 prefills
     a 600-token prompt in chunks (fresh flash, append flash, masked tail)
     and decodes 16 greedy tokens, once into a contiguous cache and once
     through a paged pool (bt 16, decode on the paged kernel's f32 route),
     on the card, against the contiguous run on the CPU: logits agree
     within 2e-3 and the greedy tokens are identical;
  4b. graphs: the full flagship (28 layers, bf16, seed 0), 4 slots with
     ctx 4096, contiguous and paged (1024 blocks of 16): 32 replays of
     the decode step's captured CUDA graph equal 32 eager steps (tokens,
     logits, KV bytes, carries) over rows at different positions, one
     sampled (temperature 0.8, top_k 50) and one free; the replay's
     device and wall ms beside the eager step's; generate's captured
     16-step chunks equal the step-by-step loop, greedy and sampled;
  5. serving: the full flagship (28 layers, bf16, seed 0) behind the
     port's HTTP server with 4 slots and ctx 4096 (contiguous pool, prefix
     cache on at its default; every decode step a graph replay) answers 4 concurrent chats and one SSE chat;
     each concurrent result equals the same request sent alone (a rerun
     may hit the prefix cache), and the bf16 flash kernel's launch counts
     show both modes ran;
  6. prefix and paged serving, same model and server: (a) a paged pool of
     1024 blocks of 16 tokens answers phase 5's chats, each equal to the
     same request alone, with 28 paged decode launches per replay of the
     engine's decode graph and both flash modes launched by the paged
     prefill;
     (b) four chats sharing a 560-character system message hit at least
     512 prompt tokens after the first, in both modes (blocks shared
     while they run, in paged mode), with tokens equal to the same mode
     with the cache off; (c) (a)'s chats on a 96-block pool, the last two
     arriving while the first two decode: at least one swap preemption,
     no failure, tokens equal to (a)'s;
  7. the flagship written as a checkpoint directory, loaded bit for bit
     and served through `cli serve DIR`, contiguous and paged;
  8. OLMo2, EXAONE4 and Phi-4 at their published widths, depth cut:
     f32 card vs CPU, bf16 graph vs eager, EXAONE4 served paged;
  9. Gemma-3-1B at its published widths (head_dim 256, window 512, GQA
     4/1, sandwich (1+w) norms, GELU-tanh, local RoPE, vocab 262144):
     (a) f32 at 6 layers (one global) against the CPU on a 600-token
     prompt that wraps the 512-token rings, contiguous and paged; (b) the
     full 26 layers in bf16, written as a checkpoint with a Gemma-style
     byte-fallback tokenizer and loaded through build_text_model: 16
     captured decode replays equal 16 eager steps in both pools; (c) the
     same directory served through `cli serve DIR`, contiguous and paged:
     4 concurrent chats and one SSE chat, all 200, each equal alone and
     in company, the engine's prompt ids those of a fresh CPU tokenizer;
  then prints the kernels line, the card line, and the result line last.

Imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

BF16_TOL = 2e-2     # bf16 output rounding (ulp 2^-7 near 1) + sum order
F32_TOL = 1e-4      # float32 summation order only
LOGIT_TOL = 2e-3    # f32 model on card vs CPU (cuBLAS vs MKL sum order)

H100_PEAK_FLOPS = {"bf16": 989e12,   # dense tensor-core peak, H100 SXM
                   "tf32": 495e12,
                   "f32": 67e12}     # float32 outside the tensor cores
# TF32 products per float32-accurate product on the f32 route (3xTF32:
# hi.hi + hi.lo + lo.hi)
TF32_PRODUCTS = 3
H100_HBM_BYTES_S = 3.35e12
CUOBJDUMP = "/usr/local/cuda/bin/cuobjdump"   # the CUDA toolkit's

class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


# -- phase 2: build ----------------------------------------------------------


def phase_build() -> dict:
    from cake_tpu_torch.kernels.build import build_all
    from cake_tpu_torch.ops import flash
    t = time.perf_counter()
    built = build_all()
    for name, info in built.items():
        print(f"build {name}: {info['seconds']:.1f}s", flush=True)
        if name == "paged_decode":
            continue              # its report opens phase 3b
        for ln in info["log"].splitlines():
            if any(w in ln for w in ("entry function", "registers", "spill",
                                     "smem", "wgmma", "arning")):
                print(f"  {ln.strip()}")
    print(f"build total {time.perf_counter() - t:.1f}s", flush=True)
    cuobjdump = shutil.which("cuobjdump") or (
        CUOBJDUMP if os.path.exists(CUOBJDUMP) else None)
    if cuobjdump is None:
        print("cuobjdump not found: tensor-core counts not taken",
              flush=True)
        return built
    for route, word, what in (("bf16", "HGMMA", "HGMMA (wgmma)"),
                              ("f32", "TF32", "HMMA .TF32 (mma.sync)")):
        sass = subprocess.run(
            [cuobjdump, "-sass", built[flash.LIBRARIES[route]]["path"]],
            capture_output=True, text=True, timeout=300)
        check(sass.returncode == 0, f"cuobjdump failed: {sass.stderr}")
        n = sum(word in ln and "MMA" in ln for ln in sass.stdout.splitlines())
        print(f"{what} instructions in {flash.SOURCES[route]}: {n}",
              flush=True)
        check(n > 0, f"the {route} flash kernel has no {what} instruction")
    return built


# -- phase 3: kernels --------------------------------------------------------


def flash_case(name, dtype, sq=256, skv=None, hq=16, hkv=8, d=128,
               valid_len=None, q_offset=None, window=None, pool_rows=None):
    """Inputs of one flash case on the card. With pool_rows, K/V are a
    strided batch-1 view of row 1 of a [3, pool_rows, Hkv, D] pool, as
    in append mode."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(
        sum(map(ord, name)))
    skv = sq if skv is None else skv

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)
    q = rnd(1, sq, hq, d)
    if pool_rows:
        k = rnd(3, pool_rows, hkv, d)[1:2]
        v = rnd(3, pool_rows, hkv, d)[1:2]
    else:
        k, v = rnd(1, skv, hkv, d), rnd(1, skv, hkv, d)
    kw = dict(valid_len=valid_len, q_offset=q_offset, window=window)
    return q, k, v, kw


FLASH_CASES = [
    ("fresh", {}),
    ("fresh_valid200", dict(valid_len=200)),
    ("sq300", dict(sq=300)),
    ("window128", dict(window=128)),
    ("append", dict(pool_rows=4096, q_offset=256, valid_len=256)),
    ("d64_mha", dict(hq=8, hkv=8, d=64)),
]

def family_flash_cases() -> list:
    """The checkpoint families' attention shapes at their published widths
    (synth_checkpoint.family_attention): fresh at the served chunk (Sq
    256) with the family's window (EXAONE4's and Gemma3's local layers),
    and append. A window shorter than 600 also gets a fresh case at Sq
    600, where the window masks: the chunk alone never reaches past it."""
    from cake_tpu_torch.bench.synth_checkpoint import (FAMILIES,
                                                       family_attention)
    cases = []
    for fam in FAMILIES:
        a = family_attention(fam)
        shape = dict(hq=a["hq"], hkv=a["hkv"], d=a["d"])
        fresh = dict(shape, window=a["window"])
        cases.append((f"{fam}_fresh", fresh))
        if a["window"] and a["window"] < 600:
            cases.append((f"{fam}_fresh_window", dict(fresh, sq=600)))
        cases.append((f"{fam}_append", dict(shape, **FLASH_CASES[4][1])))
    return cases


def visible_pairs(sq, limit, q_offset, window, skv) -> int:
    """(query, key) pairs the masks leave visible: the work this run's
    data needs."""
    import torch
    qp = q_offset + torch.arange(sq)[:, None]
    kp = torch.arange(min(limit, skv))[None, :]
    m = kp <= qp
    if window:
        m &= kp > qp - window
    return int(m.sum())


def flash_bound_ms(q, k, kw, peak_flops=None) -> tuple[float, str]:
    """Least time on an H100 SXM: the larger of FLOPs over the peak for
    q's type and bytes (q read, K/V rows below the limit read, output
    written, once each) over HBM bandwidth. bf16: the tensor cores' peak;
    float32: three TF32 products per product over the TF32 peak, the
    least time for float32-accurate products on this card (3xTF32).
    `peak_flops` overrides the FLOP rate (FLOPs counted once)."""
    import torch
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    off = kw.get("q_offset") or 0
    limit = off + (kw.get("valid_len") or sq)
    rows = min(limit, k.shape[1])
    flops = 4.0 * visible_pairs(sq, limit, off, kw.get("window"),
                                k.shape[1]) * hq * d * b
    el = q.element_size()
    nbytes = el * b * (2 * sq * hq * d + 2 * rows * hkv * d)
    if peak_flops is not None:
        t_ops = flops / peak_flops
    elif q.dtype == torch.bfloat16:
        t_ops = flops / H100_PEAK_FLOPS["bf16"]
    else:
        t_ops = TF32_PRODUCTS * flops / H100_PEAK_FLOPS["tf32"]
    t_bytes = nbytes / H100_HBM_BYTES_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def _library_args(q, k, v, kw):
    """Arguments of scaled_dot_product_attention for the same function:
    [B, H, S, D] views, and a causal flag or an explicit mask."""
    import torch
    off = kw.get("q_offset") or 0
    limit = off + (kw.get("valid_len") or q.shape[1])
    qt = q.transpose(1, 2)
    kt = k[:, :limit].transpose(1, 2)
    vt = v[:, :limit].transpose(1, 2)
    if off == 0 and limit >= k.shape[1] and not kw.get("window"):
        return (qt, kt, vt), dict(is_causal=True, enable_gqa=True)
    qp = off + torch.arange(q.shape[1], device="cuda")[:, None]
    kp = torch.arange(kt.shape[2], device="cuda")[None, :]
    mask = kp <= qp
    if kw.get("window"):
        mask &= kp > qp - kw["window"]
    return (qt, kt, vt), dict(attn_mask=mask, enable_gqa=True)


def library_call(q, k, v, kw):
    """One PyTorch call computing the same function (yardstick only: the
    port never calls it): scaled_dot_product_attention on [B, H, S, D]."""
    import torch.nn.functional as F
    args, sdpa_kw = _library_args(q, k, v, kw)
    return lambda: F.scaled_dot_product_attention(*args, **sdpa_kw)


def library_backend(q, k, v, kw) -> str:
    """The backend scaled_dot_product_attention picks for these inputs
    (the choice its dispatcher makes, read without running it)."""
    import torch
    from torch.nn.attention import SDPBackend
    args, sdpa_kw = _library_args(q, k, v, kw)
    return SDPBackend(torch._fused_sdp_choice(*args, **sdpa_kw)).name


def phase_kernels() -> dict:
    import torch
    from cake_tpu_torch.bench.timing import device_ms, issue_ms
    from cake_tpu_torch.ops.flash import (flash_attention_kernel,
                                          flash_attention_ref, kernel_route,
                                          plan_flash)
    family = family_flash_cases()
    for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)):
        for name, spec in FLASH_CASES + family:
            q, k, v, kw = flash_case(name, dtype, **spec)
            got = flash_attention_kernel(q, k, v, **kw)
            again = flash_attention_kernel(q, k, v, **kw)
            torch.cuda.synchronize()
            want = flash_attention_ref(q, k, v, **kw)
            err = (got.float() - want.float()).abs().max().item()
            print(f"flash {name:15s} {kernel_route(dtype)} Hq/Hkv "
                  f"{q.shape[2]}/{k.shape[2]} D {q.shape[3]} max_abs_err "
                  f"{err:.3e} (tol {tol:g})", flush=True)
            check(err <= tol and torch.isfinite(got).all().item(),
                  f"flash {name} {dtype}: max_abs_err {err} > {tol}")
            check(torch.equal(got, again),
                  f"flash {name} {dtype}: two launches differ")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for d in (64, 128, 256):
        plan = plan_flash((1, 256, 4, d), (1, 256, 1, d), window=512)
        print(f"flash plan bf16 D {d} (Sq 256, Hq/Hkv 4/1): {plan.ctas} "
              f"CTAs of {plan.positions} positions, {plan.threads} "
              f"threads, {plan.stages}-stage K/V ring, shared memory "
              f"{plan.smem_bytes} B per CTA", flush=True)
        plan = plan_flash((1, 256, 4, d), (1, 256, 1, d), window=512,
                          route="f32", sms=sms)
        print(f"flash plan f32 D {d} (Sq 256, Hq/Hkv 4/1): {plan.ctas} "
              f"row groups of {plan.rows} packed rows, each over a cluster "
              f"of {plan.split} CTAs ({sms} SMs), {plan.threads} threads, "
              f"{plan.slots} slots of {plan.block_keys}-key tiles per warp, "
              f"shared memory {plan.smem_bytes} B per CTA", flush=True)
    timings = {}
    for entry, dtype, spec in (
            ("fresh", torch.bfloat16, {}),
            ("append", torch.bfloat16, FLASH_CASES[4][1]),
            ("f32", torch.float32, {}),
            ("f32_append", torch.float32, FLASH_CASES[4][1]),
            *((name, torch.bfloat16, spec) for name, spec in family),
            *((f"{fam}_f32{mode}", torch.float32,
               dict(family)[f"{fam}_{entry}"])
              for fam in ("phi4", "gemma3")
              for mode, entry in (("", "fresh"), ("_append", "append"))),
            ("gemma3_f32_window", torch.float32,
             dict(family)["gemma3_fresh_window"])):
        q, k, v, kw = flash_case(entry, dtype, **spec)
        err = (flash_attention_kernel(q, k, v, **kw).float()
               - flash_attention_ref(q, k, v, **kw).float()).abs().max()

        def kern():
            return flash_attention_kernel(q, k, v, **kw)
        # device time: events around calls queued behind a spin, so the
        # host's issue rate (issue_ms) does not set it
        t = {
            "max_abs_err": err.item(), "ms": device_ms(kern),
            "issue_ms": issue_ms(kern),
            "plain_ms": device_ms(
                lambda: flash_attention_ref(q, k, v, **kw), iters=10),
            "library_ms": device_ms(library_call(q, k, v, kw)),
        }
        t["bound_ms"], t["bound_by"] = flash_bound_ms(q, k, kw)
        fma_bound = ""
        if dtype == torch.float32:   # the bound on FMA (no tensor cores)
            t["fma_bound_ms"] = flash_bound_ms(
                q, k, kw, H100_PEAK_FLOPS["f32"])[0]
            fma_bound = f" (FMA bound {t['fma_bound_ms']:.5f})"
        timings[entry] = t
        print(f"flash timing {entry}: {kernel_route(dtype)} Sq={q.shape[1]} "
              f"Hq/Hkv="
              f"{q.shape[2]}/{k.shape[2]} D={q.shape[3]} window="
              f"{kw.get('window')} Skv_row={k.shape[1]} device ms: kernel "
              f"{t['ms']:.5f} plain {t['plain_ms']:.5f} library "
              f"{t['library_ms']:.5f}; kernel issue_ms {t['issue_ms']:.5f}; "
              f"bound_ms {t['bound_ms']:.5f} ({t['bound_by']}), share of "
              f"bound {t['bound_ms'] / t['ms']:.3f}{fma_bound}; max_abs_err "
              f"{t['max_abs_err']:.3e}", flush=True)
        print(f"  library backend: {library_backend(q, k, v, kw)}",
              flush=True)
    return timings


# -- phase 3b: the paged decode kernel ----------------------------------------


def ptxas_report(log: str) -> list[str]:
    """ptxas's lines for each kernel of a build log: the function, its
    registers and shared memory, and its spills."""
    return [ln.strip() for ln in log.splitlines()
            if any(w in ln for w in ("Compiling entry function",
                                     "registers", "spill"))]


def phase_paged_kernels(build_log: str) -> dict:
    """The paged decode kernel: its plan at the serving shape and how many
    of its clusters the card holds at once, ptxas's report, then the kernel
    against its plain version in every case, bit-identical across two
    launches, and timed at the serving shape (4 rows at p = 620, bt 16) in
    both routes and at 4 rows at p = 4000 in bf16."""
    import torch
    from cake_tpu_torch.bench import paged_timing
    from cake_tpu_torch.bench.paged_cases import (CARD_CASES, case_args,
                                                  paged_case)
    from cake_tpu_torch.ops import paged_attention as pa
    gemma = dict(hq=4, hkv=1, d=256)
    for dtype, shape in ((torch.bfloat16, {}), (torch.float32, {}),
                         (torch.bfloat16, gemma), (torch.float32, gemma)):
        c = paged_case([620] * 4, dtype=dtype, device="cuda", seed=620,
                       **shape)
        plan = pa.plan_paged(c["q"].shape, c["k"].shape, c["tables"].shape,
                             dtype)
        clusters = pa.active_clusters(*case_args(c))
        print(f"paged decode plan {pa.kernel_route(dtype)}: 4 rows, bt 16, "
              f"Hq/Hkv {c['q'].shape[2]}/{c['k'].shape[2]}, D "
              f"{c['q'].shape[3]}: grid {plan.grid}, cluster "
              f"{plan.cluster}, stages {plan.stages}, shared memory "
              f"{plan.smem_bytes} B per CTA, {plan.ctas_per_sm} CTAs per SM "
              f"by shared memory and threads; active clusters {clusters} "
              f"(the launch has {plan.grid[1] * plan.grid[2]})", flush=True)
        check(clusters >= 1, f"no cluster of the paged decode launch fits")
    print("paged decode ptxas report:", flush=True)
    for ln in ptxas_report(build_log):
        print(f"  {ln}", flush=True)
    for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)):
        for name, spec in CARD_CASES:
            c = paged_case(dtype=dtype, device="cuda", **spec)
            got = pa.paged_decode_attention_kernel(*case_args(c))
            again = pa.paged_decode_attention_kernel(*case_args(c))
            torch.cuda.synchronize()
            want = pa.paged_decode_attention_ref(*case_args(c))
            rows = c["visible_rows"]
            err = (got[rows].float() - want[rows].float()).abs().max().item()
            print(f"paged decode {name:22s} {pa.kernel_route(dtype)} "
                  f"max_abs_err {err:.3e} (tol {tol:g})", flush=True)
            check(err <= tol and torch.isfinite(got).all().item(),
                  f"paged decode {name} {dtype}: max_abs_err {err} > {tol}")
            check(torch.equal(got, again),
                  f"paged decode {name} {dtype}: two launches differ")
    timings = paged_timing.measure(
        with_plain=True,
        shapes=paged_timing.SHAPES + paged_timing.family_shapes() + (
            ("f32_gemma3", "float32", 620, dict(hq=4, hkv=1, d=256)),))
    for entry, t in timings.items():
        tol = F32_TOL if entry.startswith("f32") else BF16_TOL
        check(t["max_abs_err"] <= tol and t["same_bits"],
              f"paged decode timing {entry}: max_abs_err {t['max_abs_err']}"
              f" (tol {tol}), two launches equal {t['same_bits']}")
        print(f"paged decode timing {entry}: 4 rows at p={t['p']}, bt 16, "
              f"Hq/Hkv={t['hq']}/{t['hkv']} D={t['d']}, device ms: kernel "
              f"{t['ms']:.5f} plain "
              f"{t['plain_ms']:.5f} library {t['library_ms']:.5f} "
              f"({t['library_backend']}, over pre-gathered live rows: "
              f"gather not timed); kernel issue_ms {t['issue_ms']:.5f}; "
              f"bound_ms {t['bound_ms']:.5f} ({t['bound_by']}), share of "
              f"bound {t['bound_ms'] / t['ms']:.3f}; max_abs_err "
              f"{t['max_abs_err']:.3e}", flush=True)
    return timings


# -- phase 4: model parity ---------------------------------------------------


def _greedy(model, logits, n, decode, n_greedy):
    """n_greedy greedy tokens off prefill logits; decode(p, tok, pos,
    recent, carries) runs one batch-1 decode step at host position p, with
    carries (key, counter, sampling settings, active)."""
    import torch
    from cake_tpu_torch.ops.sampling import SamplingConfig
    dev = model.device
    recent = torch.full((1, 64), -1, dtype=torch.int32, device=dev)
    tok = model.sample_one(logits, 0, 0, SamplingConfig(), recent)
    toks = [int(tok[0])]
    pos = torch.tensor([n], dtype=torch.int32, device=dev)
    greedy = [torch.tensor([v], dtype=dt, device=dev) for v, dt in (
        (0, torch.int64), (1, torch.int64), (0.0, torch.float32),
        (model.cfg.vocab_size, torch.int32), (1.0, torch.float32),
        (1.0, torch.float32), (True, torch.bool))]
    while len(toks) < n_greedy:
        _, tok, pos, recent, greedy[1] = decode(n + len(toks) - 1, tok, pos,
                                                recent, greedy)
        toks.append(int(tok[0]))
    return toks


def chunked_prefill_and_greedy(model, ids, n_greedy=16):
    """Prefill `ids` in 256-token chunks into a 4096-row cache, then
    greedy-decode n_greedy tokens. Returns (last logits, tokens, flash
    launches by mode during the prefill)."""
    from cake_tpu_torch.ops import flash
    cache = model.new_cache(1, kv_len=4096)
    flash.reset_launches()
    logits = None
    for p0 in range(0, len(ids), 256):
        logits, cache = model.prefill(cache, ids[p0:p0 + 256], p0)
    launches = flash.launch_counts()
    toks = _greedy(model, logits, len(ids),
                   lambda p, tok, pos, rec, g: model.decode_slots(
                       cache["layers"], tok, pos, rec, *g), n_greedy)
    return logits.float().cpu(), toks, launches


def paged_prefill_and_greedy(model, ids, n_greedy=16):
    """The same through a paged pool (one slot, ctx 4096, blocks of 16):
    prefill_chunk_paged per chunk, decode_slots_paged per token, blocks
    reserved ahead as the engine does. Returns (last logits, tokens, paged
    decode launches by route)."""
    from cake_tpu_torch.ops import paged_attention as pa
    from cake_tpu_torch.serve.paged import PagedKV
    pk = PagedKV.build(model, 1, 4096, 64, 16, 256)
    pa.reset_launches()
    logits = None
    for p0 in range(0, len(ids), 256):
        chunk = ids[p0:p0 + 256]
        check(pk.reserve_range(0, p0, len(chunk)), "paged pool too small")
        logits = pk.prefill_into(0, chunk, p0)

    def decode(p, tok, pos, rec, g):
        check(pk.reserve_range(0, p, 1), "paged pool too small")
        return model.decode_slots_paged(pk.pool, pk.rows, pk.tables, tok,
                                        pos, rec, *g)
    toks = _greedy(model, logits, len(ids), decode, n_greedy)
    return logits.float().cpu(), toks, pa.launch_counts()


def phase_parity() -> tuple[dict, int]:
    """600 tokens in chunks of 256: fresh flash, append flash, then a
    88-token tail (bucket 128 < FLASH_MIN_SEQ) on the masked path, then 16
    greedy tokens; contiguous and paged on the card against contiguous on
    the CPU. Returns the f32 flash launches by mode and the f32 paged
    decode launches."""
    import torch
    from cake_tpu_torch.cli import build_flagship
    from cake_tpu_torch.models import TextModel
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cpu = build_flagship(layers=2, dtype="f32", seed=1, device="cpu")
    params = _to_device(cpu.params, "cuda")
    gpu = TextModel(cpu.cfg, params, dtype=torch.float32, device="cuda")
    ids = [int(x) for x in torch.randint(
        0, cpu.cfg.vocab_size, (600,),
        generator=torch.Generator().manual_seed(5))]
    lg, tg, launches = chunked_prefill_and_greedy(gpu, ids)
    lp, tp, paged_launches = paged_prefill_and_greedy(gpu, ids)
    lc, tc, _ = chunked_prefill_and_greedy(cpu, ids)
    err = (lg - lc).abs().max().item()
    err_p = (lp - lc).abs().max().item()
    print(f"parity flagship width, 2 layers, f32, 600-token chunked "
          f"prefill: flash launches {launches}; logits max_abs_err "
          f"{err:.3e} (tol {LOGIT_TOL:g}); 16 greedy tokens identical "
          f"{tg == tc}", flush=True)
    print(f"parity paged (bt 16): paged decode launches {paged_launches}; "
          f"logits max_abs_err {err_p:.3e} (tol {LOGIT_TOL:g}); 16 greedy "
          f"tokens identical {tp == tc}", flush=True)
    check(launches == {"bf16": {"fresh": 0, "append": 0},
                       "f32": {"fresh": 2, "append": 2}},
          f"unexpected flash launches {launches}")
    check(err <= LOGIT_TOL, f"logits differ by {err}")
    check(tg == tc, f"greedy tokens differ: {tg} vs {tc}")
    check(paged_launches == {"bf16": 0, "f32": 2 * 15},
          f"unexpected paged decode launches {paged_launches}")
    check(err_p <= LOGIT_TOL, f"paged logits differ by {err_p}")
    check(tp == tc, f"paged greedy tokens differ: {tp} vs {tc}")
    return launches["f32"], paged_launches["f32"]


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    return tree.to(device)


# -- phase 4b: the decode step as a captured CUDA graph -----------------------


GRAPH_STEPS = 32


def phase_graphs(model, card: str) -> None:
    """The full flagship (28 layers, bf16), 4 slots with ctx 4096,
    contiguous and paged (1024 blocks of 16): rows at positions 600, 1100
    and 300 (greedy, sampled at temperature 0.8 / top_k 50, greedy) and a
    free row. 32 replays of the captured step equal 32 eager steps in
    tokens, logits, every KV byte and every carry. Then each step's
    replay against the eager step, timed; then generate's captured chunks
    against the step-by-step loop, greedy and sampled."""
    import torch
    from cake_tpu_torch.bench.graph_cases import (build_state,
                                                  graph_vs_eager,
                                                  step_by_step)
    from cake_tpu_torch.bench.timing import (device_ms, issue_ms,
                                             kernel_times, wall_ms)
    from cake_tpu_torch.models.common.text_model import GEN_CHUNK
    from cake_tpu_torch.ops.sampling import SamplingConfig
    greedy = SamplingConfig(temperature=0.0)
    sampled = SamplingConfig(temperature=0.8, top_k=50)
    for mode, kv_blocks in (("contiguous", 0), ("paged", 1024)):
        state = build_state(model, [600, 1100, None, 300],
                            [greedy, sampled, greedy, greedy], 4096,
                            kv_blocks=kv_blocks, seed=6)
        r = graph_vs_eager(model, state, GRAPH_STEPS)
        sampled_toks = r["tokens"][:, 1, 1].tolist()
        print(f"graph {mode}: {GRAPH_STEPS} replays vs eager steps, rows at "
              f"600/1100/300 (row 1 sampled at 0.8, top_k 50) + 1 free: "
              f"tokens identical {r['tokens_equal']}, KV bytes identical "
              f"{r['kv_equal']}, carries identical {r['carries_equal']}, "
              f"max abs logit diff {r['max_logit_diff']:.3e}; launches per "
              f"replay {r['graph'].launches_per_step}; sampled row's tokens "
              f"{sampled_toks[:8]}...", flush=True)
        check(r["graph"].graph is not None, f"graph {mode}: not captured")
        check(r["tokens_equal"] and r["kv_equal"] and r["carries_equal"],
              f"graph {mode}: replays differ from eager steps")
        check(len(set(sampled_toks)) > 1,
              f"graph {mode}: the sampled row drew one token throughout")
        graph, eager = r["graph"], r["eager"].step_fn(model)
        replay_ms = device_ms(graph.step)
        replay_wall = wall_ms(graph.step, 20)
        eager_wall = wall_ms(eager, 10)
        # the eager step's ~1,000 launches fill the launch queue, so a spin
        # cannot hold them: its device time is the profiler's kernel sum
        kernels = sum(row[0] for row in kernel_times(eager, 5))
        eager_dev = (f"kernel sum {kernels:.4f} (idle "
                     f"{1 - kernels / eager_wall:.3f})" if kernels else
                     "device ms not measured (the profiler saw no kernel)")
        # two clocks: a replay's device ms can read above its wall ms
        print(f"graph {mode} step timing (4 slots, 28 layers, bf16): replay "
              f"device ms {replay_ms:.4f}, replay wall ms {replay_wall:.4f} "
              f"(idle {max(0.0, 1 - replay_ms / replay_wall):.3f}); eager "
              f"step wall ms "
              f"{eager_wall:.4f}, {eager_dev}; on {card}", flush=True)
        del state, r, graph, eager
        torch.cuda.empty_cache()
    ids = [int(x) for x in torch.randint(
        0, 256, (600,), generator=torch.Generator().manual_seed(9))]
    for label, scfg in (("greedy", greedy), ("sampled", sampled)):
        got, stats = model.generate(ids, 64, scfg, seed=4)
        want = step_by_step(model, ids, 64, scfg, seed=4)
        print(f"generate {label}: 600-token prompt, 64 tokens in captured "
              f"chunks of {GEN_CHUNK} equal to the step-by-step loop "
              f"{got == want}; {stats['tok_per_s']:.1f} tok/s", flush=True)
        check(got == want, f"generate {label}: {got} != {want}")
    run = next(iter(model._runners.values()))
    # a chunk's ~16,000 graph nodes do not queue behind a spin (the host
    # blocks until the card drains them), so events around back-to-back
    # replays time it: the slower of the host and the card
    chunk_ms = issue_ms(run.graph.step, iters=5, warmup=1)
    print(f"generate chunk replay: event ms {chunk_ms:.4f} per "
          f"{GEN_CHUNK} steps ({chunk_ms / GEN_CHUNK:.4f} per token, back to "
          f"back); wall per token {1e3 / stats['tok_per_s']:.4f} ms (the "
          f"sampled run); on {card}", flush=True)


# -- phases 5 and 6: serving -------------------------------------------------


def _post(url, body, timeout=600):
    req = urllib.request.Request(
        url + "/v1/chat/completions", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.read()


def _prompt(i: int) -> str:
    words = ("tensor", "kernel", "warp", "slot", "chunk", "prefill",
             "decode", "cache", "token", "stream")
    text = " ".join(words[(i * 7 + j * 3) % len(words)] for j in range(90))
    return f"request {i}: {text}"[:600]


SYSTEM = ("You are the support desk of a GPU cloud. Answer in short, plain "
          "sentences, name the card and its power limit beside every "
          "number, and never guess a figure you were not given. " * 4)[:560]


def chat_body(i: int, stream: bool = False, shared: bool = False) -> dict:
    """Phase 5's chat i, or (shared) a question under the common system
    message, whose first 512 prompt tokens are the same for every i."""
    messages = [{"role": "user", "content": _prompt(i)}]
    if shared:
        messages = [{"role": "system", "content": SYSTEM},
                    {"role": "user", "content": f"question {i}: which card "
                     f"serves slot {i} and at what limit?"}]
    return {"messages": messages, "temperature": 0, "max_tokens": 32,
            "stream": stream}


class Served:
    """A started server (`create_app`) and its engine; keeps every
    ServeRequest by id, for its token ids and prompt ids."""

    def __init__(self, app):
        self.app = app
        self.engine = app.state.engine
        self.reqs = {}
        submit = self.engine.submit

        def recording_submit(*a, **kw):
            r = submit(*a, **kw)
            self.reqs[r.id] = r
            return r
        self.engine.submit = recording_submit

    def chat(self, body: dict) -> dict:
        """POST one chat; returns {status, resp (JSON) or events (SSE),
        tokens, stats, seconds}."""
        t = time.perf_counter()
        status, raw = _post(self.app.url, body)
        out = {"status": status, "seconds": time.perf_counter() - t}
        if body.get("stream"):
            out["events"] = [ln[6:] for ln in raw.decode().splitlines()
                             if ln.startswith("data: ")]
            rid = json.loads(out["events"][0])["id"]
        else:
            out["resp"] = json.loads(raw)
            rid = out["resp"]["id"]
        out["tokens"] = self.reqs[rid].result["tokens"]
        out["stats"] = self.reqs[rid].result["stats"]
        return out

    def concurrent(self, bodies: list[dict], during=None) -> list[dict]:
        """POST the bodies at once; `during()` is polled while they run.
        Fails on any error or hang."""
        results, errors = [None] * len(bodies), []

        def worker(i):
            try:
                results[i] = self.chat(bodies[i])
            except Exception as e:     # reported below, phase fails
                errors.append(f"request {i}: {e!r}")
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(len(bodies))]
        for th in threads:
            th.start()
        while during is not None and any(th.is_alive() for th in threads):
            during()
            time.sleep(0.005)
        for th in threads:
            th.join(timeout=900)
        check(not errors, f"serving errors: {errors}")
        check(all(not th.is_alive() for th in threads), "requests hung")
        for i, r in enumerate(results):
            check(r["status"] == 200, f"request {i}: HTTP {r['status']}")
        return results

    def close(self):
        self.app.stop()


def serve_model(model, **engine_kw) -> Served:
    """The model behind the port's HTTP server with one engine (4 slots,
    ctx 4096)."""
    from cake_tpu_torch.api import create_app
    from cake_tpu_torch.serve import ServeEngine
    engine = ServeEngine(model, slots=4, ctx_len=4096, **engine_kw)
    return Served(create_app(model, engine, model.tokenizer,
                             port=0).start())


def _check_chats(results: list[dict], label: str) -> None:
    for i, r in enumerate(results):
        if "events" in r:
            ev = r["events"]
            check(ev and ev[-1] == "[DONE]",
                  f"{label}: SSE stream did not end with [DONE]")
            n = sum(1 for e in ev[:-1]
                    if json.loads(e)["choices"][0]["delta"].get("content"))
            check(n > 0, f"{label}: SSE stream carried no content")
        else:
            check(r["resp"]["usage"]["completion_tokens"] > 0,
                  f"{label} request {i}: no completion tokens")


def _alone_equals_concurrent(served, bodies, results, label) -> list[int]:
    """Send each non-streamed body again alone; its tokens and content
    must equal the concurrent run's. Returns each rerun's prefix hit."""
    hits = []
    for i, body in enumerate(bodies):
        if body.get("stream"):
            continue
        alone = served.chat(body)
        check(alone["status"] == 200, f"{label} alone {i}: HTTP "
              f"{alone['status']}")
        check(alone["tokens"] == results[i]["tokens"],
              f"{label} request {i}: concurrent tokens "
              f"{results[i]['tokens']} != alone {alone['tokens']}")
        check(alone["resp"]["choices"][0]["message"]["content"]
              == results[i]["resp"]["choices"][0]["message"]["content"],
              f"{label} request {i}: content differs alone vs concurrent")
        hits.append(alone["stats"]["prefix_hit_tokens"])
    return hits


def _latency(results: list[dict]) -> tuple[float, float]:
    """(TTFT p50 ms, decode tok/s per request p50) of the chats."""
    stats = [r["stats"] for r in results]
    ttft = sorted(s["ttft_s"] for s in stats)
    tps = sorted(s["tok_per_s"] for s in stats)
    return ttft[len(ttft) // 2] * 1e3, tps[len(tps) // 2]


def phase_serve(model, card: str) -> tuple[dict, list]:
    """Phase 5: contiguous pool, prefix cache on at its default. Returns
    the flash launches and the 4 chats' results."""
    import torch
    from cake_tpu_torch.ops import flash
    served = serve_model(model)
    try:
        check(served.engine.graph.graph is not None,
              "phase 5: the engine captured no graph")
        bodies = [chat_body(i) for i in range(4)] + [chat_body(4, True)]
        flash.reset_launches()
        torch.cuda.synchronize()
        results = served.concurrent(bodies)
        torch.cuda.synchronize()
        counts = flash.launch_counts()
        _check_chats(results, "phase 5")
        print(f"serve flash launches (4 concurrent + 1 SSE, 28 layers): "
              f"{counts}", flush=True)
        launches = counts["bf16"]
        check(launches["fresh"] >= 28 * 4, f"fresh launches {counts}")
        check(launches["append"] > 0, f"append launches {counts}")
        check(sum(counts["f32"].values()) == 0,
              f"the f32 route ran while serving bf16: {counts}")
        hits = _alone_equals_concurrent(served, bodies, results, "phase 5")
        ttft, tps = _latency(results[:4])
        n_prompt = results[0]["resp"]["usage"]["prompt_tokens"]
        print(f"serve: 4 concurrent chats, {n_prompt}-token prompts, 32 "
              f"tokens each: TTFT p50 {ttft:.1f} ms (of "
              f"{sorted(round(r['stats']['ttft_s'] * 1e3, 1) for r in results[:4])}"
              f"), decode tok/s per request p50 {tps:.1f}; alone reruns' "
              f"prefix_hit_tokens {hits} (prefix cache 256 MB); on {card}",
              flush=True)
        return launches, results[:4]
    finally:
        served.close()


def phase_paged_serve(model, card: str, contiguous: list) -> int:
    """Phase 6 (a)-(c). Returns the paged decode kernel's bf16 launches in
    (a)."""
    import torch
    from cake_tpu_torch.ops import flash
    from cake_tpu_torch.ops import paged_attention as pa
    layers = model.cfg.num_hidden_layers
    # (a) paged pool with the capacity of the contiguous one
    paged = serve_model(model, kv_blocks=1024, kv_block_tokens=16)
    try:
        graph = paged.engine.graph
        check(graph.graph is not None, "phase 6a: the engine captured no "
              "graph")
        bodies = [chat_body(i) for i in range(4)] + [chat_body(4, True)]
        torch.cuda.synchronize()
        pa.reset_launches()
        flash.reset_launches()
        steps = graph.steps
        results = paged.concurrent(bodies)
        torch.cuda.synchronize()
        steps = graph.steps - steps
        launches = pa.launch_counts()
        flash_counts = flash.launch_counts()
        _check_chats(results, "phase 6a")
        print(f"paged serve (a): decode launches {launches} over "
              f"{steps} replays of the paged decode step's graph x {layers} "
              f"layers; flash launches {flash_counts}", flush=True)
        check(launches == {"bf16": layers * steps, "f32": 0} and steps,
              f"paged decode launches {launches} != {layers} x {steps}")
        check(flash_counts["bf16"]["fresh"] >= layers * 4
              and flash_counts["bf16"]["append"] > 0
              and sum(flash_counts["f32"].values()) == 0,
              f"paged prefill flash launches {flash_counts}")
        hits = _alone_equals_concurrent(paged, bodies, results, "phase 6a")
        ttft, tps = _latency(results[:4])
        ttft5, tps5 = _latency(contiguous)
        same = sum(a == b for r, c in zip(results[:4], contiguous)
                   for a, b in zip(r["tokens"], c["tokens"]))
        total = sum(len(c["tokens"]) for c in contiguous)
        print(f"paged serve (a): TTFT p50 {ttft:.1f} ms, decode tok/s per "
              f"request p50 {tps:.1f} (contiguous, phase 5: {ttft5:.1f} ms, "
              f"{tps5:.1f}); alone reruns' prefix_hit_tokens {hits}; greedy "
              f"tokens equal to phase 5's contiguous ones: {same} of {total} "
              f"(reported, not gated: the kernel's bf16 sums differ from the "
              f"torch path's); on {card}", flush=True)
        want = [r["tokens"] for r in results[:4]]
        # (b) shared system prompt, both modes, cache on vs off
        shared_bodies = [chat_body(i, shared=True) for i in range(4)]
        shared_max = [0]

        def watch():
            shared_max[0] = max(shared_max[0],
                                paged.engine.health()["kv_pool"]["shared"])

        def shared_run(served, during=None):
            first = served.chat(shared_bodies[0])
            check(first["status"] == 200, "phase 6b first chat failed")
            rest = served.concurrent(shared_bodies[1:], during)
            return [first] + rest
        on = {"paged": shared_run(paged, watch)}
    finally:
        paged.close()
    for mode, kw in (("contiguous", {}),
                     ("contiguous, cache off", {"prefix_cache_mb": 0}),
                     ("paged, cache off", {"prefix_cache_mb": 0,
                                           "kv_blocks": 1024,
                                           "kv_block_tokens": 16})):
        served = serve_model(model, **kw)
        try:
            on[mode] = shared_run(served)
        finally:
            served.close()
    for mode in ("contiguous", "paged"):
        got = on[mode]
        hits = [r["stats"]["prefix_hit_tokens"] for r in got]
        same = [r["tokens"] for r in got] == \
            [r["tokens"] for r in on[f"{mode}, cache off"]]
        print(f"prefix (b) {mode}: {got[0]['resp']['usage']['prompt_tokens']}"
              f"-token prompts sharing a {len(SYSTEM)}-character system "
              f"message: prefix_hit_tokens {hits}; tokens equal to the "
              f"cache-off run {same}"
              + (f"; most shared blocks while they ran {shared_max[0]}"
                 if mode == "paged" else ""), flush=True)
        check(all(h >= 512 for h in hits[1:]),
              f"{mode}: prefix hits {hits} below 512 after the first")
        check(same, f"{mode}: tokens differ between prefix cache on and off")
    check(shared_max[0] > 0, "paged: no block was shared during the hits")
    # (c) swap under pressure: 96 blocks, two chats decoding when the
    # other two arrive
    tight = serve_model(model, kv_blocks=96, kv_block_tokens=16)
    try:
        first = {}

        def send(i):
            first[i] = tight.chat(chat_body(i))
        threads = [threading.Thread(target=send, args=(i,)) for i in (0, 1)]
        for th in threads:
            th.start()
        deadline = time.perf_counter() + 600
        while time.perf_counter() < deadline:
            live = list(tight.reqs.values())
            if len(live) == 2 and all(r.tokens for r in live):
                break
            time.sleep(0.002)
        late = tight.concurrent([chat_body(2), chat_body(3)])
        for th in threads:
            th.join(timeout=900)
        check(len(first) == 2, "phase 6c: a first chat failed")
        got = [first[0]["tokens"], first[1]["tokens"]] + \
            [r["tokens"] for r in late]
        pool = tight.engine.health()["kv_pool"]
        print(f"paged swap (c): 96 blocks of 16 tokens, kv_pool {pool}; "
              f"tokens equal to (a)'s {got == want}", flush=True)
        check(all(r["status"] == 200 for r in list(first.values()) + late),
              "phase 6c: a request failed")
        check(pool["swaps"] >= 1, "phase 6c: no swap preemption")
        check(got == want, f"phase 6c: swapped tokens {got} != (a)'s {want}")
    finally:
        tight.close()
    return launches["bf16"]


# -- phase 7: the flagship from a checkpoint directory ------------------------


def _tree_diff(a, b, path="") -> list[str]:
    """Paths where two parameter trees differ (keys, dtype, shape or
    bits)."""
    import torch
    if isinstance(a, dict):
        if a.keys() != b.keys():
            return [f"{path}: keys {sorted(a)} != {sorted(b)}"]
        return [d for k in a for d in _tree_diff(a[k], b[k], f"{path}.{k}")]
    if isinstance(a, list):
        return [d for i, (x, y) in enumerate(zip(a, b))
                for d in _tree_diff(x, y, f"{path}.{i}")]
    same = (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a, b.to(a.device)))
    return [] if same else [path]


def _cli_server(model_dir: str, *extra: str) -> Served:
    """`cli serve MODEL_DIR` with 4 slots and ctx 4096, started."""
    from cake_tpu_torch import cli
    args = cli.parser().parse_args(
        ["serve", model_dir, "--port", "0", "--slots", "4", "--ctx", "4096",
         *extra])
    return Served(cli.build_server(args).start())


def _prompt_ids_match(served, model_dir: str, bodies, label) -> None:
    """The prompt ids each request reached the engine with equal a fresh
    CPU tokenizer's chat_prompt_ids of its messages."""
    from cake_tpu_torch.runtime import CakeTokenizer
    tok = CakeTokenizer(model_dir)
    want = sorted(tok.chat_prompt_ids(b["messages"]) for b in bodies)
    got = sorted(r.prompt_ids for r in served.reqs.values())
    check(all(w in got for w in want),
          f"{label}: the engine's prompt ids differ from the tokenizer's")


def phase_checkpoint(model, card: str, workdir: str) -> dict:
    """Phase 7. The flagship (seed 0, bf16, 28 layers) written as an HF
    directory (two safetensors shards and an index, config.json, a
    byte-level BPE tokenizer.json with Qwen3's ChatML ids and a ChatML
    template), loaded through runtime.build_text_model bit-identical to
    init_params(seed 0) (here: `model`, build_flagship(seed 0)), then
    served through `cli serve DIR`, contiguous and paged (1024 blocks):
    4 concurrent chats and one SSE chat, all 200, each equal alone and in
    company, their prompt ids those of the CPU tokenizer; and generate's
    greedy tokens on a fixed id list equal `model`'s. Returns the load's
    {seconds, gb, gb_s}."""
    import torch
    from cake_tpu_torch.bench import synth_checkpoint as sc
    from cake_tpu_torch.runtime import build_text_model
    d = os.path.join(workdir, "qwen3-flagship")
    config = sc.flagship_config()
    t = time.perf_counter()
    nbytes = sc.write_model(d, config, sc.model_params(config, seed=0),
                            shards=2)
    sc.write_tokenizer(d, sc.QWEN3_SPECIALS)
    print(f"checkpoint: flagship written to {len(os.listdir(d))} files "
          f"({nbytes / 1e9:.3f} GB of tensors) in "
          f"{time.perf_counter() - t:.1f}s", flush=True)
    torch.cuda.synchronize()
    t = time.perf_counter()
    loaded, tok, model_id = build_text_model(d, "bf16", device="cuda",
                                             max_cache_len=4096)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t
    load = {"seconds": load_s, "gb": nbytes / 1e9,
            "gb_s": nbytes / 1e9 / load_s}
    diff = _tree_diff(loaded.params, model.params)
    print(f"checkpoint load: {load['gb']:.3f} GB "
          f"({loaded.cfg.num_hidden_layers} layers, bf16, 2 "
          f"shards, page cache warm) in {load_s:.3f}s = {load['gb_s']:.2f} "
          f"GB/s through build_text_model; every tensor bit-identical to "
          f"init_params(seed 0): {not diff}; on {card}", flush=True)
    check(not diff, f"loaded params differ from init_params: {diff[:5]}")
    check(model_id == "qwen3-flagship", f"model id {model_id}")
    ids = [int(x) for x in torch.randint(
        0, config["vocab_size"], (300,),
        generator=torch.Generator().manual_seed(21))]
    got, _ = loaded.generate(ids, 32)
    want, _ = model.generate(ids, 32)
    print(f"checkpoint greedy: 32 tokens off a 300-id prompt equal to "
          f"build_flagship(seed=0)'s {got == want}", flush=True)
    check(got == want, f"checkpoint greedy {got} != flagship {want}")
    del loaded
    torch.cuda.empty_cache()
    bodies = [chat_body(i) for i in range(4)] + [chat_body(4, True)]
    for mode, extra in (("contiguous", ()),
                        ("paged", ("--kv-blocks", "1024"))):
        served = _cli_server(d, *extra)
        try:
            results = served.concurrent(bodies)
            _check_chats_any(results, f"phase 7 {mode}")
            check(all(r["resp"]["model"] == "qwen3-flagship"
                      for r in results[:4]), "phase 7: model id")
            _prompt_ids_match(served, d, bodies, f"phase 7 {mode}")
            _alone_equals_concurrent(served, bodies, results,
                                     f"phase 7 {mode}")
            first = results[0]["resp"]
            print(f"checkpoint serve {mode}: 4 concurrent chats + 1 SSE, all "
                  f"200, {first['usage']['prompt_tokens']}-token prompts "
                  f"(BPE), each equal alone and in company; first reply "
                  f"{first['choices'][0]['message']['content'][:60]!r}",
                  flush=True)
        finally:
            served.close()
    shutil.rmtree(d, ignore_errors=True)
    return load


def _check_chats_any(results: list[dict], label: str) -> None:
    """Phase 5's checks for a model whose tokenizer gives most sampled ids
    no text (random weights over a small BPE vocabulary): the SSE stream
    ends with [DONE] and carries chunks, each blocking chat has tokens."""
    for i, r in enumerate(results):
        if "events" in r:
            check(r["events"] and r["events"][-1] == "[DONE]"
                  and len(r["events"]) >= 3,
                  f"{label}: SSE stream did not end with [DONE]")
        else:
            check(r["resp"]["usage"]["completion_tokens"] > 0,
                  f"{label} request {i}: no completion tokens")


# -- phase 8: the checkpoint families at their published widths ---------------

FAMILY_LAYERS = {"olmo2": 2, "exaone4": 4, "phi4": 2}


def _family_dir(fam: str, workdir: str, layers: int | None,
                name: str | None = None) -> tuple[str, int]:
    """The family's config at `layers` depth (None: its own) with seeded
    weights and randomized norms, bf16, two shards; a BPE tokenizer with
    ChatML specials at the top of its vocabulary, or for Gemma3 the
    Gemma-style tokenizer. Returns (dir, bytes of tensors)."""
    from cake_tpu_torch.bench import synth_checkpoint as sc
    d = os.path.join(workdir, name or fam)
    config = sc.family_config(fam, layers)
    nbytes = sc.write_model(d, config, sc.model_params(
        config, seed=7, randomize_norms=True), shards=2)
    v = config["vocab_size"]
    if fam == "gemma3":
        sc.write_gemma_tokenizer(d, vocab_size=v)
    else:
        sc.write_tokenizer(d, {"<|endoftext|>": v - 3, "<|im_start|>": v - 2,
                               "<|im_end|>": v - 1})
    return d, nbytes


def phase_families(card: str, workdir: str) -> dict:
    """Phase 8. For each family: f32 on the card against f32 on this
    machine's CPU, both loaded through build_text_model, contiguous and
    paged (phase 4's chunked 600-token prefill and 16 greedy tokens);
    bf16: a 600-token prompt prefilled through flash (fresh and append
    launches counted) into a 2-slot pool, then 16 replays of the captured
    decode step equal 16 eager steps, contiguous and paged; EXAONE4 also
    served by the paged engine over HTTP, two chats each equal alone and
    in company. Returns {fam: launch counts by kernel entry}."""
    import torch
    from cake_tpu_torch.bench.graph_cases import build_state, graph_vs_eager
    from cake_tpu_torch.ops import flash
    from cake_tpu_torch.ops import paged_attention as pa
    from cake_tpu_torch.ops.sampling import SamplingConfig
    from cake_tpu_torch.runtime import build_text_model
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    greedy = SamplingConfig(temperature=0.0)
    out = {}
    for fam in FAMILY_LAYERS:
        d, _ = _family_dir(fam, workdir, FAMILY_LAYERS[fam])
        counts = {"fresh": 0, "append": 0, "paged": 0, "f32": 0,
                  "f32_append": 0}
        cpu, _, _ = build_text_model(d, "f32", device="cpu",
                                     max_cache_len=4096)
        gpu, _, _ = build_text_model(d, "f32", device="cuda",
                                     max_cache_len=4096)
        cfg = gpu.cfg
        shape = (f"Hq/Hkv {cfg.num_attention_heads}/"
                 f"{cfg.num_key_value_heads} D {cfg.head_dim} rotary "
                 f"{cfg.rotary_dim} window {cfg.sliding_window} "
                 f"{cfg.num_hidden_layers} layers "
                 f"{[s.kind for s in cfg.layer_specs()]}")
        ids = [int(x) for x in torch.randint(
            0, cfg.vocab_size, (600,),
            generator=torch.Generator().manual_seed(5))]
        lg, tg, launches = chunked_prefill_and_greedy(gpu, ids)
        lp, tp, paged_launches = paged_prefill_and_greedy(gpu, ids)
        lc, tc, _ = chunked_prefill_and_greedy(cpu, ids)
        err, err_p = ((x - lc).abs().max().item() for x in (lg, lp))
        counts["f32"] = launches["f32"]["fresh"]
        counts["f32_append"] = launches["f32"]["append"]
        print(f"family {fam} ({shape}) f32 card vs CPU: flash launches "
              f"{launches}, paged {paged_launches}; logits max_abs_err "
              f"{err:.3e} contiguous, {err_p:.3e} paged (tol {LOGIT_TOL:g}); "
              f"16 greedy tokens identical {tg == tc} / {tp == tc}",
              flush=True)
        check(err <= LOGIT_TOL and err_p <= LOGIT_TOL,
              f"{fam}: f32 logits differ by {err} / {err_p}")
        check(tg == tc and tp == tc, f"{fam}: f32 greedy tokens differ")
        check(launches["f32"]["fresh"] > 0 and launches["f32"]["append"] > 0
              and paged_launches["f32"] > 0,
              f"{fam}: f32 kernels not launched: {launches} "
              f"{paged_launches}")
        del cpu, gpu
        torch.cuda.empty_cache()
        model, _, _ = build_text_model(d, "bf16", device="cuda",
                                       max_cache_len=4096)
        for mode, kv_blocks in (("contiguous", 0), ("paged", 1024)):
            flash.reset_launches()
            pa.reset_launches()
            state = build_state(model, [600, None], [greedy, greedy], 4096,
                                kv_blocks=kv_blocks, seed=3)
            fl = flash.launch_counts()["bf16"]
            check(fl["fresh"] > 0 and fl["append"] > 0,
                  f"{fam} {mode}: bf16 flash launches {fl}")
            r = graph_vs_eager(model, state, 16)
            torch.cuda.synchronize()
            paged_n = pa.launch_counts()["bf16"]
            print(f"family {fam} bf16 {mode}: 600-token prefill flash "
                  f"launches {fl}; 16 replays of the captured decode step "
                  f"vs eager: tokens {r['tokens_equal']}, KV bytes "
                  f"{r['kv_equal']}, carries {r['carries_equal']}; paged "
                  f"decode launches {paged_n}", flush=True)
            check(r["graph"].graph is not None
                  and r["tokens_equal"] and r["kv_equal"]
                  and r["carries_equal"],
                  f"{fam} {mode}: graph replays differ from eager steps")
            check(kv_blocks == 0 or paged_n > 0,
                  f"{fam}: no paged decode launch")
            counts["fresh"] += fl["fresh"]
            counts["append"] += fl["append"]
            counts["paged"] += paged_n
            del state, r
            torch.cuda.empty_cache()
        del model
        torch.cuda.empty_cache()
        if fam == "exaone4":
            flash.reset_launches()
            pa.reset_launches()
            served = _cli_server(d, "--kv-blocks", "1024")
            try:
                bodies = [chat_body(0), chat_body(1)]
                results = served.concurrent(bodies)
                _check_chats_any(results, "phase 8 exaone4")
                _alone_equals_concurrent(served, bodies, results,
                                         "phase 8 exaone4")
                _prompt_ids_match(served, d, bodies, "phase 8 exaone4")
            finally:
                served.close()
            fl = flash.launch_counts()["bf16"]
            paged_n = pa.launch_counts()["bf16"]
            print(f"family exaone4 served (paged, 1024 blocks): 2 chats "
                  f"equal alone and in company; flash launches {fl}, paged "
                  f"decode launches {paged_n}; on {card}", flush=True)
            check(paged_n > 0 and fl["fresh"] > 0,
                  "exaone4 serve: kernels not launched")
            counts["fresh"] += fl["fresh"]
            counts["append"] += fl["append"]
            counts["paged"] += paged_n
        shutil.rmtree(d, ignore_errors=True)
        out[fam] = counts
    return out


# -- phase 9: Gemma-3-1B at its published widths --------------------------------

GEMMA_PARITY_LAYERS = 6     # layer 5 is global: the paged pool needs one


def phase_gemma3(card: str, workdir: str) -> dict:
    """Phase 9 (a)-(c). Returns the launches of each kernel entry in it:
    fresh / append (bf16 flash, (b) and (c)), paged (bf16, (b) and (c)),
    f32 / f32_append (flash) and paged_f32, all in (a)."""
    import torch
    from cake_tpu_torch.bench.graph_cases import build_state, graph_vs_eager
    from cake_tpu_torch.ops import flash
    from cake_tpu_torch.ops import paged_attention as pa
    from cake_tpu_torch.ops.sampling import SamplingConfig
    from cake_tpu_torch.runtime import build_text_model
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    greedy = SamplingConfig(temperature=0.0)
    out = {}
    # (a) f32 parity at 6 layers, card against CPU
    d, _ = _family_dir("gemma3", workdir, GEMMA_PARITY_LAYERS, "gemma3-6")
    cpu, _, _ = build_text_model(d, "f32", device="cpu", max_cache_len=4096)
    gpu, _, _ = build_text_model(d, "f32", device="cuda", max_cache_len=4096)
    cfg = gpu.cfg
    kinds = ["G" if s.window is None else "L" for s in cfg.layer_specs()]
    ids = [int(x) for x in torch.randint(
        0, cfg.vocab_size, (600,), generator=torch.Generator().manual_seed(5))]
    lg, tg, launches = chunked_prefill_and_greedy(gpu, ids)
    lp, tp, paged_launches = paged_prefill_and_greedy(gpu, ids)
    lc, tc, _ = chunked_prefill_and_greedy(cpu, ids)
    err, err_p = ((x - lc).abs().max().item() for x in (lg, lp))
    print(f"gemma3 (a) Hq/Hkv {cfg.num_attention_heads}/"
          f"{cfg.num_key_value_heads} D {cfg.head_dim} window "
          f"{cfg.sliding_window} layers {''.join(kinds)}, f32, 600-token "
          f"prompt (the 512-token rings wrap): flash launches {launches}, "
          f"paged {paged_launches}; logits max_abs_err {err:.3e} contiguous,"
          f" {err_p:.3e} paged (tol {LOGIT_TOL:g}); 16 greedy tokens "
          f"identical {tg == tc} / {tp == tc}", flush=True)
    check(kinds.count("G") == 1, f"gemma3 (a): layers {kinds}")
    check(err <= LOGIT_TOL and err_p <= LOGIT_TOL,
          f"gemma3 (a): f32 logits differ by {err} / {err_p}")
    check(tg == tc and tp == tc, "gemma3 (a): f32 greedy tokens differ")
    check(launches["f32"]["fresh"] > 0 and launches["f32"]["append"] > 0
          and paged_launches["f32"] > 0,
          f"gemma3 (a): f32 kernels not launched: {launches} "
          f"{paged_launches}")
    out["f32"] = launches["f32"]["fresh"]
    out["f32_append"] = launches["f32"]["append"]
    out["paged_f32"] = paged_launches["f32"]
    del cpu, gpu
    torch.cuda.empty_cache()
    shutil.rmtree(d, ignore_errors=True)
    # (b) the full model from its checkpoint: graph replays vs eager steps
    t = time.perf_counter()
    d, nbytes = _family_dir("gemma3", workdir, None, "gemma-3-1b")
    write_s = time.perf_counter() - t
    torch.cuda.synchronize()
    t = time.perf_counter()
    model, _, model_id = build_text_model(d, "bf16", device="cuda",
                                          max_cache_len=4096)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t
    print(f"gemma3 (b) checkpoint: {nbytes / 1e9:.3f} GB of bf16 tensors "
          f"written in {write_s:.1f}s, loaded through build_text_model in "
          f"{load_s:.3f}s = {nbytes / 1e9 / load_s:.2f} GB/s "
          f"({model.cfg.num_hidden_layers} layers); on {card}", flush=True)
    flash.reset_launches()
    pa.reset_launches()
    for mode, kv_blocks in (("contiguous", 0), ("paged", 1024)):
        state = build_state(model, [600, None], [greedy, greedy], 4096,
                            kv_blocks=kv_blocks, seed=3)
        r = graph_vs_eager(model, state, 16)
        torch.cuda.synchronize()
        print(f"gemma3 (b) bf16 {mode}: 600-token prefill, 16 replays of the"
              f" captured decode step vs eager: tokens {r['tokens_equal']}, "
              f"KV bytes {r['kv_equal']}, carries {r['carries_equal']}, max "
              f"abs logit diff {r['max_logit_diff']:.3e}", flush=True)
        check(r["graph"].graph is not None and r["tokens_equal"]
              and r["kv_equal"] and r["carries_equal"],
              f"gemma3 (b) {mode}: graph replays differ from eager steps")
        del state, r
        torch.cuda.empty_cache()
    del model
    torch.cuda.empty_cache()
    # (c) served through `cli serve DIR`
    bodies = [chat_body(i) for i in range(4)] + [chat_body(4, True)]
    for mode, extra in (("contiguous", ()),
                        ("paged", ("--kv-blocks", "1024"))):
        served = _cli_server(d, *extra)
        try:
            results = served.concurrent(bodies)
            _check_chats_any(results, f"phase 9 {mode}")
            check(all(r["resp"]["model"] == "gemma-3-1b"
                      for r in results[:4]), "phase 9: model id")
            _prompt_ids_match(served, d, bodies, f"phase 9 {mode}")
            _alone_equals_concurrent(served, bodies, results,
                                     f"phase 9 {mode}")
            first = results[0]["resp"]
            ttft, tps = _latency(results[:4])
            print(f"gemma3 (c) served {mode}: 4 concurrent chats + 1 SSE, "
                  f"all 200, {first['usage']['prompt_tokens']}-token prompts "
                  f"(byte-fallback BPE), each equal alone and in company, "
                  f"prompt ids those of a CPU tokenizer; TTFT p50 {ttft:.1f} "
                  f"ms, decode tok/s per request p50 {tps:.1f} (smoke); on "
                  f"{card}", flush=True)
        finally:
            served.close()
    torch.cuda.synchronize()
    fl = flash.launch_counts()["bf16"]
    out.update(fresh=fl["fresh"], append=fl["append"],
               paged=pa.launch_counts()["bf16"])
    print(f"gemma3 (b)+(c) launches: bf16 flash {fl}, paged decode "
          f"{out['paged']}", flush=True)
    check(out["fresh"] > 0 and out["append"] > 0 and out["paged"] > 0,
          f"gemma3: bf16 kernels not launched: {out}")
    shutil.rmtree(d, ignore_errors=True)
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    from cake_tpu_torch.cli import build_flagship
    from cake_tpu_torch.ops import flash
    from cake_tpu_torch.ops import paged_attention as pa
    card = card_line()
    print(f"device: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    built = phase_build()
    timings = phase_kernels()
    paged_timings = phase_paged_kernels(built[pa.LIBRARY]["log"])
    parity_launches, parity_paged = phase_parity()
    t0 = time.perf_counter()
    model = build_flagship(layers=None, dtype="bf16", seed=0, device="cuda")
    print(f"serve: flagship 28 layers bf16 built in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    phase_graphs(model, card)
    serve_launches, contiguous = phase_serve(model, card)
    paged_launches = phase_paged_serve(model, card, contiguous)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        load = phase_checkpoint(model, card, workdir)
        del model
        torch.cuda.empty_cache()
        family_launches = phase_families(card, workdir)
        family_launches["gemma3"] = phase_gemma3(card, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    kernels = []
    for entry, route, launches in (
            ("fresh", "bf16", serve_launches["fresh"]),
            ("append", "bf16", serve_launches["append"]),
            ("f32", "f32", parity_launches["fresh"]),
            ("f32_append", "f32", parity_launches["append"])):
        t = timings[entry]
        kernels.append({
            "name": f"flash_attention.{entry}", "route": "cuda",
            "source": flash.SOURCES[route], "replaces": flash.REPLACES,
            "launches": launches, "max_abs_err": t["max_abs_err"],
            "ms": t["ms"], "issue_ms": t["issue_ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    for fam, n in family_launches.items():
        for entry, route, launches in (
                (f"{fam}_fresh", "bf16", n["fresh"]),
                (f"{fam}_append", "bf16", n["append"]),
                *((f"{fam}_{mode}", "f32", n[mode])
                  for mode in ("f32", "f32_append")
                  if f"{fam}_{mode}" in timings)):
            t = timings[entry]
            mode = entry.split("_", 1)[1]
            kernels.append({
                "name": f"flash_attention.{mode}.{fam}", "route": "cuda",
                "source": flash.SOURCES[route], "replaces": flash.REPLACES,
                "launches": launches, "max_abs_err": t["max_abs_err"],
                "ms": t["ms"], "issue_ms": t["issue_ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    for name, entry, launches in (
            ("bf16", "bf16", paged_launches), ("f32", "f32", parity_paged),
            *((f"bf16.{fam}", f"bf16_{fam}", n["paged"])
              for fam, n in family_launches.items()),
            ("f32.gemma3", "f32_gemma3",
             family_launches["gemma3"]["paged_f32"])):
        t = paged_timings[entry]
        kernels.append({
            "name": f"paged_decode_attention.{name}", "route": "cuda",
            "source": pa.SOURCE, "replaces": pa.REPLACES,
            "launches": launches, "max_abs_err": t["max_abs_err"],
            "ms": t["ms"], "issue_ms": t["issue_ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    print(f"checkpoint load (phase 7): {json.dumps(load)} on {card}")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
