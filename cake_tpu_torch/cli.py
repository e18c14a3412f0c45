"""Command line (counterpart of cake_tpu/cli.py, `serve` and `run`).

    python -m cake_tpu_torch.cli serve (MODEL | --flagship) [--arch A]
        [--dtype D] [--seed N] [--port P] [--cpu] [--fp8-native]
        [--expert-offload] [--slots N] [--ctx N] [--max-queue N]
        [--prefill-chunk N] [--prefix-cache-mb MB] [--kv-blocks N]
        [--kv-block-tokens T] [--preempt-mode M]
    python -m cake_tpu_torch.cli run (MODEL | --flagship) "prompt"
        [--max-tokens N] [--temperature T] [--top-k K] [--top-p P]
        [--repeat-penalty R] [--repeat-last-n N] [--system-prompt S]
        [--raw] [--seed N] [--fp8-native] [--expert-offload]

MODEL is a local HF-layout checkpoint directory (FP8 block-wise, AutoGPTQ
4-bit or unquantized), a directory with a GGUF file, or a repo id already
in the local Hugging Face cache (runtime.build_text_model), served with
its own tokenizer.json and chat template; `--arch` overrides its config's
architecture, and `--fp8-native` keeps an FP8 checkpoint's projections at
1 byte per parameter on the card. `--flagship` is the other choice: the
Qwen3-0.6B shape with seeded random weights and the byte tokenizer;
`--layers` cuts its depth. `--expert-offload` keeps an MoE checkpoint's
experts on disk, read on demand into an LRU per layer
(runtime.build_text_model), and serves it one request at a time.
The model runs on `cuda` unless `--cpu` is given. `serve` takes the
engine's shape as the reference does, from CAKE_SERVE_SLOTS (4; 0 serves
one request at a time under a lock, as an offloaded model is served),
CAKE_MAX_QUEUE (64), CAKE_SERVE_CTX (4096), CAKE_PREFILL_CHUNK (256),
CAKE_PREFIX_CACHE_MB (256, 0 = off), CAKE_KV_BLOCKS (0: a contiguous KV
pool; more: a paged pool of that many blocks), CAKE_KV_BLOCK_TOKENS (16)
and CAKE_PREEMPT_MODE ("swap": a paged pool's victims under pressure are
swapped to host memory; "recompute": replayed at resume); a flag given
on the command line wins over its variable (serve/engine.py:
engine_knobs). CAKE_DRAIN_TIMEOUT_S (30) bounds the drain at shutdown.
`run` takes the reference's sampling flags and defaults (256 tokens at
temperature 0.7), and `--raw` encodes the prompt without the chat
template. The supervisor's
knobs come from the environment, as the reference reads them:
CAKE_STEP_WATCHDOG_S (0, off), CAKE_ENGINE_REBUILDS (3) per rolling
CAKE_ENGINE_REBUILD_WINDOW_S (300), and CAKE_ENGINE_RESTORE_S (5), the
probe interval while DOWN; CAKE_SERVE_FAULT_PLAN installs a fault plan
(serve/faults.py). So do the admission plane's and the metrics plane's:
CAKE_QUEUE_DEADLINE_S and CAKE_REQUEST_DEADLINE_S (0, off: a request
queued, or alive, past them answers 503 or 504), CAKE_QOS_WEIGHTS
("interactive=8,standard=4,batch=1") and CAKE_QOS_BOUNDS (each class's
queue bound, --max-queue by default), CAKE_QOS_TENANTS (tenant quotas,
e.g. "acme:rps=5,burst=10,inflight=4,max_class=standard"), and
CAKE_TRACE_DIR (set: the span recorder records), CAKE_TRACE_EVENTS
(16384) and CAKE_TRACE_REQUESTS (256). So do speculative decoding's, in
`serve` and `run`: CAKE_SPEC ("ngram" turns it on; unset, off),
CAKE_SPEC_K (the draft window, 6, clamped to [1, 32]), CAKE_SPEC_NGRAM
(the n-gram drafter's longest match, 3, at least 2) and, for a paged
pool, CAKE_SPEC_RESERVE (the frontier a slot reserves ahead of a verify,
0 = the whole window). `--seed`
seeds the sampling keys (serve: one key per admission; run: the
request's) and the flagship's weights. `run` decodes through generate's
captured chunks of 16 steps.
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import signal
import sys
import threading

from .device import parse_dtype
from .models.common.config import FLAGSHIP_QWEN3_0_6B, config_from_hf_dict
from .models.common.text_model import TextModel
from . import obs
from .ops.sampling import SamplingConfig
from .serve.admission import (AdmissionPlane, TenantRegistry, class_bounds,
                              class_weights)
from .spec import resolve_drafter, spec_knobs
from .serve.engine import PREEMPT_MODES, engine_knobs, maybe_engine
from .tokenizer import ByteTokenizer


def build_flagship(layers: int | None = None, dtype: str = "bf16",
                   seed: int = 0, device: str | None = None) -> TextModel:
    """The flagship model with seeded random weights, optionally cut to
    `layers` blocks (widths are never changed)."""
    cfg = config_from_hf_dict(FLAGSHIP_QWEN3_0_6B)
    if layers:
        cfg = dataclasses.replace(cfg, num_hidden_layers=layers)
    return TextModel(cfg, tokenizer=ByteTokenizer(), dtype=parse_dtype(dtype),
                     device=device, seed=seed)


def _model_args(p: argparse.ArgumentParser) -> None:
    which = p.add_mutually_exclusive_group(required=True)
    which.add_argument("model", nargs="?", default=None,
                       help="checkpoint directory or cached HF repo id")
    which.add_argument("--flagship", action="store_true",
                       help="Qwen3-0.6B shape, seeded random weights")
    p.add_argument("--arch", default=None,
                   help="architecture or family, overriding config.json")
    p.add_argument("--layers", type=int, default=None,
                   help="cut the flagship's depth to this many blocks")
    p.add_argument("--dtype", default="bf16")
    p.add_argument("--seed", type=int, default=0,
                   help="seeds the sampling keys (and the flagship's "
                        "random weights)")
    p.add_argument("--cpu", action="store_true", help="run on the CPU")
    p.add_argument("--fp8-native", action="store_true",
                   help="keep an FP8 checkpoint's weights 1 byte/param on "
                        "the card, dequantized per layer by the kernel")
    p.add_argument("--expert-offload", action="store_true",
                   help="MoE: read the experts from the checkpoint on "
                        "demand instead of holding them on the card")


def load_model(args, max_cache_len: int = 2048):
    """(model, tokenizer, model_id) of the parsed arguments."""
    device = "cpu" if args.cpu else None
    if args.flagship:
        if args.fp8_native:
            raise ValueError("--fp8-native requires an FP8 checkpoint "
                             "(the flagship has random bf16 weights)")
        if args.expert_offload:
            raise ValueError("--expert-offload needs an MoE model (the "
                             "flagship has no experts)")
        model = build_flagship(args.layers, args.dtype, args.seed, device)
        return model, model.tokenizer, "cake-tpu-torch"
    from .runtime import build_text_model
    return build_text_model(args.model, args.dtype, args.arch,
                            max_cache_len=max_cache_len, seed=args.seed,
                            device=device, fp8_native=args.fp8_native,
                            expert_offload=args.expert_offload)


def supervisor_knobs(env) -> dict:
    """The engine's supervisor kwargs from the environment's CAKE_*
    variables (the reference's knobs); unset ones keep the defaults."""
    knobs = {"step_watchdog_s": ("CAKE_STEP_WATCHDOG_S", float),
             "rebuild_budget": ("CAKE_ENGINE_REBUILDS", int),
             "rebuild_window_s": ("CAKE_ENGINE_REBUILD_WINDOW_S", float),
             "restore_interval_s": ("CAKE_ENGINE_RESTORE_S", float)}
    return {kw: cast(env[name]) for kw, (name, cast) in knobs.items()
            if env.get(name)}


def admission_knobs(env, max_queue: int) -> dict:
    """The engine's deadline and QoS kwargs from the environment's CAKE_*
    variables (the reference's knobs, with its defaults: deadlines 0,
    weights 8:4:1, every class's bound `max_queue`). A malformed class
    spec raises here, at startup."""
    return {"queue_deadline_s": float(env.get("CAKE_QUEUE_DEADLINE_S")
                                      or 0.0),
            "request_deadline_s": float(env.get("CAKE_REQUEST_DEADLINE_S")
                                        or 0.0),
            "qos_weights": class_weights(env.get("CAKE_QOS_WEIGHTS") or ""),
            "qos_bounds": class_bounds(max_queue,
                                       env.get("CAKE_QOS_BOUNDS") or "")}


def spec_args(env) -> dict:
    """The engine's speculative-decoding kwargs from CAKE_SPEC,
    CAKE_SPEC_K, CAKE_SPEC_NGRAM and CAKE_SPEC_RESERVE (the reference's
    knobs, defaults and clamps): {} when CAKE_SPEC leaves it off."""
    knobs = spec_knobs(env)
    drafter, k = resolve_drafter(knobs["spec"] or False, knobs["spec_k"],
                                 knobs["spec_ngram"])
    if drafter is None:
        return {}
    return {"spec": drafter, "spec_k": k,
            "spec_reserve": knobs["spec_reserve"]}


def build_server(args):
    """The serve command's HTTP server (not started): over its engine
    (serve/engine.py: maybe_engine), or with none (an offloaded model, or
    CAKE_SERVE_SLOTS=0) over the locked one-request path."""
    from .api.server import create_app
    env = os.environ
    obs.configure(env)
    plane = AdmissionPlane(TenantRegistry(env.get("CAKE_QOS_TENANTS") or ""))
    shape = engine_knobs(env, slots=args.slots, max_queue=args.max_queue,
                         ctx_len=args.ctx, prefill_chunk=args.prefill_chunk,
                         prefix_cache_mb=args.prefix_cache_mb,
                         kv_blocks=args.kv_blocks,
                         kv_block_tokens=args.kv_block_tokens,
                         preempt_mode=args.preempt_mode)
    if shape["preempt_mode"] not in PREEMPT_MODES:
        raise ValueError(f"CAKE_PREEMPT_MODE must be one of {PREEMPT_MODES},"
                         f" got {shape['preempt_mode']!r}")
    model, tokenizer, model_id = load_model(args,
                                            max_cache_len=shape["ctx_len"])
    engine = maybe_engine(model, env, seed=args.seed, **shape,
                          **supervisor_knobs(env),
                          **admission_knobs(env, shape["max_queue"]),
                          **spec_args(env))
    if engine is None:
        logging.getLogger("cake_tpu_torch").warning(
            "no serve engine (%s): one request at a time under a lock",
            "CAKE_SERVE_SLOTS=0" if shape["slots"] <= 0
            else type(model).__name__)
    return create_app(model, engine, tokenizer, args.host, args.port,
                      model_id=model_id, plane=plane)


def cmd_serve(args) -> int:
    app = build_server(args)
    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())
    app.start()
    logging.getLogger("cake_tpu_torch").warning("serving on %s", app.url)
    stop.wait()
    logging.getLogger("cake_tpu_torch").warning("draining serve engine")
    app.stop()
    return 0


def cmd_run(args) -> int:
    model, tokenizer, _ = load_model(args)
    if args.raw:
        ids = tokenizer.encode(args.prompt)
    else:
        messages = ([{"role": "system", "content": args.system_prompt}]
                    if args.system_prompt else [])
        ids = tokenizer.chat_prompt_ids(
            messages + [{"role": "user", "content": args.prompt}])
    spec = spec_args(os.environ)
    out, stats = model.generate(
        ids, max_new_tokens=args.max_tokens,
        sampling=SamplingConfig(temperature=args.temperature,
                                top_k=args.top_k, top_p=args.top_p,
                                repeat_penalty=args.repeat_penalty,
                                repeat_last_n=args.repeat_last_n),
        seed=args.seed, spec=spec.get("spec", False),
        spec_k=spec.get("spec_k"))
    if out and model.cfg.is_eos(out[-1]):
        out = out[:-1]
    print(tokenizer.decode(out))
    extra = (f", {stats['spec_accept_rate']} accepted, "
             f"{stats['spec_tokens_per_step']} tokens per verify"
             if "spec_steps" in stats else "")
    print(f"[{len(out)} tokens, ttft {stats['ttft_s']:.3f}s, "
          f"{stats['tok_per_s']:.1f} tok/s{extra}]", file=sys.stderr)
    return 0


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="cake-tpu-torch")
    ap.add_argument("-v", "--verbose", action="store_true")
    sub = ap.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("serve", help="OpenAI-compatible chat server")
    _model_args(s)
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--port", type=int, default=8080)
    # each engine-shape flag defaults to its CAKE_ variable, then to the
    # reference's default (serve/engine.py: ENGINE_KNOBS)
    s.add_argument("--slots", type=int, default=None,
                   help="engine slots (CAKE_SERVE_SLOTS, 4; 0: no engine)")
    s.add_argument("--ctx", type=int, default=None,
                   help="tokens per slot (CAKE_SERVE_CTX, 4096)")
    s.add_argument("--prefill-chunk", type=int, default=None,
                   help="prefill chunk (CAKE_PREFILL_CHUNK, 256)")
    s.add_argument("--max-queue", type=int, default=None,
                   help="queue bound (CAKE_MAX_QUEUE, 64)")
    s.add_argument("--prefix-cache-mb", type=float, default=None,
                   help="shared-prefix cache capacity "
                        "(CAKE_PREFIX_CACHE_MB, 256; 0 turns it off)")
    s.add_argument("--kv-blocks", type=int, default=None,
                   help="paged KV pool of this many blocks "
                        "(CAKE_KV_BLOCKS, 0: contiguous)")
    s.add_argument("--kv-block-tokens", type=int, default=None,
                   help="tokens per paged KV block "
                        "(CAKE_KV_BLOCK_TOKENS, 16)")
    s.add_argument("--preempt-mode", choices=PREEMPT_MODES, default=None,
                   help="how a paged pool under pressure parks a victim "
                        "(CAKE_PREEMPT_MODE, swap)")
    s.set_defaults(fn=cmd_serve)
    r = sub.add_parser("run", help="generate once from a chat prompt")
    _model_args(r)
    r.add_argument("prompt")
    r.add_argument("--max-tokens", type=int, default=256)
    r.add_argument("--temperature", type=float, default=0.7)
    r.add_argument("--top-k", type=int, default=None)
    r.add_argument("--top-p", type=float, default=None)
    r.add_argument("--repeat-penalty", type=float, default=1.0)
    r.add_argument("--repeat-last-n", type=int, default=64,
                   help="window the repeat penalty looks back over")
    r.add_argument("--system-prompt", default=None,
                   help="a system message before the prompt")
    r.add_argument("--raw", action="store_true",
                   help="encode the prompt as it is, without the chat "
                        "template")
    r.set_defaults(fn=cmd_run)
    return ap


def main(argv=None) -> int:
    ap = parser()
    args = ap.parse_args(argv)
    if args.layers and not args.flagship:
        ap.error("--layers cuts the flagship only")
    logging.basicConfig(level=logging.DEBUG if args.verbose
                        else logging.WARNING)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
