"""Command line (counterpart of cake_tpu/cli.py, `serve` and `run`).

    python -m cake_tpu_torch.cli serve --flagship [--seed N] [--port P] [--cpu]
        [--prefix-cache-mb MB] [--kv-blocks N] [--kv-block-tokens T]
    python -m cake_tpu_torch.cli run --flagship "prompt" [--max-tokens N]
        [--temperature T] [--seed N]

`--flagship` is the Qwen3-0.6B shape with seeded random weights (loading
a checkpoint is not ported yet); `--layers` cuts its depth. The model
runs on `cuda` unless `--cpu` is given. `serve` keeps the reference's
defaults: the shared-prefix cache on at 256 MB, and a contiguous KV pool
unless `--kv-blocks` asks for a paged one. `--seed` seeds the weights and
the sampling keys (serve: one key per admission; run: the request's).
`run` decodes through generate's captured chunks of 16 steps.
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import signal
import sys
import threading

from .device import parse_dtype
from .models.common.config import FLAGSHIP_QWEN3_0_6B, config_from_hf_dict
from .models.common.text_model import TextModel
from .ops.sampling import SamplingConfig
from .serve.engine import (DEFAULT_CHUNK, DEFAULT_CTX,
                           DEFAULT_KV_BLOCK_TOKENS, DEFAULT_PREFIX_CACHE_MB,
                           DEFAULT_QUEUE, DEFAULT_SLOTS, ServeEngine)
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
    p.add_argument("--flagship", action="store_true", required=True,
                   help="Qwen3-0.6B shape, seeded random weights")
    p.add_argument("--layers", type=int, default=None,
                   help="cut the depth to this many blocks")
    p.add_argument("--dtype", default="bf16")
    p.add_argument("--seed", type=int, default=0,
                   help="seeds the random weights and the sampling keys")
    p.add_argument("--cpu", action="store_true", help="run on the CPU")


def cmd_serve(args) -> int:
    from .api.server import create_app
    model = build_flagship(args.layers, args.dtype, args.seed,
                           "cpu" if args.cpu else None)
    engine = ServeEngine(model, slots=args.slots, max_queue=args.max_queue,
                         ctx_len=args.ctx, seed=args.seed,
                         prefill_chunk=args.prefill_chunk,
                         prefix_cache_mb=args.prefix_cache_mb,
                         kv_blocks=args.kv_blocks,
                         kv_block_tokens=args.kv_block_tokens)
    app = create_app(model, engine, model.tokenizer, args.host, args.port)
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
    model = build_flagship(args.layers, args.dtype, args.seed,
                           "cpu" if args.cpu else None)
    ids = model.tokenizer.chat_prompt_ids(
        [{"role": "user", "content": args.prompt}])
    out, stats = model.generate(
        ids, max_new_tokens=args.max_tokens,
        sampling=SamplingConfig(temperature=args.temperature),
        seed=args.seed)
    print(model.tokenizer.decode(out))
    print(f"[{len(out)} tokens, ttft {stats['ttft_s']:.3f}s, "
          f"{stats['tok_per_s']:.1f} tok/s]", file=sys.stderr)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="cake-tpu-torch")
    ap.add_argument("-v", "--verbose", action="store_true")
    sub = ap.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("serve", help="OpenAI-compatible chat server")
    _model_args(s)
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--port", type=int, default=8080)
    s.add_argument("--slots", type=int, default=DEFAULT_SLOTS)
    s.add_argument("--ctx", type=int, default=DEFAULT_CTX)
    s.add_argument("--prefill-chunk", type=int, default=DEFAULT_CHUNK)
    s.add_argument("--max-queue", type=int, default=DEFAULT_QUEUE)
    s.add_argument("--prefix-cache-mb", type=float,
                   default=DEFAULT_PREFIX_CACHE_MB,
                   help="shared-prefix cache capacity (0 turns it off)")
    s.add_argument("--kv-blocks", type=int, default=0,
                   help="paged KV pool of this many blocks (0: contiguous)")
    s.add_argument("--kv-block-tokens", type=int,
                   default=DEFAULT_KV_BLOCK_TOKENS,
                   help="tokens per paged KV block")
    s.set_defaults(fn=cmd_serve)
    r = sub.add_parser("run", help="generate once from a chat prompt")
    _model_args(r)
    r.add_argument("prompt")
    r.add_argument("--max-tokens", type=int, default=32)
    r.add_argument("--temperature", type=float, default=0.0)
    r.set_defaults(fn=cmd_run)
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.DEBUG if args.verbose
                        else logging.WARNING)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
