"""Command line (counterpart of cake_tpu/cli.py, `serve`, `run`, `image`,
`tts`, `worker`, `route` and `top`).

    python -m cake_tpu_torch.cli serve (MODEL | --flagship) [--arch A]
        [--dtype D] [--seed N] [--port P] [--cpu] [--fp8-native]
        [--expert-offload] [--slots N] [--ctx N] [--max-queue N]
        [--prefill-chunk N] [--prefix-cache-mb MB] [--kv-blocks N]
        [--kv-block-tokens T] [--preempt-mode M] [--image-model M]
        [--sd-intermediate-every N] [--sd-trace-dir DIR]
        [--audio-model M] [--voices-dir DIR]
    python -m cake_tpu_torch.cli image MODEL "prompt" --out x.png
        [--width W] [--height H] [--steps N] [--guidance G] [--seed N]
        [--negative-prompt P] [--init-image PNG] [--strength S]
        [--dtype D] [--fp8-native] [--cpu]
    python -m cake_tpu_torch.cli tts MODEL "text" --out x.wav
        [--frames N] [--steps N] [--cfg-scale S] [--voice FILE]
        [--voice-wav WAV] [--seed N] [--dtype D] [--cpu]
    python -m cake_tpu_torch.cli run (MODEL | --flagship) "prompt"
        [--max-tokens N] [--temperature T] [--top-k K] [--top-p P]
        [--repeat-penalty R] [--repeat-last-n N] [--system-prompt S]
        [--raw] [--seed N] [--fp8-native] [--expert-offload]
    python -m cake_tpu_torch.cli worker --cluster-key K [--name N]
        [--port P] [--model-dir DIR] [--cpu] [--no-advertise]
    python -m cake_tpu_torch.cli route [--replica NAME=URL ...]
        [--cluster-key K] [--host H] [--port P]
    python -m cake_tpu_torch.cli top [--api HOST:PORT] [--interval S]
        [--once] [--plain] [--timeout S]

`serve` and `run` with `--cluster-key K` (or CAKE_CLUSTER_KEY) are a
cluster master: the workers of `--topology FILE` (each node's
`layers` its assignment), else those UDP discovery finds, get their layer
ranges' weights streamed from MODEL and serve them; the master keeps the
rest (runtime.build_text_model, cluster/). A cluster master is served one
request at a time under the lock, as the reference serves it. `worker`
runs a cluster worker (cluster/worker.py) on `cuda` unless `--cpu`.

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
template. `image` writes one PNG (1024 x 1024 by default; 20 steps and
guidance 3.5 for FLUX, the SD config's 20 and 7.5) from an image model
(runtime.build_image_model: `demo:flux`, the tiny FLUX.1 pipeline on
seeded weights; `demo:flux1-dev`, FLUX.1-dev's widths and depth on
seeded weights; `demo:sd`, the tiny SD pipeline; `demo:flux2`, the tiny
FLUX.2 pipeline; `demo:flux2-klein`, FLUX.2-klein-4B's widths and depth
with its Qwen3-4B encoder on seeded weights; a FLUX.1 checkpoint, whose
FP8 transformer `--fp8-native` keeps at 1 byte per parameter; a
diffusers SD 1.x / 2.x / SDXL directory; or a diffusers FLUX.2
directory); with an SD model,
`--init-image PNG` starts from that image (img2img, `--strength` 0.8 by
default). `serve --image-model M` serves it too, at POST
/v1/images/generations and /api/v1/image, in the same `--dtype`,
`--fp8-native` then applying to the image model (and to MODEL, which it
requires to be FP8, unless MODEL is `--flagship`); for SD,
`--sd-intermediate-every N` writes the image in progress every N steps
(sd_intermediate_<step>.png in the working directory) and
`--sd-trace-dir DIR` a torch.profiler trace of each generation there.
`tts` writes one WAV (runtime.build_audio_model: `demo:vibevoice`, the
tiny VibeVoice on seeded weights; `demo:vibevoice-0.5b`,
VibeVoice-Realtime-0.5B's widths on seeded weights; `demo:luxtts`, the
tiny LuxTTS on seeded weights; or a VibeVoice or LuxTTS checkpoint
directory; `--voice` a VibeVoice voice-prompt file, `--voice-wav` a WAV
to clone, `--steps` VibeVoice's diffusion steps per frame or LuxTTS's
Euler steps); `serve --audio-model M` serves it at POST /v1/audio/speech,
`--voices-dir DIR` naming the voice-prompt files a request may pick by
name. CAKE_JOB_WORKERS (1) image and speech jobs run at once, and
CAKE_IMAGE_MAX_SIZE (2048) bounds a side. The supervisor's
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

`serve --announce [--announce-name N]` answers UDP discovery for the
replica (role "serve"); its `--cluster-key` then names the fleet, and the
model is served on this host alone. `route` is the fleet router
(fleet/router.py) over the `--replica` entries and, with `--cluster-key`,
the announced replicas discovery finds; the CAKE_FLEET_*, CAKE_TELEM_*
and CAKE_SLO_* variables set it up (fleet/knobs.py). `--autoscale` (or
CAKE_SCALE) runs the closed-loop autoscaler, which spawns replicas from
the CAKE_SCALE_SPAWN_CMD template ({port} and {name} filled) and keeps
CAKE_SCALE_MIN..CAKE_SCALE_MAX of them; with the template set, the
router may start with no replica at all. CAKE_KVSHARE=1 on the router
and on `serve` turns on the fleet-shared KV tier (prefix-blob fetch
between replicas, stream-blob migration on a drain); a replica joins it
only with a paged pool (`--kv-blocks`) and the prefix cache. `top`
renders the router's telemetry rollup. Neither `route` nor `top`
imports torch.
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import signal
import sys
import threading

# the model, engine and torch load inside the commands that use them:
# `route` and `top` (the fleet router and its dashboard) import no torch
PREEMPT_MODES = ("swap", "recompute")   # serve/engine.py's, for the parser


def build_flagship(layers: int | None = None, dtype: str = "bf16",
                   seed: int = 0, device: str | None = None):
    """The flagship TextModel with seeded random weights, optionally cut
    to `layers` blocks (widths are never changed)."""
    from .device import parse_dtype
    from .models.common.config import (FLAGSHIP_QWEN3_0_6B,
                                       config_from_hf_dict)
    from .models.common.text_model import TextModel
    from .tokenizer import ByteTokenizer
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
    p.add_argument("--cluster-key",
                   default=os.environ.get("CAKE_CLUSTER_KEY") or None,
                   help="be a cluster master (env: CAKE_CLUSTER_KEY)")
    p.add_argument("--topology", default=None,
                   help="cluster topology YAML (else UDP discovery)")


def load_model(args, max_cache_len: int = 2048):
    """(model, tokenizer, model_id) of the parsed arguments."""
    device = "cpu" if args.cpu else None
    # a replica announced to a fleet router serves alone: its key names
    # the fleet, not a cluster of workers
    cluster_key = None if getattr(args, "announce", False) \
        else args.cluster_key
    if args.flagship:
        if cluster_key:
            raise ValueError("--cluster-key needs a checkpoint directory "
                             "(workers are sent its weights)")
        if args.fp8_native and not getattr(args, "image_model", None):
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
                            expert_offload=args.expert_offload,
                            cluster_key=cluster_key,
                            topology_path=args.topology)


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
    from .serve.admission import class_bounds, class_weights
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
    from .spec import resolve_drafter, spec_knobs
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
    from . import obs
    from .api.server import create_app
    from .serve.admission import AdmissionPlane, TenantRegistry
    from .serve.engine import engine_knobs, maybe_engine
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
    image_model = None
    if args.image_model:
        from .runtime import build_image_model
        image_model = build_image_model(
            args.image_model, args.dtype, fp8_native=args.fp8_native,
            device="cpu" if args.cpu else None, seed=args.seed)
    audio_model = None
    if args.audio_model:
        from .runtime import build_audio_model
        audio_model = build_audio_model(
            args.audio_model, args.dtype,
            device="cpu" if args.cpu else None, seed=args.seed)
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
                      model_id=model_id, plane=plane, image_model=image_model,
                      sd_intermediate_every=args.sd_intermediate_every,
                      sd_trace_dir=args.sd_trace_dir, audio_model=audio_model,
                      voices_dir=args.voices_dir)


def announce(args, port: int):
    """`serve --announce`: a WorkerAdvertiser answering UDP discovery for
    this replica (the reference's cmd_serve), its caps tagged role
    "serve", the replies a fleet router's discovery keeps (`route
    --cluster-key K`, fleet/registry.py: discover_replicas). Returns the
    started advertiser; raises ValueError without a key."""
    from .cluster import discovery
    if not args.cluster_key:
        raise ValueError("--announce needs --cluster-key (or "
                         "CAKE_CLUSTER_KEY)")
    caps = {**discovery.detect_capabilities(), "role": "serve"}
    return discovery.WorkerAdvertiser(
        args.announce_name or os.uname().nodename, args.cluster_key, port,
        discovery_port=discovery.DISCOVERY_PORT, caps=caps).start()


def cmd_serve(args) -> int:
    if args.announce and not args.cluster_key:
        print("error: --announce needs --cluster-key (or CAKE_CLUSTER_KEY)",
              file=sys.stderr)
        return 2
    app = build_server(args)
    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())
    app.start()
    log = logging.getLogger("cake_tpu_torch")
    log.warning("serving on %s", app.url)
    advertiser = announce(args, app.server_address[1]) if args.announce \
        else None
    if advertiser is not None:
        log.warning("announcing replica %s on UDP discovery",
                    advertiser.name)
    try:
        stop.wait()
    finally:
        if advertiser is not None:
            advertiser.stop()
    log.warning("draining serve engine")
    app.stop()
    return 0


def _replica_specs(specs: list[str]) -> list[tuple[str, str]]:
    """--replica entries (NAME=URL or host:port) as (name, base_url), as
    the reference's cmd_route parses them."""
    replicas = []
    for spec in specs or []:
        name, sep, url = spec.partition("=")
        if not sep:
            url = spec
            name = spec.split("//")[-1].replace(":", "-").replace("/", "")
        if "://" not in url:
            url = "http://" + url
        replicas.append((name, url))
    return replicas


def cmd_route(args) -> int:
    """Fleet router: front N `serve` replicas with health-driven
    membership, prefix-affinity failover and router-level 429s
    (fleet/router.py; the standard library only, no torch)."""
    from .fleet import knobs
    from .fleet.router import serve_router
    replicas = _replica_specs(args.replica)
    key = args.cluster_key or knobs.get("CAKE_CLUSTER_KEY")
    scaling = bool(args.autoscale or knobs.get("CAKE_SCALE"))
    if not replicas and not key and not (
            scaling and knobs.get_str("CAKE_SCALE_SPAWN_CMD")):
        print("error: need --replica host:port entries, --cluster-key "
              "for UDP discovery, or --autoscale with CAKE_SCALE_SPAWN_CMD "
              "to bootstrap an empty fleet", file=sys.stderr)
        return 2
    serve_router(replicas, host=args.host, port=args.port, cluster_key=key,
                 autoscale=True if args.autoscale else None)
    return 0


def cmd_top(args) -> int:
    """Live fleet dashboard: the router's telemetry rollup (burn rates,
    headroom, per-replica SLO rows) in the terminal (fleet/top.py)."""
    from .fleet.top import run_top
    url = args.api
    if "://" not in url:
        url = "http://" + url
    return run_top(url, interval_s=args.interval, once=args.once,
                   plain=args.plain, timeout_s=args.timeout)


def cmd_run(args) -> int:
    from .ops.sampling import SamplingConfig
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


def cmd_image(args) -> int:
    """One image to a PNG file (the reference's `cake-tpu image`)."""
    import time
    from .runtime import build_image_model
    model = build_image_model(args.model, args.dtype,
                              fp8_native=args.fp8_native,
                              device="cpu" if args.cpu else None)
    kwargs = dict(width=args.width, height=args.height, seed=args.seed,
                  negative_prompt=args.negative_prompt)
    if args.steps is not None:
        kwargs["steps"] = args.steps
    if args.guidance is not None:
        kwargs["guidance"] = args.guidance
    if args.init_image:
        if not hasattr(model, "init_latent_from"):
            raise SystemExit("--init-image needs an SD model (FLUX is "
                             "guidance-distilled text-to-image only)")
        from .utils.png import decode_png
        try:
            with open(args.init_image, "rb") as f:
                pixels = decode_png(f.read())
            kwargs["init_image"] = model.init_latent_from(
                pixels, args.width, args.height)
        except ValueError as e:
            raise SystemExit(f"{args.init_image}: {e}")
        kwargs["strength"] = args.strength
    t0 = time.monotonic()
    image = model.generate_image(args.prompt, **kwargs)
    image.save(args.out)
    print(f"[{args.out}: {args.width}x{args.height} in "
          f"{time.monotonic() - t0:.1f}s]", file=sys.stderr)
    return 0


def cmd_tts(args) -> int:
    """One utterance to a WAV file (the reference's `cake-tpu tts`)."""
    import time
    from .runtime import build_audio_model
    model = build_audio_model(args.model, args.dtype,
                              device="cpu" if args.cpu else None)
    voice_wav = None
    if args.voice_wav:
        with open(args.voice_wav, "rb") as f:
            voice_wav = f.read()
    kwargs = dict(voice=args.voice, voice_wav=voice_wav, seed=args.seed)
    for key in ("frames", "steps", "cfg_scale"):
        value = getattr(args, key)
        if value is not None:
            kwargs["max_frames" if key == "frames" else key] = value
    t0 = time.monotonic()
    audio = model.generate_speech(args.text, **kwargs)
    with open(args.out, "wb") as f:
        f.write(audio.wav_bytes())
    print(f"[{args.out}: {time.monotonic() - t0:.1f}s]", file=sys.stderr)
    return 0


def cmd_worker(args) -> int:
    from .cluster import run_worker
    if not args.cluster_key:
        print("error: --cluster-key (or CAKE_CLUSTER_KEY) required",
              file=sys.stderr)
        return 2
    run_worker(args.name, args.cluster_key, port=args.port,
               model_dir=args.model_dir, host=args.host,
               advertise=not args.no_advertise,
               device="cpu" if args.cpu else None)
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
    s.add_argument("--image-model", default=None,
                   help="also serve this image model ('demo:flux', "
                        "'demo:flux1-dev', 'demo:sd', 'demo:flux2', "
                        "'demo:flux2-klein', a FLUX.1 checkpoint or a "
                        "diffusers SD or FLUX.2 directory)")
    s.add_argument("--audio-model", default=None,
                   help="also serve this speech model ('demo:vibevoice', "
                        "'demo:vibevoice-0.5b', 'demo:luxtts' or a "
                        "VibeVoice or LuxTTS directory)")
    s.add_argument("--voices-dir", default=None,
                   help="directory of voice-prompt .safetensors files a "
                        "speech request may name")
    s.add_argument("--sd-intermediate-every", type=int, default=0,
                   help="SD: save the image in progress every N denoising "
                        "steps (sd_intermediate_<step>.png)")
    s.add_argument("--sd-trace-dir", default=None,
                   help="SD: write a torch.profiler trace of each "
                        "generation here")
    s.add_argument("--announce", action="store_true",
                   help="advertise this replica on UDP discovery so a "
                        "fleet router (`route --cluster-key K`) finds it "
                        "(needs --cluster-key / CAKE_CLUSTER_KEY, which "
                        "then names the fleet: the model is served here "
                        "alone)")
    s.add_argument("--announce-name", default=None,
                   help="replica name for discovery (default: hostname)")
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
    i = sub.add_parser("image", help="generate an image to a PNG file")
    i.add_argument("model", help="'demo:flux', 'demo:flux1-dev', "
                                 "'demo:sd', 'demo:flux2', "
                                 "'demo:flux2-klein', a FLUX.1 checkpoint "
                                 "or a diffusers SD or FLUX.2 directory")
    i.add_argument("prompt")
    i.add_argument("--out", default="output.png")
    i.add_argument("--width", type=int, default=1024)
    i.add_argument("--height", type=int, default=1024)
    i.add_argument("--steps", type=int, default=None)
    i.add_argument("--guidance", type=float, default=None)
    i.add_argument("--seed", type=int, default=None)
    i.add_argument("--negative-prompt", default=None)
    i.add_argument("--init-image", default=None,
                   help="SD img2img: start from this PNG")
    i.add_argument("--strength", type=float, default=0.8,
                   help="img2img: how much of the schedule to run")
    i.add_argument("--dtype", default="bf16")
    i.add_argument("--fp8-native", action="store_true",
                   help="keep a FLUX.1 checkpoint's FP8 transformer 1 "
                        "byte/param on the card")
    i.add_argument("--cpu", action="store_true", help="run on the CPU")
    i.set_defaults(fn=cmd_image)
    t = sub.add_parser("tts", help="synthesize speech to a WAV file")
    t.add_argument("model", help="'demo:vibevoice', 'demo:vibevoice-0.5b', "
                                 "'demo:luxtts' or a VibeVoice or LuxTTS "
                                 "checkpoint directory")
    t.add_argument("text")
    t.add_argument("--out", default="output.wav")
    t.add_argument("--frames", type=int, default=None,
                   help="most speech frames (133 ms each for VibeVoice, "
                        "hop / rate for LuxTTS)")
    t.add_argument("--steps", type=int, default=None,
                   help="diffusion steps per frame (VibeVoice) or Euler "
                        "steps (LuxTTS)")
    t.add_argument("--cfg-scale", type=float, default=None)
    t.add_argument("--voice", default=None,
                   help="a voice-prompt .safetensors file")
    t.add_argument("--voice-wav", default=None,
                   help="clone the voice of this reference WAV")
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--dtype", default="bf16")
    t.add_argument("--cpu", action="store_true", help="run on the CPU")
    t.set_defaults(fn=cmd_tts)
    rt = sub.add_parser("route", help="fleet router over N serve "
                                      "replicas (no torch)")
    rt.add_argument("--host", default="0.0.0.0")
    rt.add_argument("--port", type=int, default=8100)
    rt.add_argument("--replica", action="append", default=[],
                    help="replica as NAME=URL or host:port (repeatable; "
                         "e.g. r0=http://10.0.0.5:8000)")
    rt.add_argument("--cluster-key", default=None,
                    help="PSK for UDP discovery of `serve --announce` "
                         "replicas (CAKE_CLUSTER_KEY also works)")
    rt.add_argument("--autoscale", action="store_true",
                    help="run the closed-loop autoscaler (scale replicas "
                         "out/in from the telemetry rollup; spawns from "
                         "CAKE_SCALE_SPAWN_CMD)")
    rt.set_defaults(fn=cmd_route)
    tp = sub.add_parser("top", help="live fleet dashboard (telemetry "
                                    "rollup from a `route` process)")
    tp.add_argument("--api", default="127.0.0.1:8100",
                    help="fleet router base URL (default 127.0.0.1:8100)")
    tp.add_argument("--interval", type=float, default=2.0,
                    help="refresh period in seconds")
    tp.add_argument("--once", action="store_true",
                    help="print one plain-text snapshot and exit")
    tp.add_argument("--plain", action="store_true",
                    help="plain text instead of curses (implied when "
                         "stdout is not a tty)")
    tp.add_argument("--timeout", type=float, default=3.0,
                    help="per-fetch HTTP timeout in seconds")
    tp.set_defaults(fn=cmd_top)
    w = sub.add_parser("worker", help="run as a cluster worker")
    w.add_argument("--name", default=os.uname().nodename)
    w.add_argument("--cluster-key",
                   default=os.environ.get("CAKE_CLUSTER_KEY") or None)
    w.add_argument("--host", default="0.0.0.0")
    w.add_argument("--port", type=int, default=10128)
    w.add_argument("--model-dir", default=None,
                   help="pre-provisioned weights of the assigned range")
    w.add_argument("--cpu", action="store_true", help="run on the CPU")
    w.add_argument("--no-advertise", action="store_true",
                   help="do not answer UDP discovery (a topology file "
                        "names this worker)")
    w.set_defaults(fn=cmd_worker)
    return ap


def main(argv=None) -> int:
    ap = parser()
    args = ap.parse_args(argv)
    if getattr(args, "layers", None) and not args.flagship:
        ap.error("--layers cuts the flagship only")
    logging.basicConfig(level=logging.DEBUG if args.verbose
                        else logging.WARNING)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
