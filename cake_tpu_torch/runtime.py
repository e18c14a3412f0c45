"""From a model name to a ready model and tokenizer (counterpart of
cake_tpu/runtime.py: CakeTokenizer, load_config_and_quant and the fully
local branch of build_text_model).

    model, tokenizer, model_id = build_text_model("/path/to/dir")

The name is a local HF-layout directory (config.json, *.safetensors,
optionally tokenizer.json and tokenizer_config.json), a directory with a
GGUF file (its config read from the file's metadata) or a repo id already
in the local Hugging Face cache. Nothing is downloaded. Quantized
checkpoints load through their strategy (utils/quant.py): FP8 block-wise
(dequantized at load, or with fp8_native=True kept at 1 byte per
parameter and dequantized per use by the kernel), AutoGPTQ 4-bit, GGUF.
With expert_offload an MoE model's experts stay in the checkpoint
(models/common/offload_model.py: OffloadedTextModel). With a cluster key
the model is a cluster master (cluster/master.py: DistributedTextModel)
over the workers of a topology file, or of UDP discovery.

    image_model = build_image_model("demo:flux")

`build_image_model` serves `cli image` and `cli serve --image-model`:
`demo:flux` is the tiny FLUX.1 pipeline on seeded weights, `demo:flux1-dev`
FLUX.1-dev's full widths and depth on seeded weights (the MMDiT native
FP8 with fp8_native), and a path is a FLUX.1 checkpoint (ComfyUI bundle
or BFL split layout), a diffusers SD 1.x / 2.x / SDXL directory or a
diffusers FLUX.2 directory; `demo:sd`, `demo:flux2` and `demo:flux2-klein`
seed those pipelines.

    audio_model = build_audio_model("demo:luxtts")

`build_audio_model` serves `cli tts` and `cli serve --audio-model`:
VibeVoice and LuxTTS, seeded demos or checkpoint directories.
"""
from __future__ import annotations

import json
import logging
import os
import time

from .device import parse_dtype, resolve_device
from .models.common.config import config_from_hf_dict
from .models.common.text_model import TextModel
from .tokenizer import PromptError, continuation_parts, render_chat
from .utils.bpe import JsonTokenizer
from .utils.chat_template import ChatTemplate, special_tokens, template_source
from .utils.hub import resolve_model
from .utils.loaders import ParamLoader, load_model_params
from .utils.quant import (Fp8Quantization, NoQuantization,
                          detect_quantization, fp8_native_quant)

log = logging.getLogger(__name__)


class CakeTokenizer:
    """encode / decode with the directory's tokenizer.json, and chat
    prompts through its chat template (ChatML when it has none). Without
    a tokenizer.json, a prompt of whitespace-separated token ids is taken
    as those ids, and ids decode to their numbers."""

    def __init__(self, model_dir: str):
        tok_json = os.path.join(model_dir, "tokenizer.json")
        self._tok = (JsonTokenizer.from_file(tok_json)
                     if os.path.exists(tok_json) else None)
        cfg_path = os.path.join(model_dir, "tokenizer_config.json")
        tcfg = {}
        if os.path.exists(cfg_path):
            with open(cfg_path, encoding="utf-8") as f:
                tcfg = json.load(f)
        self.chat_template = template_source(tcfg)
        self._template = (ChatTemplate(self.chat_template,
                                       special_tokens(tcfg))
                          if self.chat_template else None)

    def encode(self, text: str, add_special_tokens: bool = True) -> list[int]:
        if self._tok is not None:
            return self._tok.encode(text, add_special_tokens)
        parts = text.split()
        if parts and all(p.isdigit() for p in parts):
            return [int(p) for p in parts]
        raise PromptError(
            "no tokenizer available (pass raw token ids, e.g. '11 23 5')")

    def encode_chat_prompt(self, prompt: str) -> list[int]:
        """A templated prompt already holds its special tokens: the
        post-processor adds no second BOS."""
        return self.encode(prompt,
                           add_special_tokens=not bool(self.chat_template))

    def decode(self, ids) -> str:
        if self._tok is not None:
            return self._tok.decode(ids)
        return " ".join(str(int(i)) for i in ids)

    def apply_chat(self, messages: list[dict]) -> str:
        if self._template is not None:
            return self._template.render(messages)
        return render_chat(messages)

    def chat_prompt_ids(self, messages: list[dict]) -> list[int]:
        return self.encode_chat_prompt(self.apply_chat(messages))

    def continuation_prompt_ids(self, messages: list[dict]) -> list[int]:
        """Continuation mode: the history templated with its generation
        prompt, then the partial assistant turn verbatim (the reference's
        continuation_prompt_ids, text_model.py:1311)."""
        head, partial = continuation_parts(messages)
        return self.encode_chat_prompt(self.apply_chat(head) + partial)


def _gguf_files(model_dir: str) -> list[str]:
    return sorted(f for f in os.listdir(model_dir) if f.endswith(".gguf")) \
        if os.path.isdir(model_dir) else []


def load_config_and_quant(model_dir: str, arch: str | None = None):
    """(ModelConfig, quantization strategy, raw config dict) of a
    directory: from config.json, else from its GGUF file's metadata."""
    cfg_path = os.path.join(model_dir, "config.json")
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            raw = json.load(f)
        return config_from_hf_dict(raw, arch), detect_quantization(raw), raw
    gguf = _gguf_files(model_dir)
    if gguf:
        from .utils.gguf import GgufReader, gguf_config_dict
        raw = gguf_config_dict(GgufReader(os.path.join(model_dir, gguf[0])))
        return config_from_hf_dict(raw, arch), NoQuantization(), raw
    raise FileNotFoundError(f"no config.json or .gguf in {model_dir}")


def cluster_workers(cluster_key: str, topology_path: str | None = None,
                    discovery_timeout: float = 3.0,
                    min_workers: int = 0) -> list[dict]:
    """The workers of a cluster, as discovery replies ({"name", "host",
    "port", "caps"}): the topology file's nodes, else those that answer
    UDP discovery within discovery_timeout (stopping early once
    min_workers have)."""
    if topology_path:
        from .cluster.topology import Topology
        topo = Topology.from_path(topology_path)
        return [{"name": n.name, "host": n.addr[0], "port": n.addr[1],
                 "caps": {"backend": n.backend or "cpu",
                          "device": n.backend or "cpu",
                          "memory_bytes": n.memory_bytes,
                          "tflops": n.tflops}}
                for n in topo.nodes.values()]
    from .cluster import discover_workers
    return discover_workers(cluster_key, timeout=discovery_timeout,
                            expected=min_workers or None)


def build_text_model(model: str, dtype: str = "bf16", arch: str | None = None,
                     max_cache_len: int = 2048, seed: int = 42,
                     device=None, fp8_native: bool = False,
                     expert_offload: bool = False,
                     cluster_key: str | None = None,
                     topology_path: str | None = None,
                     discovery_timeout: float = 3.0, min_workers: int = 0):
    """(model, CakeTokenizer, model_id) of a local directory or a cached
    repo id, on `device` (default `cuda`): a TextModel, or with
    expert_offload an OffloadedTextModel whose MoE experts stay in the
    checkpoint and are read on demand into an LRU per layer (ParamLoader's
    default size; the reference's refusals: a model with no experts, and
    fp8_native with offload). model_id is the name's last path
    component. fp8_native keeps an FP8 checkpoint's projections at 1
    byte per parameter (raises for any other checkpoint).

    With cluster_key (the reference's cluster path, runtime.py:163-246):
    the workers of topology_path's file (each node's layers as its
    assignment), else of UDP discovery (cluster_workers), set up by
    cluster/master.py: master_setup (weights streamed, the master keeping
    the unassigned layers on `device`), and the model is a
    DistributedTextModel whose `topology` and `streams` record the
    cluster. No worker found: all local, with a warning. Expert offload
    applies to local serving only: ignored on the cluster path, with a
    warning, as in the reference."""
    dev = resolve_device(device)
    model_dir = resolve_model(model)
    cfg, quant, _ = load_config_and_quant(model_dir, arch)
    if fp8_native:
        if not isinstance(quant, Fp8Quantization):
            raise ValueError("--fp8-native requires an FP8 checkpoint "
                             f"(detected quantization: {quant.name})")
        quant = fp8_native_quant()
    workers = []
    if cluster_key:
        workers = cluster_workers(cluster_key, topology_path,
                                  discovery_timeout, min_workers)
        if not workers:
            log.warning("no workers found; running all-local")
    if expert_offload and workers:
        log.warning("--expert-offload applies to local serving only; "
                    "ignoring it for the cluster path")
        expert_offload = False
    if workers:
        return _cluster_model(model, model_dir, cfg, workers, cluster_key,
                              topology_path, dtype, max_cache_len,
                              fp8_native, dev)
    if expert_offload:
        if not cfg.num_experts:
            raise ValueError("--expert-offload needs an MoE model "
                             f"(arch {cfg.arch} has no experts)")
        if fp8_native:
            # the provider dequantizes on read: a native {"fp8",
            # "scale_inv"} expert has no offloaded consumer
            raise ValueError("--expert-offload and --fp8-native cannot "
                             "combine (offloaded experts dequant on read)")
    dt = parse_dtype(dtype)
    tokenizer = CakeTokenizer(model_dir)
    model_id = os.path.basename(model.rstrip("/"))
    t = time.perf_counter()
    gguf = _gguf_files(model_dir)
    if gguf and not any(f.endswith(".safetensors")
                        for f in os.listdir(model_dir)):
        from .utils.gguf import GgufStorage
        storage = GgufStorage(os.path.join(model_dir, gguf[0]),
                              cfg.model_prefix)
        params = ParamLoader(cfg, storage, dt, dev, quant,
                             expert_offload).load()
    else:
        params = load_model_params(cfg, model_dir, dt, dev, quant,
                                   expert_offload)
    log.info("loaded %s (%s, %d layers, quantization %s%s%s) in %.2fs",
             model_id, cfg.arch, cfg.num_hidden_layers, quant.name,
             ", native" if fp8_native else "",
             ", experts offloaded" if expert_offload else "",
             time.perf_counter() - t)
    if expert_offload:
        from .models.common.offload_model import OffloadedTextModel
        log.info("expert offload: %d experts per layer read from the "
                 "checkpoint, the trunk resident", cfg.num_experts)
        return (OffloadedTextModel(cfg, params, tokenizer=tokenizer,
                                   dtype=dt, device=dev,
                                   max_cache_len=max_cache_len),
                tokenizer, model_id)
    gen = TextModel(cfg, params, tokenizer=tokenizer, dtype=dt, device=dev,
                    seed=seed, max_cache_len=max_cache_len)
    return gen, tokenizer, model_id


def _cluster_model(model: str, model_dir: str, cfg, workers: list[dict],
                   cluster_key: str, topology_path: str | None, dtype: str,
                   max_cache_len: int, fp8_native: bool, dev):
    """The cluster path of build_text_model."""
    from .cluster.master import DistributedTextModel, master_setup
    assignments = None
    if topology_path:
        from .cluster.topology import Topology
        topo = Topology.from_path(topology_path)
        topo.assigned_layers()          # raises on a layer given twice
        assignments = {name: n.layer_range
                       for name, n in topo.nodes.items() if n.layer_range}
    t = time.perf_counter()
    setup = master_setup(model_dir, cluster_key, cfg, workers,
                         assignments=assignments, dtype_str=dtype,
                         max_cache_len=max_cache_len, fp8_native=fp8_native,
                         device=dev)
    tokenizer = CakeTokenizer(model_dir)
    gen = DistributedTextModel(cfg, setup.master_params, setup.stages,
                               tokenizer=tokenizer, dtype=parse_dtype(dtype),
                               device=dev, max_cache_len=max_cache_len)
    gen.topology = setup.topology
    gen.streams = setup.streams
    log.info("cluster master of %s: stages %s, set up in %.2fs",
             os.path.basename(model.rstrip("/")),
             [(s.kind, s.start, s.end) for s in setup.stages],
             time.perf_counter() - t)
    return gen, tokenizer, os.path.basename(model.rstrip("/"))


def _image_family(path: str) -> str | None:
    """"sd" for a diffusers SD directory, "flux2" for a FLUX.2 pipeline
    directory (the reference's detect_sd_checkpoint and
    detect_flux2_checkpoint sniffs), else None."""
    if not os.path.isdir(path):
        return None
    if all(os.path.exists(os.path.join(path, d, "config.json"))
           for d in ("unet", "vae")):
        return "sd"
    from .models.image import detect_flux2_checkpoint
    ckpt = detect_flux2_checkpoint(path)
    if ckpt is not None:
        ckpt.transformer.close()
        ckpt.vae.close()
        return "flux2"
    return None


def build_image_model(model: str, dtype: str = "bf16",
                      fp8_native: bool = False, device=None, seed: int = 42):
    """The image generator of `cli image` and `cli serve --image-model`,
    on `device` (default `cuda`): `demo:flux` (tiny FLUX.1, seeded),
    `demo:flux1-dev` (FLUX.1-dev's widths and depth, seeded), `demo:sd`
    (tiny SD, seeded), `demo:flux2` (tiny FLUX.2, seeded),
    `demo:flux2-klein` (FLUX.2-klein-4B's widths and depth with its
    Qwen3-4B encoder, seeded), a FLUX.1 checkpoint path, a diffusers SD
    1.x / 2.x / SDXL directory or a diffusers FLUX.2 directory.
    `fp8_native` is FLUX.1's: SD and FLUX.2 checkpoints carry no FP8, and
    both refuse it."""
    from .models.image import (Flux2ImageModel, FluxImageModel,
                               SDImageModel, load_flux2_image_model,
                               load_flux_image_model, load_sd_image_model,
                               seeded_flux1, seeded_flux2, tiny_flux2_config,
                               tiny_flux_config, tiny_sd_config)
    dt = parse_dtype(dtype)
    family = {"demo:sd": "sd", "demo:flux2": "flux2",
              "demo:flux2-klein": "flux2"}.get(model)
    path = None
    if family is None and not model.startswith("demo:"):
        path = os.path.expanduser(model)
        if not os.path.exists(path):
            path = resolve_model(model)
        family = _image_family(path)
    if family in ("sd", "flux2") and fp8_native:
        raise ValueError(f"--fp8-native is FLUX.1's: {family} checkpoints "
                         "carry no FP8 weights")
    if family == "sd":
        if path is None:
            return SDImageModel(tiny_sd_config(), dtype=dt, seed=seed,
                                device=device)
        return load_sd_image_model(path, dtype=dt, device=device)
    if family == "flux2":
        if model == "demo:flux2-klein":
            return seeded_flux2(dtype=dt, device=device, seed=seed)
        if path is None:
            return Flux2ImageModel(tiny_flux2_config(), dtype=dt, seed=seed,
                                   device=device)
        return load_flux2_image_model(path, dtype=dt, device=device)
    if model == "demo:flux1-dev":
        return seeded_flux1(dtype=dt, device=device, seed=seed,
                            fp8_native=fp8_native)
    if model.startswith("demo:"):
        return FluxImageModel(tiny_flux_config(), dtype=dt, seed=seed,
                              device=device)
    return load_flux_image_model(path, dtype=dt, fp8_native=fp8_native,
                                 device=device)


def build_audio_model(model: str, dtype: str = "bf16", device=None,
                      seed: int = 0):
    """The TTS generator of `cli tts` and `cli serve --audio-model`, on
    `device` (default `cuda`): `demo:vibevoice` (tiny, seeded),
    `demo:vibevoice-0.5b` (VibeVoice-Realtime-0.5B's widths, seeded),
    `demo:luxtts` (the tiny LuxTTS, seeded), or a VibeVoice or LuxTTS
    checkpoint directory (the LuxTTS Vocos in float32)."""
    from .models.audio import (LuxTTS, VibeVoiceTTS,
                               detect_luxtts_checkpoint,
                               detect_vibevoice_checkpoint, load_luxtts,
                               load_vibevoice, realtime_0_5b_config,
                               tiny_luxtts_config, tiny_tts_config)
    dt = parse_dtype(dtype)
    if model == "demo:luxtts":
        return LuxTTS(tiny_luxtts_config(), dtype=dt, seed=seed,
                      device=device)
    if model == "demo:vibevoice-0.5b":
        return VibeVoiceTTS(realtime_0_5b_config(), dtype=dt, seed=seed,
                            device=device)
    if model.startswith("demo"):
        return VibeVoiceTTS(tiny_tts_config(), dtype=dt, seed=seed,
                            device=device)
    path = os.path.expanduser(model)
    if not os.path.exists(path):
        path = resolve_model(model)
    if detect_vibevoice_checkpoint(path):
        return load_vibevoice(path, dtype=dt, device=device)
    if detect_luxtts_checkpoint(path):
        return load_luxtts(path, dtype=dt, device=device)
    raise ValueError(
        f"audio model {model!r}: not a demo: alias and not a recognizable "
        f"VibeVoice or LuxTTS checkpoint directory")
