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
from .utils.bpe import BpeTokenizer
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
        self._tok = (BpeTokenizer.from_file(tok_json)
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


def build_text_model(model: str, dtype: str = "bf16", arch: str | None = None,
                     max_cache_len: int = 2048, seed: int = 42,
                     device=None, fp8_native: bool = False):
    """(TextModel, CakeTokenizer, model_id) of a local directory or a
    cached repo id, on `device` (default `cuda`). model_id is the name's
    last path component. fp8_native keeps an FP8 checkpoint's projections
    at 1 byte per parameter (raises for any other checkpoint)."""
    dev = resolve_device(device)
    model_dir = resolve_model(model)
    cfg, quant, _ = load_config_and_quant(model_dir, arch)
    if fp8_native:
        if not isinstance(quant, Fp8Quantization):
            raise ValueError("--fp8-native requires an FP8 checkpoint "
                             f"(detected quantization: {quant.name})")
        quant = fp8_native_quant()
    dt = parse_dtype(dtype)
    tokenizer = CakeTokenizer(model_dir)
    model_id = os.path.basename(model.rstrip("/"))
    t = time.perf_counter()
    gguf = _gguf_files(model_dir)
    if gguf and not any(f.endswith(".safetensors")
                        for f in os.listdir(model_dir)):
        from .utils.gguf import GgufStorage
        with GgufStorage(os.path.join(model_dir, gguf[0]),
                         cfg.model_prefix) as storage:
            params = ParamLoader(cfg, storage, dt, dev, quant).load()
    else:
        params = load_model_params(cfg, model_dir, dt, dev, quant)
    log.info("loaded %s (%s, %d layers, quantization %s%s) in %.2fs",
             model_id, cfg.arch, cfg.num_hidden_layers, quant.name,
             ", native" if fp8_native else "", time.perf_counter() - t)
    gen = TextModel(cfg, params, tokenizer=tokenizer, dtype=dt, device=dev,
                    seed=seed, max_cache_len=max_cache_len)
    return gen, tokenizer, model_id
