"""From a model name to a ready model and tokenizer (counterpart of
cake_tpu/runtime.py: CakeTokenizer, load_config_and_quant and the fully
local branch of build_text_model).

    model, tokenizer, model_id = build_text_model("/path/to/dir")

The name is a local HF-layout directory (config.json, *.safetensors,
optionally tokenizer.json and tokenizer_config.json) or a repo id already
in the local Hugging Face cache. Nothing is downloaded; GGUF files and
quantized checkpoints raise (ROADMAP module 11).
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
from .utils.loaders import load_model_params
from .utils.quant import detect_quantization

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


def load_config_and_quant(model_dir: str, arch: str | None = None):
    """The ModelConfig of a directory's config.json, once its quantization
    check has passed (the port loads unquantized checkpoints only)."""
    cfg_path = os.path.join(model_dir, "config.json")
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            raw = json.load(f)
        detect_quantization(raw)
        return config_from_hf_dict(raw, arch)
    if os.path.isdir(model_dir) and any(f.endswith(".gguf")
                                        for f in os.listdir(model_dir)):
        raise NotImplementedError(
            f"{model_dir} holds GGUF weights only: GGUF loading is not "
            "ported yet (ROADMAP module 11)")
    raise FileNotFoundError(f"no config.json or .gguf in {model_dir}")


def build_text_model(model: str, dtype: str = "bf16", arch: str | None = None,
                     max_cache_len: int = 2048, seed: int = 42,
                     device=None):
    """(TextModel, CakeTokenizer, model_id) of a local directory or a
    cached repo id, on `device` (default `cuda`). model_id is the name's
    last path component."""
    dev = resolve_device(device)
    model_dir = resolve_model(model)
    cfg = load_config_and_quant(model_dir, arch)
    dt = parse_dtype(dtype)
    tokenizer = CakeTokenizer(model_dir)
    model_id = os.path.basename(model.rstrip("/"))
    t = time.perf_counter()
    params = load_model_params(cfg, model_dir, dt, dev)
    log.info("loaded %s (%s, %d layers) in %.2fs", model_id, cfg.arch,
             cfg.num_hidden_layers, time.perf_counter() - t)
    gen = TextModel(cfg, params, tokenizer=tokenizer, dtype=dt, device=dev,
                    seed=seed, max_cache_len=max_cache_len)
    return gen, tokenizer, model_id
