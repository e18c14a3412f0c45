"""LuxTTS checkpoint directories written from a model's weights, with the
published tensor names, for the smoke and the tests: the repository holds
no LuxTTS checkpoint, config.json or tokens.txt, and nothing may be
downloaded.

    tts = LuxTTS(LuxTTSConfig(), dtype=torch.bfloat16, seed=0,
                 device="cuda")
    write_luxtts_checkpoint(dir, tts)

The directory: config.json ({"model": the LuxTTSConfig's fields the
loader reads, "feature": n_fft, hop_length, n_mels, sample_rate}),
model.safetensors (embed.*, text_encoder.*, fm_decoder.* under the names
of models/audio/luxtts_loader.luxtts_mapping, in the model's dtype),
vocos.safetensors (backbone.*, head.* under vocos_mapping's names, in the
Vocos' own dtype, at any depth) and tokens.txt (one "symbol id" per
line, the space symbol included). Assumed, not taken from a published
checkpoint: the config.json fields beyond those the loader reads (none
are written), the symbol table (a pad, the space, a-z and some
punctuation; a release's is IPA), and the absence of the optional
cmudict-0.7b-ipa.txt.
"""
from __future__ import annotations

import json
import os

from ..models.audio.luxtts import LuxTTSConfig
from ..models.audio.luxtts_loader import luxtts_mapping, vocos_mapping
from ..utils.mapping import flatten_tree
from ..utils.safetensors_io import save_safetensors

# the assumed symbol table: id 0 a pad, 1 the word separator
SYMBOLS = ("_", " ", *"abcdefghijklmnopqrstuvwxyz", "'", ",", ".", "?",
           "!", "-")


def hf_config(cfg: LuxTTSConfig) -> dict:
    """The release config.json of a LuxTTSConfig."""
    fields = ("vocab_size", "feat_dim", "text_encoder_dim",
              "text_encoder_num_layers", "text_encoder_feedforward_dim",
              "text_encoder_num_heads", "text_encoder_cnn_module_kernel",
              "fm_decoder_dim", "fm_decoder_feedforward_dim",
              "fm_decoder_num_heads", "fm_decoder_num_layers",
              "fm_decoder_downsampling_factor",
              "fm_decoder_cnn_module_kernel", "query_head_dim",
              "value_head_dim", "pos_dim", "pos_head_dim", "time_embed_dim")
    model = {}
    for f in fields:
        v = getattr(cfg, f)
        model[f] = list(v) if isinstance(v, tuple) else v
    return {"model": model,
            "feature": {"n_fft": cfg.n_fft, "hop_length": cfg.hop_length,
                        "n_mels": cfg.n_mels,
                        "sample_rate": cfg.sample_rate}}


def checkpoint_tensors(tts) -> tuple[dict, dict]:
    """(model.safetensors' tensors, vocos.safetensors' tensors) of a
    LuxTTS under their published names."""
    cfg, p = tts.cfg, tts.params
    flat = flatten_tree({k: v for k, v in p.items() if k != "vocos"})
    main = {name: flat[path] for path, name in luxtts_mapping(cfg).items()}
    flat_v = flatten_tree(p["vocos"])
    vocos = {name: flat_v[path] for path, name in vocos_mapping(cfg).items()}
    return main, vocos


def write_tokens(path: str) -> None:
    """tokens.txt of SYMBOLS: one "symbol id" a line."""
    with open(path, "w", encoding="utf-8") as f:
        for i, sym in enumerate(SYMBOLS):
            f.write(f"{sym} {i}\n")


def write_luxtts_checkpoint(model_dir: str, tts) -> int:
    """Write config.json, model.safetensors, vocos.safetensors and
    tokens.txt; returns the bytes of tensor data written."""
    if len(SYMBOLS) > tts.cfg.vocab_size:
        raise ValueError(f"{len(SYMBOLS)} symbols for a vocabulary of "
                         f"{tts.cfg.vocab_size}")
    os.makedirs(model_dir, exist_ok=True)
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump(hf_config(tts.cfg), f, indent=1)
    main, vocos = checkpoint_tensors(tts)
    n = save_safetensors(os.path.join(model_dir, "model.safetensors"), main,
                         {"format": "pt"})
    n += save_safetensors(os.path.join(model_dir, "vocos.safetensors"),
                          vocos, {"format": "pt"})
    write_tokens(os.path.join(model_dir, "tokens.txt"))
    return n
