"""Carry a parameter tree of numpy arrays into the port.

The JAX package keeps parameters as nested dicts/lists of arrays under the
HF names (`layers[i].self_attn.q_proj.weight`, `embed_tokens.weight`,
...). `params_from_numpy` turns the same tree, converted to numpy, into
the port's tensors: same keys, on `device`, in `dtype`. The reference's
precomputed `rope` tables are dropped (the port computes its own), and
`ml_dtypes.bfloat16` arrays, which torch cannot take directly, go through
float32. A Gated DeltaNet's A_log and dt_bias stay float32 whatever the
model dtype, as the reference's loader keeps them. A native FP8 weight,
the reference's {"fp8", "scale_inv"} pair, stays one: its
`float8_e4m3fn` bytes cross as uint8 and are viewed as
torch.float8_e4m3fn, its scales stay float32. `tree_from_numpy` does
the same for the image models' trees (MMDiT, VAE, CLIP, T5), whose
structural None leaves (a VAE level with no upsample) stay None;
`sd_params_from_numpy` carries an SD / SDXL pipeline's tree,
`flux2_params_from_numpy` a FLUX.2 pipeline's and
`vibevoice_params_from_numpy` a VibeVoice model's.
"""
from __future__ import annotations

import numpy as np
import torch

from ..models.common.config import ModelConfig
from ..models.qwen3_5 import F32_PARAMS
from ..ops.fp8 import is_fp8

DROPPED_KEYS = ("rope",)


def _tensor(arr, device, dtype) -> torch.Tensor:
    a = np.asarray(arr)
    if a.dtype.kind not in "iub":       # floats, ml_dtypes' bfloat16 ('V')
        a = a.astype(np.float32)
    t = torch.from_numpy(np.ascontiguousarray(a))
    if t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def _fp8(arr, device) -> torch.Tensor:
    a = np.ascontiguousarray(np.asarray(arr)).view(np.uint8)
    return torch.from_numpy(a.copy()).view(torch.float8_e4m3fn).to(device)


def _convert(node, device, dtype):
    if node is None:
        return None
    if is_fp8(node):
        return {"fp8": _fp8(node["fp8"], device),
                "scale_inv": _tensor(node["scale_inv"], device,
                                     torch.float32)}
    if isinstance(node, dict):
        return {k: _convert(v, device,
                            torch.float32 if k in F32_PARAMS else dtype)
                for k, v in node.items() if k not in DROPPED_KEYS}
    if isinstance(node, (list, tuple)):
        return [_convert(v, device, dtype) for v in node]
    return _tensor(node, device, dtype)


def params_from_numpy(cfg: ModelConfig, tree: dict, device="cuda",
                      dtype: torch.dtype = torch.bfloat16) -> dict:
    """Nested dict of numpy arrays -> the port's parameter dict."""
    params = _convert(tree, device, dtype)
    n = len(params.get("layers", []))
    if n != cfg.num_hidden_layers:
        raise ValueError(f"tree has {n} layers, config "
                         f"{cfg.num_hidden_layers}")
    if "embed_tokens" not in params or "norm" not in params:
        raise ValueError("tree lacks embed_tokens or norm")
    return params


def tree_from_numpy(tree, device="cuda",
                    dtype: torch.dtype = torch.bfloat16):
    """Any nested dict/list of numpy arrays -> the same tree of tensors
    (an image component's parameters)."""
    return _convert(tree, device, dtype)


SD_PARTS = ("unet", "vae", "vae_enc")


def sd_params_from_numpy(tree: dict, device="cuda",
                         dtype: torch.dtype = torch.bfloat16,
                         vae_dtype: torch.dtype | None = None) -> dict:
    """The reference's SD / SDXL pipeline tree {"unet", "vae", "vae_enc"
    (optional)} of numpy arrays -> SDImageModel's params: the UNet in
    `dtype`, the VAE's decoder and encoder in `vae_dtype` (`dtype` when
    None). The reference's structural Nones (a level with no
    cross-attention in its "attn" list, no "down" at the last level, no
    "up" at the first) stay None; a tree from a mapped load, which has
    none of those entries, stays without them (unet_forward reads both)."""
    unknown = sorted(set(tree) - set(SD_PARTS))
    if unknown or "unet" not in tree or "vae" not in tree:
        raise ValueError(f"an SD tree has {SD_PARTS}, not {sorted(tree)}")
    out = {"unet": _convert(tree["unet"], device, dtype)}
    for part in SD_PARTS[1:]:
        if part in tree:
            out[part] = _convert(tree[part], device, vae_dtype or dtype)
    return out


def flux2_params_from_numpy(tree: dict, device="cuda",
                            dtype: torch.dtype = torch.bfloat16,
                            vae_dtype: torch.dtype = torch.float32) -> dict:
    """The reference's FLUX.2 pipeline tree {"transformer", "vae"} ->
    Flux2ImageModel's params: the transformer in `dtype`, the VAE in
    `vae_dtype` (float32, as the loaders keep it)."""
    if set(tree) != {"transformer", "vae"}:
        raise ValueError(f"a FLUX.2 tree has transformer and vae, not "
                         f"{sorted(tree)}")
    return {"transformer": _convert(tree["transformer"], device, dtype),
            "vae": _convert(tree["vae"], device, vae_dtype)}


VIBEVOICE_PARTS = ("base", "tts", "input_types", "head", "connector", "eos",
                   "vae", "vae_enc", "speech_scaling_factor",
                   "speech_bias_factor")
# parts kept in float32 whatever the model dtype (the VAE as the loaders
# keep it, and the two scalars)
VIBEVOICE_F32 = ("vae", "vae_enc", "speech_scaling_factor",
                 "speech_bias_factor")


def vibevoice_params_from_numpy(tree: dict, device="cuda",
                                dtype: torch.dtype = torch.bfloat16,
                                vae_dtype: torch.dtype = torch.float32
                                ) -> dict:
    """The reference's VibeVoice tree -> VibeVoiceTTS's params: the LM
    stacks (their `rope` tables dropped), type embeddings, head,
    connector and EOS classifier in `dtype`; the VAE's decoder and
    encoder in `vae_dtype`; the two scalars in float32."""
    unknown = sorted(set(tree) - set(VIBEVOICE_PARTS))
    if unknown:
        raise ValueError(f"a VibeVoice tree has {VIBEVOICE_PARTS}, not "
                         f"{unknown}")
    out = {}
    for part, node in tree.items():
        dt = dtype if part not in VIBEVOICE_F32 else (
            vae_dtype if part.startswith("vae") else torch.float32)
        out[part] = _convert(node, device, dt)
    return out
