"""Quantization strategies: detection from config.json and the load of
each weight (counterpart of cake_tpu/utils/quant.py: NoQuantization,
Fp8Quantization, GptqQuantization, unpack_int4, dequantize_gptq_4bit,
fp8_native_quant, detect_quantization).

A strategy intercepts the loader's reads by name, as the reference's
does: `load(storage, name, device, dtype)` either reads the tensor's
companions (FP8's `weight_scale_inv`; GPTQ's `qweight`, `scales`,
`qzeros` and `g_idx`) and dequantizes, or falls through to a plain read
cast to dtype. `sources(storage, name)` names the stored tensors a load
reads, for the loader's account of unused tensors.

FP8 dequantizes on the load's device: on a card through the dequant
kernel (ops/fp8.py), straight to the model's dtype, which is one round
to nearest even of the reference's float32 product, so the same bits as
its dequant-to-float32-then-cast. With keep_native the weight stays
{"fp8", "scale_inv"} (1 byte per parameter in device memory) and
`linear` dequantizes it per use. GPTQ dequantizes in float32 on the
load's device (integer ops and one exact-input multiply: the same bits
on the CPU and on a card), then casts.
"""
from __future__ import annotations

import torch

from ..ops.fp8 import dequant_fp8_blockwise


class NoQuantization:
    """Tensors load as stored, cast to the model's dtype."""
    name = "none"
    vram_factor = 1.0

    def has(self, storage, name: str) -> bool:
        return name in storage

    def sources(self, storage, name: str) -> list[str]:
        return [name]

    def load(self, storage, name: str, device, dtype: torch.dtype):
        return storage.read(name, device, dtype)


class Fp8Quantization(NoQuantization):
    """Block-wise FP8 (e4m3) with per-128x128 `weight_scale_inv`. Default:
    dequantized at load; keep_native keeps {"fp8", "scale_inv"}."""
    name = "fp8"
    vram_factor = 2.0

    def __init__(self, keep_native: bool = False):
        self.keep_native = keep_native
        if keep_native:
            self.vram_factor = 1.0

    def _scale(self, storage, name: str) -> str | None:
        scale = name.replace(".weight", ".weight_scale_inv")
        return scale if name.endswith(".weight") and scale in storage \
            else None

    def sources(self, storage, name: str) -> list[str]:
        scale = self._scale(storage, name)
        return [name] + ([scale] if scale else [])

    def load(self, storage, name: str, device, dtype: torch.dtype):
        scale = self._scale(storage, name)
        if scale is None:
            return storage.read(name, device, dtype)
        w = storage.read(name, device)
        s = storage.read(scale, device, torch.float32)
        if self.keep_native:
            return {"fp8": w, "scale_inv": s}
        return dequant_fp8_blockwise(w, s, dtype)


class GptqQuantization(NoQuantization):
    """AutoGPTQ 4-bit: qweight int32 [in/8, out] (8 nibbles along in),
    scales f16 [groups, out], qzeros int32 [groups, out/8], optionally
    g_idx [in]; weight[o, i] = (q - zero - 1) * scale of i's group."""
    name = "gptq"
    vram_factor = 4.0

    def __init__(self, group_size: int = 128, desc_act: bool = False):
        self.group_size = group_size
        self.desc_act = desc_act

    def _qname(self, storage, name: str) -> str | None:
        q = name.replace(".weight", ".qweight")
        return q if name.endswith(".weight") and q in storage else None

    def has(self, storage, name: str) -> bool:
        return name in storage or \
            name.replace(".weight", ".qweight") in storage

    def sources(self, storage, name: str) -> list[str]:
        if self._qname(storage, name) is None:
            return [name]
        stem = name[:-len(".weight")]
        return [n for n in (f"{stem}.qweight", f"{stem}.scales",
                            f"{stem}.qzeros", f"{stem}.g_idx")
                if n in storage]

    def load(self, storage, name: str, device, dtype: torch.dtype):
        if self._qname(storage, name) is None:
            return storage.read(name, device, dtype)
        stem = name[:-len(".weight")]
        qweight = storage.read(f"{stem}.qweight", device)
        scales = storage.read(f"{stem}.scales", device, torch.float32)
        qzeros = storage.read(f"{stem}.qzeros", device)
        gname = f"{stem}.g_idx"
        g_idx = storage.read(gname, device).long() if gname in storage \
            else None
        if self.desc_act and g_idx is None:
            raise NotImplementedError(
                f"GPTQ desc_act=true checkpoint without a g_idx tensor for "
                f"{name}: sequential group mapping would silently produce "
                f"wrong weights")
        return dequantize_gptq_4bit(qweight, scales, qzeros,
                                    self.group_size, g_idx).to(dtype)


def unpack_int4(packed: torch.Tensor, axis: int) -> torch.Tensor:
    """Unpack 8 x 4-bit nibbles from each 32-bit word along `axis`, least
    significant first (int32 in, int32 out; the arithmetic shift of a
    negative word keeps the masked nibble)."""
    shifts = torch.arange(8, dtype=torch.int32, device=packed.device) * 4
    nibbles = (packed.to(torch.int32)[..., None] >> shifts) & 0xF
    nibbles = nibbles.movedim(-1, axis + 1 if axis >= 0 else axis)
    shape = list(packed.shape)
    shape[axis] *= 8
    return nibbles.reshape(shape)


def dequantize_gptq_4bit(qweight: torch.Tensor, scales: torch.Tensor,
                         qzeros: torch.Tensor, group_size: int = 128,
                         g_idx: torch.Tensor | None = None) -> torch.Tensor:
    """[out_features, in_features] float32. g_idx (each in-feature's
    group) overrides the sequential arange // group_size mapping, as
    act-order (desc_act) checkpoints need."""
    q = unpack_int4(qweight, 0)                     # [in, out]
    zeros = unpack_int4(qzeros, 1)                  # [groups, out]
    if g_idx is None:
        g_idx = torch.arange(q.shape[0], device=q.device) // group_size
    w = (q - zeros[g_idx] - 1).float() * scales.float()[g_idx]
    return w.t().contiguous()


def fp8_native_quant() -> Fp8Quantization:
    """The keep-native FP8 strategy (1 byte per parameter on the card,
    dequantized per use by the kernel)."""
    return Fp8Quantization(keep_native=True)


def detect_quantization(config: dict):
    """From config.json's quantization_config (top level or
    text_config): GPTQ by quant_method or by an affine 4-bit mode (8-bit
    raises), FP8 by quant_method or fmt, else none."""
    for root in (config, config.get("text_config") or {}):
        qc = root.get("quantization_config")
        if not qc:
            continue
        method = qc.get("quant_method", "")
        if method == "gptq" or (qc.get("mode") == "affine"
                                and qc.get("bits") == 4):
            bits = int(qc.get("bits", 4))
            if bits != 4:
                raise NotImplementedError(
                    f"GPTQ {bits}-bit not supported (4-bit only)")
            return GptqQuantization(int(qc.get("group_size", 128)),
                                    desc_act=bool(qc.get("desc_act", False)))
        if method == "fp8" or qc.get("fmt") in ("e4m3", "float8_e4m3fn"):
            return Fp8Quantization()
    return NoQuantization()
