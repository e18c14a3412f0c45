"""Quantization detection (counterpart of cake_tpu/utils/quant.py:
detect_quantization). The port loads unquantized checkpoints only: a
GPTQ or fp8 `quantization_config` raises, naming the ROADMAP item that
ports them."""
from __future__ import annotations


class NoQuantization:
    """Tensors load as stored, cast to the model's dtype."""


def detect_quantization(config: dict) -> NoQuantization:
    """From config.json's quantization_config (top level or text_config)."""
    for root in (config, config.get("text_config") or {}):
        qc = root.get("quantization_config")
        if qc:
            method = qc.get("quant_method") or qc.get("fmt") or qc.get("mode")
            raise NotImplementedError(
                f"quantized checkpoint ({method!r}): GPTQ and fp8 loading "
                "are not ported yet (ROADMAP module 11)")
    return NoQuantization()
