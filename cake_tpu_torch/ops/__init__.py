"""Op library of the port: plain PyTorch functions, plus the hand-written
CUDA flash prefill kernels, one per dtype route (flash.py)."""
from .activations import gelu_mul, silu_mul
from .attention import causal_sdpa, make_attention_mask, multi_head_attention
from .flash import FLASH_MIN_SEQ, flash_attention, flash_attention_ref
from .linear import embedding, linear
from .norms import rms_norm
from .rope import RopeScaling, apply_rope, inv_frequencies, rope_tables
from .sampling import SamplingConfig, push_recent_token, sample_traced

__all__ = [n for n in dir() if not n.startswith("_")]
