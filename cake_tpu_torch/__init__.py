"""PyTorch/CUDA port of cake-tpu for NVIDIA Hopper (H100).

The package mirrors `cake_tpu`'s module names so each function has an
obvious counterpart, but it imports `torch` only: nothing of JAX and
nothing of `cake_tpu`. Entry points run on `cuda` unless the caller asks
for `device="cpu"` (the CPU path exists for tests and parity checks).

The one TPU kernel of the reference, the Pallas flash prefill attention,
is hand-written CUDA here, one kernel per dtype route (bf16 and f16 on
wgmma, `csrc/flash_attn_wgmma.cu`; float32 on mma.sync in 3xTF32,
`csrc/flash_attn.cu`), bound through `ops/flash.py`; the paged decode
attention and the FP8 dequantization have hand-written kernels of their
own; every other op is plain PyTorch. `cluster/` runs the reference's
layer-sharded cluster over TCP, wire-compatible with it.
"""
from .device import parse_dtype, resolve_device

__all__ = ["parse_dtype", "resolve_device"]
