"""Checkpoint-name -> parameter-tree loading for the image models
(counterpart of cake_tpu/utils/mapping.py: flatten_tree, unflatten_tree,
load_mapped_params, coverage_report).

A model family declares a mapping {tree path -> checkpoint tensor name};
this module reads each tensor (utils/safetensors_io.TensorStorage),
checks its shape against the expected tree (shape-only tensors on the
"meta" device, so nothing is allocated), casts it on its device and
reports what the checkpoint holds that nothing read. Path syntax: dotted,
integer segments index lists ("double.3.img.qkv.weight").

Both FP8 paths of the reference: a float8-stored tensor is dequantized at
load (times its per-tensor `.scale_weight` when the checkpoint has one,
the ComfyUI scaled-FP8 convention; 1.0 for a plain cast), or with
fp8_native a 2-D one stays a native pair {"fp8", "scale_inv"}, the
per-tensor scale broadcast over the 128 x 128 scale grid that
ops/linear.py hands to the dequant kernel.
"""
from __future__ import annotations

import logging

import torch

from ..ops.fp8 import scale_shape

log = logging.getLogger("cake_tpu_torch.mapping")


def flatten_tree(tree, prefix: str = "") -> dict[str, object]:
    """Nested dict/list tree -> {dotted path: leaf}; None leaves (a
    structural "no upsample here") are dropped."""
    out: dict[str, object] = {}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    elif tree is None:
        return {}
    else:
        return {prefix: tree}
    for k, v in items:
        out.update(flatten_tree(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def unflatten_tree(flat: dict[str, object]):
    """Inverse of flatten_tree: contiguous integer keys become lists."""
    root: dict = {}
    for path, leaf in flat.items():
        parts = path.split(".")
        node = root
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = leaf

    def listify(node):
        if not isinstance(node, dict):
            return node
        keys = list(node.keys())
        if keys and all(k.isdigit() for k in keys):
            idx = sorted(int(k) for k in keys)
            if idx == list(range(len(idx))):
                return [listify(node[str(i)]) for i in idx]
        return {k: listify(v) for k, v in node.items()}
    return listify(root)


def _more(items: list, n: int = 8) -> str:
    return (f"{sorted(items)[:n]}"
            + (f" (+{len(items) - n} more)" if len(items) > n else ""))


def dequant_at_load(arr: torch.Tensor, scale: torch.Tensor | None,
                    dtype) -> torch.Tensor:
    """The at-load FP8 read: a float32 cast, times the per-tensor scale
    (0-d) when there is one, one rounding to dtype: the kernel's
    arithmetic (one RNE rounding of the float32 product), so a native
    model and one dequantized at load compute with the same weights."""
    arr = arr.float()
    if scale is not None:
        arr = arr * scale.float()
    return arr.to(dtype)


def load_mapped_params(storage, mapping: dict[str, str], expected,
                       dtype=torch.bfloat16, device="cpu",
                       fp8_native: bool = False,
                       transforms: dict | None = None) -> dict:
    """The tree of `expected` (shape-only leaves) read through `mapping`
    onto `device` in `dtype`. `transforms`: {path: fn(tensor) -> tensor}
    applied to a tensor before its shape is checked (SD's 1x1-conv
    projections squeezed to linears). Raises ValueError listing every
    unmapped path and missing tensor at once, then every shape mismatch,
    as the reference does (same messages)."""
    transforms = transforms or {}
    flat_expected = flatten_tree(expected)
    problems: list[str] = []
    unmapped = [p for p in flat_expected if p not in mapping]
    if unmapped:
        problems.append(f"pytree paths without a mapping entry: "
                        f"{_more(unmapped)}")
    missing = [n for p, n in mapping.items()
               if p in flat_expected and n not in storage]
    if missing:
        problems.append(f"checkpoint tensors not found: {_more(missing)}")
    if problems:
        raise ValueError("checkpoint mapping failed:\n  " +
                         "\n  ".join(problems))
    flat_out: dict[str, object] = {}
    for path, exp in flat_expected.items():
        name = mapping[path]
        scale = name[:-len(".weight")] + ".scale_weight" \
            if name.endswith(".weight") else None
        scaled = scale is not None and scale in storage
        arr = storage.read(name, device)
        if path in transforms:
            arr = transforms[path](arr)
        is_f8 = arr.dtype == torch.float8_e4m3fn
        if tuple(arr.shape) != tuple(exp.shape):
            problems.append(f"{name} -> {path}: shape {tuple(arr.shape)} "
                            f"!= expected {tuple(exp.shape)}")
            continue
        if fp8_native and is_f8 and arr.dim() == 2:
            s = float(storage.read(scale)) if scaled else 1.0
            flat_out[path] = {"fp8": arr, "scale_inv": torch.full(
                scale_shape(*arr.shape), s, dtype=torch.float32,
                device=device)}
            continue
        if is_f8:
            flat_out[path] = dequant_at_load(
                arr, storage.read(scale, device) if scaled else None, dtype)
            continue
        flat_out[path] = arr.to(dtype)
    if problems:
        raise ValueError("checkpoint mapping failed:\n  " +
                         "\n  ".join(problems))
    return unflatten_tree(flat_out)


def coverage_report(storage, mapping: dict[str, str], prefix: str = "",
                    ignore: tuple[str, ...] = ()) -> list[str]:
    """Checkpoint tensors under `prefix` that no mapping entry reads (nor
    an `ignore` prefix explains), returned and warned about."""
    used = set(mapping.values())
    used |= {n[:-len(".weight")] + ".scale_weight" for n in used
             if n.endswith(".weight")}
    unused = [n for n in storage.names()
              if n.startswith(prefix) and n not in used
              and not any(n.startswith(i) for i in ignore)]
    if unused:
        log.warning("checkpoint tensors not consumed under %r: %s%s",
                    prefix, sorted(unused)[:6],
                    f" (+{len(unused) - 6} more)" if len(unused) > 6 else "")
    return unused
