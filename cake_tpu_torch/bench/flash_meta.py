"""Cases of the flash kernels' device-meta form, shared by chip_smoke.py
(phase 3) and tests/test_torch_flash_card.py. Needs a CUDA card.

The device-meta form (ops/flash.py: flash_attention_meta_kernel) reads
{row, q_offset, valid_len} from device memory; in append mode its K/V are
a whole pool of rows. Each case holds it against
  * the plain version on the same row and limits (the tolerance of the
    route),
  * the host-int form (flash_attention_kernel's path) on a batch-1 view
    of the same row, launched under the same plan, so with the same f32
    cluster split (static_plan's): the same bits,
  * itself, launched twice: the same bits.
Cases: D 64 and 128 at the flagship's heads (16/8), D 256 at
Gemma-3-1B's (4/1); fresh at offset 0, append at 0, 256 and 3840; K/V
row 2 of a pool of 4 rows of 4096 (row 0 for fresh, whose K/V are the
chunk); Sq 256; one ragged valid length (200).
"""
from __future__ import annotations

import dataclasses

import torch

from ..ops import flash

POOL_ROWS, POOL_CTX, ROW, SQ = 4, 4096, 2, 256

# (name, d, hq, hkv, mode, q_offset, valid_len)
META_CASES = [
    (f"d{d}_{mode}{'' if mode == 'fresh' else off}{tag}", d, hq, hkv, mode,
     off, vl)
    for d, hq, hkv in ((64, 16, 8), (128, 16, 8), (256, 4, 1))
    for mode, off, vl, tag in (
        ("fresh", 0, SQ, ""), ("fresh", 0, 200, "_v200"),
        ("append", 0, SQ, ""), ("append", 256, SQ, ""),
        ("append", 3840, SQ, ""), ("append", 256, 200, "_v200"))
]


@dataclasses.dataclass
class MetaCase:
    name: str
    mode: str
    q: torch.Tensor
    k: torch.Tensor          # the form's K/V: the chunk, or the whole pool
    v: torch.Tensor
    meta: torch.Tensor       # int32 [3] on the card
    k_row: torch.Tensor      # the host-int form's K/V: the row's view
    v_row: torch.Tensor
    kw: dict                 # the host-int form's q_offset, valid_len


def meta_case(name, d, hq, hkv, mode, q_offset, valid_len,
              dtype) -> MetaCase:
    gen = torch.Generator(device="cuda").manual_seed(sum(map(ord, name)))

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)
    q = rnd(1, SQ, hq, d)
    if mode == "fresh":
        k, v = rnd(1, SQ, hkv, d), rnd(1, SQ, hkv, d)
        row, k_row, v_row = 0, k, v
    else:
        k = rnd(POOL_ROWS, POOL_CTX, hkv, d)
        v = rnd(POOL_ROWS, POOL_CTX, hkv, d)
        row, k_row, v_row = ROW, k[ROW:ROW + 1], v[ROW:ROW + 1]
    meta = torch.tensor([row, q_offset, valid_len], dtype=torch.int32,
                        device="cuda")
    return MetaCase(name, mode, q, k, v, meta, k_row, v_row,
                    dict(q_offset=q_offset, valid_len=valid_len))


def run_meta(c: MetaCase) -> torch.Tensor:
    return flash.flash_attention_meta_kernel(c.q, c.k, c.v, c.meta, c.mode)


def run_host_int(c: MetaCase) -> torch.Tensor:
    """The host-int form on the row's view, under the plan the device-meta
    form launches with (its f32 cluster split included)."""
    route = flash.kernel_route(c.q.dtype)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = flash.plan_flash(c.q.shape, c.k_row.shape, route=route, **c.kw)
    if route == "f32":
        plan = dataclasses.replace(plan, split=flash.static_plan(
            c.q.shape, c.k.shape, route=route, sms=sms).split)
    return flash._launch(route, c.q, c.k_row, c.v_row,
                         1.0 / c.q.shape[3] ** 0.5, plan)


def run_plain(c: MetaCase) -> torch.Tensor:
    return flash.flash_attention_ref(c.q, c.k_row, c.v_row, **c.kw)


def check(c: MetaCase) -> dict:
    """max_abs_err against the plain version, bits equal to the host-int
    form, bits equal across two launches, and the f32 split used."""
    got, again = run_meta(c), run_meta(c)
    twin = run_host_int(c)
    torch.cuda.synchronize()
    want = run_plain(c)
    plan = flash.static_plan(
        c.q.shape, c.k.shape, route=flash.kernel_route(c.q.dtype),
        sms=torch.cuda.get_device_properties(0).multi_processor_count)
    return {
        "max_abs_err": (got.float() - want.float()).abs().max().item(),
        "finite": bool(torch.isfinite(got).all().item()),
        "same_as_host_int": torch.equal(got, twin),
        "same_twice": torch.equal(got, again),
        "split": getattr(plan, "split", 1),
    }
