"""Inputs of the paged decode kernel's checks: a block pool, tables and
frontiers built from a seed, with the edge cases the kernel must get right.
`chip_smoke.py` phase 3 and `tests/test_torch_paged_card.py` hold the
kernel against its plain version on them; `tests/test_torch_paged.py`
holds the plain version against the JAX reference on small ones.

Physical blocks are handed out in a seeded random order, so a row's blocks
are scattered over the pool as after real churn. Options:
  * null_rows: rows whose table is all NULL (an inactive slot), frontier 0:
    no key is visible, so their output is don't-care (`visible_rows`);
  * stale: the row's block at table entry 1 holds a previous tenant's
    positions from another range (pos // bt != 1), and its live block
    holds a previous tenant's positions past the frontier in its own
    range: both must stay invisible;
  * shared: row 1 maps row 0's first block at its own entry 0 (a prefix
    block shared by refcount);
  * scatter=False: blocks handed out in table order instead, each row's
    blocks adjacent in the pool (a layout to time against, not a case).
"""
from __future__ import annotations

import torch


def paged_case(frontiers: list[int], dtype=torch.float32, device="cpu",
               bt: int = 16, hq: int = 16, hkv: int = 8, d: int = 128,
               ctx: int = 4096, null_rows: int = 0, stale: bool = False,
               shared: bool = False, seed: int = 0,
               scatter: bool = True) -> dict:
    """{q, k, v, pos, tables, frontier} on `device`, plus `visible_rows`
    (the rows with at least one visible key) and `null` (the sink's id).
    Random values are drawn in float32 on the CPU, so one seed gives the
    same inputs on every device."""
    gen = torch.Generator().manual_seed(seed)
    m = ctx // bt
    b = len(frontiers) + null_rows
    nb = sum(p // bt + 1 for p in frontiers) + 1
    perm = iter(torch.randperm(nb, generator=gen).tolist() if scatter
                else range(nb))
    tables = torch.full((b, m), nb, dtype=torch.int32)
    pos = torch.full((nb + 1, bt), -1, dtype=torch.int32)
    ar = torch.arange(bt, dtype=torch.int32)
    for r, p in enumerate(frontiers):
        for j in range(p // bt + 1):
            pid = next(perm)
            tables[r, j] = pid
            pos[pid] = torch.where(j * bt + ar <= p, j * bt + ar, -1)
        if stale:
            live = int(tables[r, p // bt])
            pos[live] = (p // bt) * bt + ar          # past p: stale, same range
            if p // bt >= 2:
                pos[int(tables[r, 1])] = 7 * bt + ar     # another range
    spare = next(perm)                                # mapped by no row
    pos[spare] = ar
    if shared and len(frontiers) >= 2:
        tables[1, 0] = tables[0, 0]

    def rnd(*shape):
        return torch.randn(shape, generator=gen).to(dtype).to(device)
    frontier = torch.tensor(list(frontiers) + [0] * null_rows,
                            dtype=torch.int32)
    return {"q": rnd(b, 1, hq, d), "k": rnd(nb + 1, bt, hkv, d),
            "v": rnd(nb + 1, bt, hkv, d), "pos": pos.to(device),
            "tables": tables.to(device), "frontier": frontier.to(device),
            "visible_rows": list(range(len(frontiers))), "null": nb}


def case_args(case: dict) -> tuple:
    """(q, k, v, pos, tables, frontier): the kernel's positional inputs."""
    return tuple(case[n] for n in ("q", "k", "v", "pos", "tables",
                                   "frontier"))


# (name, paged_case kwargs) of the kernel checks on the card: bt 16 and
# 64, D 128, 64 and 256 (groups 2 and 8), ragged frontiers in one batch with an all-NULL row,
# stale tenants, a shared block; frontiers whose live block counts are
# 1, C - 1, C, C + 1 and 2C + 1 for the kernel's cluster of C = 8 ranks
# (each rank walks every C-th block), at bt 16 and 64; and the attention
# shapes of the checkpoint families (synth_checkpoint.family_attention),
# named by family, GQA group and a D other than 128
CARD_CASES = [
    ("ragged_bt16", dict(frontiers=[1, 15, 16, 620, 4000], null_rows=1)),
    ("ragged_bt64", dict(frontiers=[1, 15, 16, 620, 4000], bt=64,
                         null_rows=1)),
    ("ragged_d64", dict(frontiers=[1, 15, 16, 620, 4000], d=64,
                        null_rows=1)),
    ("stale_shared_bt16", dict(frontiers=[40, 620, 300], stale=True,
                               shared=True)),
    ("stale_shared_bt64_d64", dict(frontiers=[200, 620, 4000], bt=64, d=64,
                                   stale=True, shared=True)),
    ("mha_d64", dict(frontiers=[33, 620], hq=8, hkv=8, d=64)),
    ("cluster_edges_bt16", dict(frontiers=[5, 100, 127, 128, 270])),
    ("cluster_edges_bt64", dict(frontiers=[63, 400, 511, 512, 1060],
                                bt=64)),
    ("stale_shared_d256_g8", dict(frontiers=[40, 620, 300], hq=16, hkv=2,
                                  d=256, stale=True, shared=True)),
    ("cluster_edges_d256_g2", dict(frontiers=[5, 100, 127, 128, 270],
                                   hq=4, hkv=2, d=256)),
]
FAMILY_CASE_DATA = {
    "olmo2": dict(frontiers=[1, 620, 4000], null_rows=1),
    "phi4": dict(frontiers=[15, 620, 2000], stale=True, shared=True),
    "exaone4": dict(frontiers=[16, 620, 3000], null_rows=1),
    "gemma3": dict(frontiers=[1, 15, 16, 620, 4000], null_rows=1),
}


def _family_cases() -> list:
    from .synth_checkpoint import family_attention
    cases = []
    for fam, data in FAMILY_CASE_DATA.items():
        a = family_attention(fam)
        shape = dict(hq=a["hq"], hkv=a["hkv"], d=a["d"])
        name = f"{fam}_g{a['hq'] // a['hkv']}" + (
            f"_d{a['d']}" if a["d"] != 128 else "")
        cases.append((name, dict(data, **shape)))
    return cases


CARD_CASES += _family_cases()
