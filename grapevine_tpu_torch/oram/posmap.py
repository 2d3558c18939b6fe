"""Position map, flat branch (port of ``grapevine_tpu/oram/posmap.py``'s
``posmap_impl="flat"`` path: the private int32[blocks + 1] table; the
last entry backs the dummy index)."""

from __future__ import annotations

import torch

from ..oblivious.primitives import scatter_drop


def lookup_remap_round(cfg, table, idxs, new_leaves, dummy_leaves, first_occ,
                       last_occ):
    """Resolve B positions with a fixed access schedule.

    Returns ``(table', leaves int32[B])``: ``leaves[i]`` is the
    round-start entry for first occurrences and ``dummy_leaves[i]``
    otherwise; the last occurrence's ``new_leaves`` wins each index's
    remap."""
    leaves = torch.where(first_occ, table[idxs.long()], dummy_leaves)
    remap_tgt = torch.where(last_occ, idxs, cfg.blocks + 1).long()  # OOB = drop
    return scatter_drop(table, remap_tgt, new_leaves), leaves
