"""Stable two-way partition rank (port of the 1-bit counting pass of
``grapevine_tpu/oblivious/radix.py``: ``_rank_pass`` at two bins, exposed
as ``partition_rank``).

The expiry sweep rebuilds the free-block list with it: two exclusive
ranks and one unique scatter, O(n), no sort. The multi-bit
``radix_rank`` and ``radix_group_sort`` belong to a later slice
(ROADMAP.md queue A item 12). Shapes and the instruction trace depend
only on the input's length, never on its values.
"""

from __future__ import annotations

import torch

I32 = torch.int32


def partition_rank(flags) -> torch.Tensor:
    """Positions of a stable two-way partition (False first): int32[B].

    ``pos[i]`` is where element i lands when all False-flagged elements
    precede all True ones, each side in its original order."""
    digit = flags.to(I32)
    b = digit.shape[0]
    iota = torch.arange(b, dtype=I32, device=digit.device)
    incl = torch.cumsum(digit, 0, dtype=I32)
    ones_before = incl - digit
    zeros_before = iota - ones_before
    n_zeros = b - incl[-1] if b else 0
    return torch.where(digit == 1, n_zeros + ones_before, zeros_before).to(I32)
