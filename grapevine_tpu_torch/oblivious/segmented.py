"""Segmented prefix primitives (port of the parts of
``grapevine_tpu/oblivious/segmented.py`` the dense engine uses).

The saturating-counter monoid ``f(x) = min(max(x + a, lo), hi)`` is
closed under composition, so every op's "count before me" in a mailbox
occupancy walk is an exclusive segmented scan over (a, lo, hi) triples.
The reference runs it as ``lax.associative_scan``; here it is a
Hillis-Steele doubling scan (log2 B vector steps). Composition of these
clamps is exact integer arithmetic, so any parenthesisation yields the
same counter values.
"""

from __future__ import annotations

import torch

from ..u32 import widen

I32 = torch.int32

#: lo/hi sentinels for the identity element (int32-safe, never saturate)
_NEG = -(1 << 30)
_POS = 1 << 30


def sat_compose(f, g):
    """(g ∘ f): apply f first, then g. Both (add, lo, hi) triples."""
    a1, l1, h1 = f
    a2, l2, h2 = g
    return (
        a1 + a2,
        torch.minimum(torch.maximum(l1 + a2, l2), h2),
        torch.minimum(torch.maximum(h1 + a2, l2), h2),
    )


def sat_apply(f, x):
    """Apply a saturating element to a counter value."""
    a, lo, hi = f
    return torch.minimum(torch.maximum(x + a, lo), hi)


def segmented_exclusive_sat_scan(elems, seg_start):
    """Exclusive segmented scan of (add, lo, hi) int32[B] triples in
    segment-contiguous order; ``seg_start`` bool[B] marks segment starts.
    Segment starts get the identity element."""
    flags = seg_start.clone()
    f = tuple(e.clone() for e in elems)
    b = flags.shape[0]
    off = 1
    while off < b:
        # element i covers (i - off, i]; merge the block ending at i - off
        # unless a segment starts inside mine
        prev = tuple(e[:-off] for e in f)
        cur = tuple(e[off:] for e in f)
        merged = sat_compose(prev, cur)
        keep = flags[off:]
        f = tuple(
            torch.cat([e[:off], torch.where(keep, c, m)])
            for e, c, m in zip(f, cur, merged)
        )
        flags = torch.cat([flags[:off], flags[off:] | flags[:-off]])
        off *= 2
    ident = (0, _NEG, _POS)
    return tuple(
        torch.where(seg_start, torch.full_like(e, i), torch.roll(e, 1, 0))
        for i, e in zip(ident, f)
    )


def group_sort(group, sort_impl: str = "xla", key_bits: int | None = None):
    """Stable permutation ordering ops by (group, slot) → (perm, inv,
    seg_start); ``perm``/``inv`` int64, ``group`` u32 lanes.

    ``sort_impl="radix"`` with a declared ``key_bits`` bound computes the
    same permutation with counting passes (``oblivious/radix.py``);
    without a declared bound the comparison sort is kept."""
    if sort_impl == "radix" and key_bits is not None:
        from .radix import radix_group_sort

        return radix_group_sort([group], key_bits)
    perm = torch.sort(widen(group), stable=True).indices
    inv = torch.argsort(perm)
    sorted_g = group[perm]
    seg_start = torch.cat(
        [torch.ones(1, dtype=torch.bool, device=group.device),
         sorted_g[1:] != sorted_g[:-1]]
    )
    return perm, inv, seg_start
