"""Segmented prefix primitives (port of
``grapevine_tpu/oblivious/segmented.py``).

The saturating-counter monoid ``f(x) = min(max(x + a, lo), hi)`` is
closed under composition, so every op's "count before me" in a mailbox
occupancy walk is an exclusive segmented scan over (a, lo, hi) triples.
The reference runs it as ``lax.associative_scan``; here it is a
Hillis-Steele doubling scan (log2 B vector steps). Composition of these
clamps is exact integer arithmetic, so any parenthesisation yields the
same counter values.

The scan vphases (``vphases_impl="scan"``) build on the sort-based
grouping below: one multi-word sort orders ops by (key, slot), and every
group question becomes a cumsum or a segmented scan over the sorted
order — no [B,B] intermediate. Keys are u32 words in int32 lanes, so
every sort key goes through ``u32.widen`` (or an order-preserving int64
pair of words); permutations are int64, the port's index dtype.

Profiler spans: every grouping sort runs inside a ``group_sort`` range and
every segmented scan, sum and bound inside a ``segmented_scan`` range (the
admission walk's saturating scan at its call site), so a
``torch.profiler`` trace attributes the round's device time to both.
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

from ..u32 import widen
from .primitives import scatter_fresh
from .radix import radix_group_sort

I32 = torch.int32

#: lo/hi sentinels for the identity element (int32-safe, never saturate)
_NEG = -(1 << 30)
_POS = 1 << 30


def sat_identity(shape=(), device=None):
    """Identity element of the saturating-counter monoid."""
    return (
        torch.zeros(shape, dtype=I32, device=device),
        torch.full(shape, _NEG, dtype=I32, device=device),
        torch.full(shape, _POS, dtype=I32, device=device),
    )


def sat_elem(add, lo, hi, device=None):
    """Element f(x) = min(max(x + add, lo), hi); args broadcastable int32."""
    return tuple(torch.as_tensor(x, dtype=I32, device=device) for x in (add, lo, hi))


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
    return grouping_sort([group], key_bits, sort_impl)


def segmented_counts_before(group, flags):
    """#True flags among earlier ops of the same group, per op: int32[B].
    The O(B²) mask form, for small B."""
    b = group.shape[0]
    iota = torch.arange(b, device=group.device)
    same = group[:, None] == group[None, :]
    earlier = iota[None, :] < iota[:, None]
    return torch.sum(same & earlier & flags[None, :], dim=1).to(I32)


# ----------------------------------------------------------------------
# sort-based grouping over multi-word keys (the O(B log B) forms the
# scan vphases build on — no [B,B] mask anywhere)
# ----------------------------------------------------------------------

_SIGN = -(1 << 31)


def _sort_keys(cols):
    """u32 key columns (most significant first) → int64 sort keys, most
    significant first, two words a key: ``(hi ^ sign) << 32 | lo`` orders
    as signed int64 exactly as the pair (hi, lo) orders as unsigned u32s."""
    keys = []
    rest = list(cols)
    while len(rest) >= 2:
        hi, lo = rest[-2], rest[-1]
        rest = rest[:-2]
        keys.append(((hi ^ _SIGN).to(torch.int64) << 32) | widen(lo))
    if rest:
        keys.append(widen(rest[0]))
    return keys[::-1]


def grouping_sort(cols, key_bits=None, sort_impl: str = "xla"):
    """``(perm, inv, seg_start)`` of :func:`multiword_group_sort`, by
    counting passes (``radix_group_sort``) under ``sort_impl="radix"``
    with a declared ``key_bits`` bound; a key with no declared bound
    keeps the comparison sort."""
    if sort_impl == "radix" and key_bits is not None:
        with record_function("group_sort"):
            return radix_group_sort(cols, key_bits)
    return multiword_group_sort(cols)


def multiword_group_sort(cols):
    """Permutation ordering ops by a multi-word key, then slot.

    ``cols``: u32[B] key words (int32 lanes), most significant first.
    Returns ``(perm, inv, seg_start)`` like :func:`group_sort` (``perm``
    and ``inv`` int64): ``x[perm]`` is segment-contiguous with ops in
    slot order within each segment, ``y[inv]`` undoes it, ``seg_start``
    marks group boundaries in sorted order. The reference sorts once
    with the slot index as the last key; here stable sorts run from the
    least significant key up (two words a pass), which yields the same
    permutation."""
    cols = list(cols)
    dev = cols[0].device
    b = cols[0].shape[0]
    with record_function("group_sort"):
        iota = torch.arange(b, dtype=torch.int64, device=dev)
        perm = iota
        for key in reversed(_sort_keys(cols)):
            perm = perm[torch.sort(key[perm], stable=True).indices]
        neq = torch.zeros(max(b - 1, 0), dtype=torch.bool, device=dev)
        for c in cols:
            sc = c[perm]
            neq = neq | (sc[1:] != sc[:-1])
        seg_start = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), neq])
        inv = torch.empty_like(perm).index_put_((perm,), iota)
        return perm, inv, seg_start


def segment_bounds(seg_start):
    """Per element: the index of its segment's first and last element.

    ``seg_start``: bool[B] in segment-contiguous (sorted) order. Both
    returned arrays are int32[B] in the same order. The reference takes
    a cummax / cummin; here each segment's id is a cumsum of the starts
    and its two ends are one scatter each into a per-segment table."""
    b = seg_start.shape[0]
    dev = seg_start.device
    with record_function("segmented_scan"):
        iota = torch.arange(b, dtype=I32, device=dev)
        seg_id = torch.cumsum(seg_start, 0) - 1  # int64
        is_last = torch.cat([seg_start[1:], torch.ones(1, dtype=torch.bool, device=dev)])
        # each segment has exactly one start and one last element: unique
        # in-bounds targets, the rest land in the spill row b
        first = scatter_fresh(b, 0, torch.where(seg_start, seg_id, b), iota)
        last = scatter_fresh(b, 0, torch.where(is_last, seg_id, b), iota)
        return first[seg_id], last[seg_id]


def segmented_scan(vals, seg_start, op):
    """Inclusive segmented scan of ``op`` (associative, elementwise)
    along axis 0: a segment start resets the running aggregate.

    ``vals``: [B, ...] in segment-contiguous order; ``seg_start``
    bool[B]. A Hillis-Steele doubling scan (log2 B steps) in place of
    the reference's ``lax.associative_scan``."""
    b = vals.shape[0]
    with record_function("segmented_scan"):
        flags = seg_start.clone()
        out = vals.clone()
        off = 1
        while off < b:
            # element i covers (i - off, i]; merge the block ending at
            # i - off unless a segment starts inside mine
            keep = flags[off:].reshape((-1,) + (1,) * (vals.dim() - 1))
            out = torch.cat([out[:off],
                             torch.where(keep, out[off:], op(out[:-off], out[off:]))])
            flags = torch.cat([flags[:off], flags[off:] | flags[:-off]])
            off *= 2
        return out


def segmented_sum_before(vals, seg_start, bounds=None):
    """Exclusive segmented sum along axis 0 (int32); ``vals`` [B, ...] in
    segment-contiguous order — an unsegmented cumsum re-based at each
    segment start. ``bounds``: an optional precomputed
    ``segment_bounds(seg_start)``."""
    start = (segment_bounds(seg_start) if bounds is None else bounds)[0]
    with record_function("segmented_scan"):
        v = vals.to(I32)
        excl = torch.cumsum(v, 0, dtype=I32) - v
        return excl - excl[start.long()]


def segmented_sum_total(vals, seg_start, bounds=None):
    """Per-element total over its whole segment (int32), axis 0;
    ``bounds`` as in :func:`segmented_sum_before`."""
    start, end = segment_bounds(seg_start) if bounds is None else bounds
    with record_function("segmented_scan"):
        v = vals.to(I32)
        c = torch.cumsum(v, 0, dtype=I32)
        start, end = start.long(), end.long()
        return c[end] - (c[start] - v[start])
