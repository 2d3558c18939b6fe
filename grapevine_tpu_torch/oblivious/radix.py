"""Data-oblivious LSD radix rank over bounded keys (port of
``grapevine_tpu/oblivious/radix.py``).

Every hot sort the engine runs orders a *bounded* key: eviction sorts the
working set by leaf (``height + 1`` bits), the admission walk groups ops
by first-occurrence slot (``log2(B)`` bits). A least-significant-digit
radix *rank* does the job in a fixed number of counting passes instead of
a comparison sort: per pass one one-hot scatter, one cumsum down the
batch axis, two gathers and one unique scatter of the permutation. Pass
count, shapes and the instruction trace depend only on the static
``(key_bits, bits_per_pass, B)``, never on key values, and no pass reads
a value back to the host (the depth-2 dispatch stays free of syncs).

Contract: :func:`radix_rank` equals ``torch.sort(keys, stable=True)``'s
permutation (over the unsigned key) bit for bit, and
:func:`radix_group_sort` equals ``segmented.group_sort`` /
the reference's ``multiword_group_sort``, for keys within their declared
bound. Keys must be *declared* bounded; wide keys stay on the comparison
sort (no hash-down fallback). u32 keys live in int32 lanes (``u32.py``);
permutations are int64, the port's index dtype.
"""

from __future__ import annotations

import torch

from ..u32 import shr, widen

I32 = torch.int32
I64 = torch.int64

#: ceiling on the total declared key width of one ``radix_group_sort``
#: call: wider keys stay on the comparison sort (hashing them down would
#: make correctness depend on a hash)
MAX_RADIX_BITS = 64


def _check_static(key_bits: int, bits_per_pass: int) -> None:
    if not isinstance(key_bits, int) or not 1 <= key_bits <= 32:
        raise ValueError(
            f"key_bits must be an int in [1, 32], got {key_bits!r}"
        )
    if not isinstance(bits_per_pass, int) or not 1 <= bits_per_pass <= 16:
        raise ValueError(
            f"bits_per_pass must be an int in [1, 16], got {bits_per_pass!r}"
        )


def _check_declared_bound(keys, key_bits: int) -> None:
    """Keys on the CPU are checked against the declared bound: an
    out-of-range key would silently mis-rank (its high bits never enter
    a pass), so it raises instead. On the card the check would read a
    value back (a host sync inside the round), so there the caller's
    declared bound is the contract, as inside the reference's jit."""
    if key_bits >= 32 or keys.device.type != "cpu" or not keys.numel():
        return
    top = int(widen(keys).max())
    if top >> key_bits:
        raise ValueError(
            f"key {top} exceeds the declared {key_bits}-bit bound"
        )


def _rank_pass(digit, nbins: int):
    """Stable counting-sort positions for one digit column.

    ``digit`` int32[B] in [0, nbins) → int64[B], a permutation of [0, B):
    position j goes to ``offset[digit[j]] + #(i < j with digit[i] ==
    digit[j])``."""
    b = digit.shape[0]
    if nbins == 2:
        # the 1-bit pass needs no bin table: two exclusive ranks
        return partition_rank(digit).to(I64)
    # one-hot bin-major, [nbins, B], by a scatter (no host read;
    # F.one_hot checks its range on the host), then an inclusive cumsum
    # along each bin's contiguous row: the last column is the per-bin
    # total, the (digit[j], j) entry the within-bin rank
    d64 = digit.to(I64)
    oh = torch.zeros((nbins, b), dtype=I32, device=digit.device)
    oh.scatter_(0, d64[None, :], 1)
    csum = torch.cumsum(oh, 1, dtype=I32)
    iota = torch.arange(b, dtype=I64, device=digit.device)
    within = csum.view(-1)[d64 * b + iota] - 1
    counts = csum[:, -1]
    offs = torch.cumsum(counts, 0, dtype=I32) - counts  # exclusive
    return (offs[d64] + within).to(I64)


def partition_rank(flags) -> torch.Tensor:
    """Positions of a stable two-way partition (False first): int32[B].

    ``pos[i]`` is where element i lands when all False-flagged elements
    precede all True ones, each side in its original order. The expiry
    sweep's freelist rebuild is exactly this pass."""
    digit = flags.to(I32)
    b = digit.shape[0]
    iota = torch.arange(b, dtype=I32, device=digit.device)
    incl = torch.cumsum(digit, 0, dtype=I32)
    ones_before = incl - digit
    zeros_before = iota - ones_before
    n_zeros = b - incl[-1] if b else 0
    return torch.where(digit == 1, n_zeros + ones_before, zeros_before).to(I32)


def _passes(perm, col, key_bits: int, bits_per_pass: int):
    """Apply one column's LSD passes to ``perm`` (stable, so the order
    established by earlier passes and columns breaks ties)."""
    for shift in range(0, key_bits, bits_per_pass):
        pbits = min(bits_per_pass, key_bits - shift)
        digit = shr(col[perm], shift) & ((1 << pbits) - 1)
        pos = _rank_pass(digit, 1 << pbits)
        perm = torch.empty_like(perm).index_put_((pos,), perm)
    return perm


def radix_rank(keys, key_bits: int, bits_per_pass: int = 8) -> torch.Tensor:
    """Stable ascending permutation of bounded u32 keys: int64[B].

    ``keys[perm]`` is sorted ascending with ties in original order, the
    same permutation as a stable sort for ``keys < 2**key_bits``,
    computed in ``ceil(key_bits / bits_per_pass)`` counting passes."""
    _check_static(key_bits, bits_per_pass)
    _check_declared_bound(keys, key_bits)
    perm = torch.arange(keys.shape[0], dtype=I64, device=keys.device)
    return _passes(perm, keys, key_bits, bits_per_pass)


def radix_group_sort(cols, key_bits, bits_per_pass: int = 8):
    """Drop-in for ``segmented.group_sort`` over declared-bounded keys:
    ``(perm, inv, seg_start)`` with ``perm``/``inv`` int64.

    ``cols``: u32 key columns, most significant first. ``key_bits``: the
    declared bound, an int for a single column, else one per column; the
    total must not exceed ``MAX_RADIX_BITS``. Stability of the LSD passes
    makes the slot index an implicit final key."""
    cols = list(cols)
    if not cols:
        raise ValueError("radix_group_sort needs at least one key column")
    bits = [key_bits] if isinstance(key_bits, int) else list(key_bits)
    if len(bits) != len(cols):
        raise ValueError(
            f"key_bits must declare a bound per column: "
            f"{len(bits)} bounds for {len(cols)} columns"
        )
    for kb in bits:
        _check_static(kb, bits_per_pass)
    if sum(bits) > MAX_RADIX_BITS:
        raise ValueError(
            f"declared key width {sum(bits)} exceeds MAX_RADIX_BITS="
            f"{MAX_RADIX_BITS}; keep the comparison sort for wide keys "
            f"(hashing them down would make correctness depend on a hash)"
        )
    dev = cols[0].device
    b = cols[0].shape[0]
    perm = torch.arange(b, dtype=I64, device=dev)
    # least-significant column first
    for c, kb in zip(reversed(cols), reversed(bits)):
        _check_declared_bound(c, kb)
        perm = _passes(perm, c, kb, bits_per_pass)
    neq = torch.zeros((max(b - 1, 0),), dtype=torch.bool, device=dev)
    for c in cols:
        sc = c[perm]
        neq = neq | (sc[1:] != sc[:-1])
    seg_start = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), neq])
    inv = torch.empty_like(perm).index_put_((perm,), torch.arange(b, dtype=I64, device=dev))
    return perm, inv, seg_start
