"""Oblivious building blocks (port of ``grapevine_tpu/oblivious/primitives.py``).

Branchless, constant-shape helpers on u32 lanes stored as int32
(``u32.py``); masks are bool tensors. Plus the scatter forms the port
needs in place of JAX's ``.at[].set(mode="drop")``: PyTorch raises on an
out-of-bounds index where JAX drops the write. Both forms send dropped
rows to a spill row past the end, so every scatter keeps a fixed shape.
"""

from __future__ import annotations

import torch

from ..u32 import narrow, ule, ult, widen


def cmov(cond, a, b):
    """Constant-shape conditional move: cond ? a : b (broadcasting where)."""
    return torch.where(cond, a, b)


def words_equal(a, b):
    """Rowwise equality of multi-word values: a[..., W] == b[..., W] → bool[...]."""
    return torch.all(a == b, dim=-1)


def is_zero_words(a):
    """True where a multi-word value is all-zero (invalid key / empty id)."""
    return torch.all(a == 0, dim=-1)


def onehot_select(mask, values):
    """Select the single row of ``values`` where ``mask`` is True.

    mask: bool[N]; values: int32[N, ...] → int32[...]. With no (or
    several) set lanes the result is the masked sum mod 2^32, as the
    reference's u32 sum: callers guarantee at most one match and handle
    the none-set case through a separate ``found`` flag. The sum runs in
    int64 (``torch.sum`` of int32 widens) and is narrowed back with
    wraparound."""
    m = mask.reshape(mask.shape + (1,) * (values.dim() - mask.dim()))
    return narrow(torch.where(m, values, 0).sum(dim=0))


def first_true_onehot(mask):
    """One-hot of the first True lane (all-False → all-False). bool[N]→bool[N].

    ``argmax`` over the int32 mask returns the first maximal lane, so a
    tie breaks toward the lowest index, as the reference's does."""
    idx = torch.argmax(mask.to(torch.int32))  # 0 if none set; guarded below
    onehot = torch.arange(mask.shape[0], device=mask.device) == idx
    return onehot & torch.any(mask)


def argmin_u64_onehot(valid, hi, lo):
    """One-hot of the valid lane with the smallest (hi, lo) u64 pair.

    valid: bool[N]; hi, lo: u32 lanes int32[N]. Invalid lanes rank as
    +inf (0xFFFFFFFF, compared unsigned: the words widen to int64);
    ties break toward the lowest lane index. Returns (onehot bool[N],
    any_valid bool)."""
    inf = 0xFFFFFFFF
    hi_m = torch.where(valid, widen(hi), inf)
    cand = valid & (hi_m == hi_m.min())
    lo_m = torch.where(cand, widen(lo), inf)
    return first_true_onehot(cand & (lo_m == lo_m.min())), torch.any(valid)


def rank_of(mask):
    """Exclusive prefix count of True lanes: int32[N]."""
    m = mask.to(torch.int32)
    return (torch.cumsum(m, 0) - m).to(torch.int32)


def u64_add_u32(lo, hi, k):
    """(lo, hi) + k with carry over u32 lanes."""
    s = lo + k
    return s, hi + ult(s, lo).to(torch.int32)


def u64_le(a_lo, a_hi, b_lo, b_hi):
    """a <= b over (lo, hi) u32 lane pairs."""
    return ult(a_hi, b_hi) | ((a_hi == b_hi) & ule(a_lo, b_lo))


def u64_sub(a_lo, a_hi, b_lo, b_hi):
    """a - b (mod 2^64) over u32 lane pairs."""
    return a_lo - b_lo, a_hi - b_hi - ult(a_lo, b_lo).to(torch.int32)


def lex_argsort(lo, hi, dim=-1):
    """Stable ascending argsort by the u64 key (hi, lo) over u32 lanes."""
    p1 = torch.sort(widen(lo), dim=dim, stable=True).indices
    hi_p = torch.gather(hi, dim, p1)
    p2 = torch.sort(widen(hi_p), dim=dim, stable=True).indices
    return torch.gather(p1, dim, p2)


def scatter_fresh(n: int, fill, idx, src):
    """``full((n, ...), fill).at[idx].set(src, mode="drop")``.

    ``idx`` int64[R]; rows whose index is outside [0, n) are dropped.
    In-bounds targets must be unique (as every reference call site
    guarantees). The dropped rows land in one spill row past the end,
    so no data-dependent shape (and no device sync) is needed."""
    buf = torch.full((n + 1,) + tuple(src.shape[1:]), fill, dtype=src.dtype,
                     device=src.device)
    buf[torch.where((idx >= 0) & (idx < n), idx, n)] = src
    return buf[:n]


def scatter_drop(dst, idx, src):
    """``dst.at[idx].set(src, mode="drop")`` as a new tensor: a copy of
    ``dst`` with one spill row, so dropped rows need no data-dependent
    shape (and no device sync). For the small private planes; the big
    trees are written in place (``oram/path_oram.py:_path_scatter_``)."""
    n = dst.shape[0]
    buf = torch.cat([dst, dst.new_empty((1,) + tuple(dst.shape[1:]))])
    buf[torch.where((idx >= 0) & (idx < n), idx, n)] = src
    return buf[:n]


def index1(t):
    """A 0-d index tensor as a 1-element int64 index: indexing with a 0-d
    tensor may read it back to the host, a 1-element index never does."""
    return t.reshape(1).long()


def flag(value: bool, like) -> torch.Tensor:
    """A constant bool scalar on ``like``'s device (a fill, no copy)."""
    return torch.full((), value, dtype=torch.bool, device=like.device)
