"""Oblivious building blocks (port of ``grapevine_tpu/oblivious/primitives.py``).

Branchless, constant-shape helpers on u32 lanes stored as int32
(``u32.py``); masks are bool tensors. Plus the scatter forms the port
needs in place of JAX's ``.at[].set(mode="drop")``: PyTorch raises on an
out-of-bounds index where JAX drops the write. Both forms send dropped
rows to a spill row past the end, so every scatter keeps a fixed shape.
"""

from __future__ import annotations

import torch

from ..u32 import ule, ult, widen


def words_equal(a, b):
    """Rowwise equality of multi-word values: a[..., W] == b[..., W] → bool[...]."""
    return torch.all(a == b, dim=-1)


def is_zero_words(a):
    """True where a multi-word value is all-zero (invalid key / empty id)."""
    return torch.all(a == 0, dim=-1)


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
