"""u32 lanes on ``torch.int32`` storage.

The reference computes in ``jnp.uint32``. PyTorch has almost no
``uint32`` arithmetic (no add, shift, compare, ``where`` or ``index_put``
on the CPU), so the port stores every u32 plane as ``torch.int32`` with
the SAME 32 bits: ``t.numpy().view(np.uint32)`` round-trips. On that
storage

- XOR/AND/OR/NOT, ``<<``, equality and wrapping add/sub/mul are the
  same bit operations as on u32 and are used directly;
- ``>>`` is arithmetic on int32, so a logical shift goes through
  :func:`shr`, and rotates through :func:`rotl`;
- ordered comparisons go through :func:`ult`/:func:`ule` (the sign bit
  flipped), because ``SENTINEL = 0xFFFFFFFF`` reads as -1;
- sort keys and indices widen to int64 with :func:`widen` (the u32
  value, never a negative number), and :func:`narrow` goes back.

Python-side constants in [0, 2^32) go through :func:`c32` before they
meet an int32 tensor.
"""

from __future__ import annotations

import numpy as np
import torch

I32 = torch.int32
_SIGN = -(1 << 31)  # 0x80000000 as int32

#: u32 "empty slot" sentinel, 0xFFFFFFFF, as its int32 bit pattern
SENTINEL = -1


def c32(v: int) -> int:
    """A u32 constant in [0, 2^32) as the int32 value with the same bits."""
    v = int(v) & 0xFFFFFFFF
    return v - (1 << 32) if v >= (1 << 31) else v


def shr(x: torch.Tensor, n: int) -> torch.Tensor:
    """Logical right shift of u32 lanes by a constant ``n`` in [0, 32)."""
    if n == 0:
        return x
    return (x >> n) & ((1 << (32 - n)) - 1)


def rotl(x: torch.Tensor, n: int) -> torch.Tensor:
    """Rotate u32 lanes left by a constant ``n`` in (0, 32)."""
    return (x << n) | shr(x, 32 - n)


def ult(a, b) -> torch.Tensor:
    """Unsigned ``a < b`` over u32 lanes (tensors or int32 constants)."""
    return (a ^ _SIGN) < (b ^ _SIGN)


def ule(a, b) -> torch.Tensor:
    """Unsigned ``a <= b`` over u32 lanes."""
    return (a ^ _SIGN) <= (b ^ _SIGN)


def widen(x: torch.Tensor) -> torch.Tensor:
    """u32 lanes → int64 holding the unsigned value (sort keys, indices)."""
    return x.to(torch.int64) & 0xFFFFFFFF


def narrow(x: torch.Tensor) -> torch.Tensor:
    """int64 → int32 lanes keeping the low 32 bits (mod 2^32)."""
    return (((x & 0xFFFFFFFF) ^ (1 << 31)) - (1 << 31)).to(I32)


def from_numpy(a, device) -> torch.Tensor:
    """A numpy u32/i32/bool array → a fresh tensor on ``device`` (copied,
    so in-place updates never write back into the caller's buffer)."""
    a = np.asarray(a)
    if a.dtype == np.bool_:
        return torch.from_numpy(a.copy()).to(device)
    if a.dtype not in (np.uint32, np.int32):
        raise TypeError(f"expected u32/i32/bool, got {a.dtype}")
    # np.array(order="C") copies and, unlike ascontiguousarray, keeps 0-d
    return torch.from_numpy(np.array(a, order="C").view(np.int32)).to(device)


def to_numpy(t) -> np.ndarray:
    """int32 lanes → numpy uint32 with the same bits (bool stays bool). A
    sharded tree plane (``oram/path_oram.py:ShardedPlane``) gives its
    logical plane: the shards' heap rows joined in heap order."""
    if not isinstance(t, torch.Tensor):
        return np.concatenate([to_numpy(r) for r in t.local()])
    a = t.detach().cpu().numpy()
    return a if a.dtype == np.bool_ else a.view(np.uint32)
