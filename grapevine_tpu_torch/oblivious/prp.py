"""Keyed small-domain PRP for msg-id words (port of
``grapevine_tpu/oblivious/prp.py``): the one-word Feistel bijection on
[0, 2**bits) and the two-word Feistel over (32-bit nonce, ``bits``-bit
block index) the engine's ids use. u32 lanes in int32 (``u32.py``)."""

from __future__ import annotations

from ..u32 import c32, rotl, shr

ROUNDS = 4


def _f(x, k):
    """Murmur-style one-way mixer: (half, round key) → u32."""
    x = (x ^ k) * c32(0xCC9E2D51)
    x = rotl(x, 15) * c32(0x1B873593)
    x = x ^ shr(x, 13)
    x = x * c32(0x85EBCA6B)
    return x ^ shr(x, 16)


def _halves(bits: int) -> list[tuple[int, int]]:
    """(left, right) bit widths per round; halves swap every round."""
    a, b = bits - (bits // 2), bits // 2
    out = []
    for _ in range(ROUNDS):
        out.append((a, b))
        a, b = b, a
    return out


def prp_encrypt(key, x, bits: int):
    """Bijection on [0, 2**bits), ``bits`` ≤ 32; key int32[ROUNDS]. Bits
    above ``bits`` are ignored on input and zero on output."""
    if bits <= 1:
        return x & ((1 << bits) - 1)
    sizes = _halves(bits)
    a0, b0 = sizes[0]
    left = shr(x, b0) & ((1 << a0) - 1)
    right = x & ((1 << b0) - 1)
    for i, (a, _b) in enumerate(sizes):
        left, right = right, left ^ (_f(right, key[i]) & ((1 << a) - 1))
    # after ROUNDS (even) swaps the widths are back to (a0, b0)
    return (left << b0) | right


def prp_decrypt(key, y, bits: int):
    """Inverse of :func:`prp_encrypt`."""
    if bits <= 1:
        return y & ((1 << bits) - 1)
    sizes = _halves(bits)
    a0, b0 = sizes[0]
    left = shr(y, b0) & ((1 << a0) - 1)
    right = y & ((1 << b0) - 1)
    for i in range(ROUNDS - 1, -1, -1):
        a, _b = sizes[i]
        left, right = right ^ (_f(left, key[i]) & ((1 << a) - 1)), left
    return (left << b0) | right


def _halves2(bits: int) -> list[tuple[int, int]]:
    a, b = 32, bits
    out = []
    for _ in range(ROUNDS):
        out.append((a, b))
        a, b = b, a
    return out


def _mask(nbits: int) -> int:
    return -1 if nbits >= 32 else (1 << nbits) - 1


def prp2_encrypt(key, x, nonce, bits: int):
    """(nonce, block index) → (word0 u32, word1 < 2**bits); key int32[4]."""
    left = nonce
    right = x & _mask(bits)
    for i, (a, _b) in enumerate(_halves2(bits)):
        left, right = right, left ^ (_f(right, key[i]) & _mask(a))
    return left, right


def prp2_decrypt(key, w0, w1, bits: int):
    """Inverse of prp2_encrypt; returns the block index (nonce discarded)."""
    sizes = _halves2(bits)
    left, right = w0, w1 & _mask(bits)
    for i in range(ROUNDS - 1, -1, -1):
        a, _b = sizes[i]
        left, right = right ^ (_f(left, key[i]) & _mask(a)), left
    return right
