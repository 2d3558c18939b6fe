"""Stdlib + numpy channel crypto: the wheel-less backend for channel.py.

The IX channel (session/channel.py) originally required the
``cryptography`` wheel for three primitives — X25519, ChaCha20-Poly1305,
and HKDF-SHA256. Minimal containers (including this one) don't ship the
wheel, which used to skip every session/server test module and report
``server_loopback`` as skipped. This module supplies the same three
primitives from the standard library + numpy, bit-compatible with the
wheel-backed implementations by construction (each is a direct RFC
transcription, pinned to the RFC test vectors in
tests/test_stdcrypto.py, and pinned against the wheel's output in the
same tests whenever the wheel *is* present):

- :func:`x25519` — RFC 7748 §5 Montgomery ladder over Python ints.
  A full exchange is ~1 ms; handshakes happen once per connection, so
  this never touches the per-request path.
- :class:`ChaCha20Poly1305` — RFC 8439 AEAD composed from the
  numpy-vectorized ChaCha20 keystream below (the same block-axis
  vectorization engine/checkpoint.py uses for sealing — the session
  layer's per-32-byte pure-Python draw is a spec oracle, not a bulk
  cipher) and a big-int Poly1305. API-compatible with
  ``cryptography.hazmat.primitives.ciphers.aead.ChaCha20Poly1305``.
- :func:`hkdf_sha256` — RFC 5869 extract-then-expand over stdlib hmac.

Deliberately torch-free: hostpipe worker processes (server/hostpipe.py)
import this for frame codec work and must not drag a device runtime
into every worker.
"""

from __future__ import annotations

import hashlib
import hmac
import os
import struct

import numpy as np

__all__ = [
    "ChaCha20Poly1305",
    "InvalidTag",
    "X25519PrivateKey",
    "X25519PublicKey",
    "chacha20_xor",
    "hkdf_sha256",
    "poly1305",
    "x25519",
]


class InvalidTag(Exception):
    """AEAD authentication failure (mirrors cryptography.exceptions)."""


# -- ChaCha20 (RFC 8439 §2.3), vectorized over the block axis ------------


def _chacha_block_words(key_words, counter0: int, nonce_words, n_blocks: int):
    """u32[n_blocks, 16] keystream blocks for consecutive counters.

    Same construction as engine/checkpoint.py's sealing keystream
    (pinned to each other and to session/chacha.py's pure block function
    in tests); duplicated rather than imported so the session layer and
    hostpipe workers stay torch-free."""
    const = np.frombuffer(b"expand 32-byte k", dtype="<u4")
    ctrs = (np.arange(n_blocks, dtype=np.uint64) + np.uint64(counter0)).astype(
        np.uint32
    )
    init = np.empty((n_blocks, 16), np.uint32)
    init[:, 0:4] = const
    init[:, 4:12] = key_words
    init[:, 12] = ctrs
    init[:, 13:16] = nonce_words
    x = init.copy()

    def rot(v, n):
        return (v << np.uint32(n)) | (v >> np.uint32(32 - n))

    def qr(a, b, c, d):
        x[:, a] += x[:, b]
        x[:, d] = rot(x[:, d] ^ x[:, a], 16)
        x[:, c] += x[:, d]
        x[:, b] = rot(x[:, b] ^ x[:, c], 12)
        x[:, a] += x[:, b]
        x[:, d] = rot(x[:, d] ^ x[:, a], 8)
        x[:, c] += x[:, d]
        x[:, b] = rot(x[:, b] ^ x[:, c], 7)

    with np.errstate(over="ignore"):
        for _ in range(10):
            qr(0, 4, 8, 12)
            qr(1, 5, 9, 13)
            qr(2, 6, 10, 14)
            qr(3, 7, 11, 15)
            qr(0, 5, 10, 15)
            qr(1, 6, 11, 12)
            qr(2, 7, 8, 13)
            qr(3, 4, 9, 14)
        x += init
    return x


def chacha20_keystream(key: bytes, nonce: bytes, n: int, counter: int = 0) -> bytes:
    """``n`` keystream bytes starting at block ``counter``."""
    if len(key) != 32 or len(nonce) != 12:
        raise ValueError("key must be 32 bytes, nonce 12")
    n_blocks = (n + 63) // 64
    if n_blocks == 0:
        return b""
    ks = _chacha_block_words(
        np.frombuffer(key, "<u4"), counter, np.frombuffer(nonce, "<u4"), n_blocks
    )
    return ks.astype("<u4").tobytes()[:n]


def chacha20_xor(key: bytes, nonce: bytes, data: bytes, counter: int = 0) -> bytes:
    """ChaCha20-XOR ``data`` (encrypt ≡ decrypt)."""
    if not data:
        return b""
    ks = chacha20_keystream(key, nonce, len(data), counter)
    return (
        np.frombuffer(data, np.uint8) ^ np.frombuffer(ks, np.uint8)
    ).tobytes()


# -- Poly1305 (RFC 8439 §2.5) -------------------------------------------

_P1305 = (1 << 130) - 5
_CLAMP = 0x0FFFFFFC0FFFFFFC0FFFFFFC0FFFFFFF


def poly1305(key: bytes, msg: bytes) -> bytes:
    """One-shot Poly1305 MAC; ``key`` = r(16) ‖ s(16)."""
    if len(key) != 32:
        raise ValueError("poly1305 key must be 32 bytes")
    r = int.from_bytes(key[:16], "little") & _CLAMP
    s = int.from_bytes(key[16:], "little")
    acc = 0
    for i in range(0, len(msg), 16):
        blk = msg[i : i + 16]
        acc = (acc + int.from_bytes(blk, "little") + (1 << (8 * len(blk)))) * r
        acc %= _P1305
    return ((acc + s) & ((1 << 128) - 1)).to_bytes(16, "little")


def _pad16(n: int) -> bytes:
    return b"\x00" * (-n % 16)


class ChaCha20Poly1305:
    """RFC 8439 AEAD, API-compatible with the ``cryptography`` class:
    ``encrypt(nonce, data, aad) -> ct ‖ tag(16)`` and ``decrypt``
    raising :class:`InvalidTag` on any authentication failure."""

    def __init__(self, key: bytes):
        if len(key) != 32:
            raise ValueError("ChaCha20Poly1305 key must be 32 bytes")
        self._key = key

    def _tag(self, nonce: bytes, ct: bytes, aad: bytes) -> bytes:
        poly_key = chacha20_keystream(self._key, nonce, 32, counter=0)
        mac_data = (
            aad
            + _pad16(len(aad))
            + ct
            + _pad16(len(ct))
            + struct.pack("<QQ", len(aad), len(ct))
        )
        return poly1305(poly_key, mac_data)

    def encrypt(self, nonce: bytes, data: bytes, aad: bytes | None) -> bytes:
        if len(nonce) != 12:
            raise ValueError("nonce must be 12 bytes")
        aad = aad or b""
        ct = chacha20_xor(self._key, nonce, data, counter=1)
        return ct + self._tag(nonce, ct, aad)

    def decrypt(self, nonce: bytes, data: bytes, aad: bytes | None) -> bytes:
        if len(nonce) != 12:
            raise ValueError("nonce must be 12 bytes")
        if len(data) < 16:
            raise InvalidTag("ciphertext shorter than the tag")
        aad = aad or b""
        ct, tag = data[:-16], data[-16:]
        if not hmac.compare_digest(tag, self._tag(nonce, ct, aad)):
            raise InvalidTag("AEAD tag mismatch")
        return chacha20_xor(self._key, nonce, ct, counter=1)


# -- X25519 (RFC 7748 §5) -----------------------------------------------

_P25519 = 2**255 - 19
_A24 = 121665
_BASE_U = (9).to_bytes(32, "little")


def _decode_scalar(k: bytes) -> int:
    b = bytearray(k)
    b[0] &= 248
    b[31] &= 127
    b[31] |= 64
    return int.from_bytes(bytes(b), "little")


def x25519(scalar: bytes, u: bytes) -> bytes:
    """The X25519 function: constant formula sequence per ladder step
    (the Python big-int timing is not secret-independent — acceptable
    for this reproduction's once-per-connection handshakes, stated in
    SECURITY.md terms; the wheel-backed path is constant-time)."""
    if len(scalar) != 32 or len(u) != 32:
        raise ValueError("x25519 scalar and u-coordinate must be 32 bytes")
    k = _decode_scalar(scalar)
    # mask the high bit of the u-coordinate per RFC 7748 §5
    x1 = int.from_bytes(u[:31] + bytes([u[31] & 0x7F]), "little")
    x2, z2, x3, z3 = 1, 0, x1, 1
    swap = 0
    for t in reversed(range(255)):
        k_t = (k >> t) & 1
        if swap ^ k_t:
            x2, x3 = x3, x2
            z2, z3 = z3, z2
        swap = k_t
        a = (x2 + z2) % _P25519
        aa = a * a % _P25519
        b = (x2 - z2) % _P25519
        bb = b * b % _P25519
        e = (aa - bb) % _P25519
        c = (x3 + z3) % _P25519
        d = (x3 - z3) % _P25519
        da = d * a % _P25519
        cb = c * b % _P25519
        x3 = (da + cb) % _P25519
        x3 = x3 * x3 % _P25519
        z3 = x1 * (da - cb) * (da - cb) % _P25519
        x2 = aa * bb % _P25519
        z2 = e * (aa + _A24 * e) % _P25519
    if swap:
        x2, x3 = x3, x2
        z2, z3 = z3, z2
    return (x2 * pow(z2, _P25519 - 2, _P25519) % _P25519).to_bytes(32, "little")


class X25519PublicKey:
    """Raw 32-byte u-coordinate, wheel-compatible constructor surface."""

    def __init__(self, raw: bytes):
        if len(raw) != 32:
            raise ValueError("X25519 public key must be 32 bytes")
        self._raw = bytes(raw)

    @classmethod
    def from_public_bytes(cls, data: bytes) -> "X25519PublicKey":
        return cls(data)

    def public_bytes_raw(self) -> bytes:
        return self._raw


class X25519PrivateKey:
    """Raw 32-byte scalar, wheel-compatible constructor surface."""

    def __init__(self, raw: bytes):
        if len(raw) != 32:
            raise ValueError("X25519 private key must be 32 bytes")
        self._raw = bytes(raw)

    @classmethod
    def generate(cls) -> "X25519PrivateKey":
        return cls(os.urandom(32))

    @classmethod
    def from_private_bytes(cls, data: bytes) -> "X25519PrivateKey":
        return cls(data)

    def private_bytes_raw(self) -> bytes:
        return self._raw

    def public_key(self) -> X25519PublicKey:
        return X25519PublicKey(x25519(self._raw, _BASE_U))

    def exchange(self, peer_public_key: X25519PublicKey) -> bytes:
        out = x25519(self._raw, peer_public_key.public_bytes_raw())
        if out == b"\x00" * 32:
            # contributory-behavior check, same stance as the wheel:
            # a low-order peer point must not yield a usable secret
            raise ValueError("computed X25519 shared secret is all zeros")
        return out


# -- HKDF-SHA256 (RFC 5869) ---------------------------------------------


def hkdf_sha256(ikm: bytes, salt: bytes, info: bytes, length: int) -> bytes:
    """Extract-then-expand; ``length`` ≤ 255·32 (channel.py asks ≤ 64)."""
    if length > 255 * 32:
        raise ValueError("hkdf_sha256 length too large")
    prk = hmac.new(salt or b"\x00" * 32, ikm, hashlib.sha256).digest()
    okm = b""
    block = b""
    counter = 1
    while len(okm) < length:
        block = hmac.new(prk, block + info + bytes([counter]), hashlib.sha256).digest()
        okm += block
        counter += 1
    return okm[:length]
