"""ChaCha20 keystream and the lockstep challenge RNG.

The reference seeds a ChaCha20 stream with 32 enclave-chosen bytes at
connection time and both sides draw 32 bytes per request to stay in sync
(reference grapevine.proto:20-25, README.md:189-196). This module
implements RFC 7539 ChaCha20 and the :class:`ChallengeRng` wrapper.

Stream parameters: key = the 32-byte seed, nonce = 12 zero bytes, block
counter starting at 0. This pins the cross-implementation contract; the
RFC 7539 test vector is asserted in tests.

Two backends, same stream: an OpenSSL-backed streaming cipher (the
per-request server hot path — the pure-Python block function measured
91 µs per 32-byte draw, ~30% of the host's per-op budget, PERF.md) and
the pure-Python block function below as the spec oracle
(tests/test_session.py pins both to the RFC vector and to each other).
"""

from __future__ import annotations

import struct

try:  # OpenSSL ChaCha20: 16-byte nonce = LE32 initial counter ‖ RFC nonce
    from cryptography.hazmat.primitives.ciphers import Cipher as _Cipher
    from cryptography.hazmat.primitives.ciphers.algorithms import (
        ChaCha20 as _OpenSSLChaCha20,
    )
except ImportError:  # wheel-less container: numpy keystream fallback
    _Cipher = None


def _rotl(x: int, n: int) -> int:
    return ((x << n) | (x >> (32 - n))) & 0xFFFFFFFF


def _quarter(s, a, b, c, d):
    s[a] = (s[a] + s[b]) & 0xFFFFFFFF
    s[d] = _rotl(s[d] ^ s[a], 16)
    s[c] = (s[c] + s[d]) & 0xFFFFFFFF
    s[b] = _rotl(s[b] ^ s[c], 12)
    s[a] = (s[a] + s[b]) & 0xFFFFFFFF
    s[d] = _rotl(s[d] ^ s[a], 8)
    s[c] = (s[c] + s[d]) & 0xFFFFFFFF
    s[b] = _rotl(s[b] ^ s[c], 7)


class ChaCha20:
    """RFC 7539 ChaCha20 keystream generator.

    Streams from OpenSSL when available (stateful encryptor over a zero
    plaintext — the encryptor carries the block counter and partial-
    block position, so arbitrary draw sizes stay aligned with the pure
    path); falls back to the pure-Python block function."""

    def __init__(self, key: bytes, nonce: bytes = b"\x00" * 12, counter: int = 0):
        if len(key) != 32:
            raise ValueError("key must be 32 bytes")
        if len(nonce) != 12:
            raise ValueError("nonce must be 12 bytes")
        self._const = struct.unpack("<4I", b"expand 32-byte k")
        self._key = struct.unpack("<8I", key)
        self._nonce = struct.unpack("<3I", nonce)
        self._key_bytes = key
        self._nonce_bytes = nonce
        self._counter = counter
        self._buf = b""
        self._openssl = None
        if _Cipher is not None:
            full_nonce = struct.pack("<I", counter & 0xFFFFFFFF) + nonce
            self._openssl = _Cipher(
                _OpenSSLChaCha20(key, full_nonce), mode=None
            ).encryptor()

    def _block(self, counter: int) -> bytes:
        init = list(self._const + self._key + (counter & 0xFFFFFFFF,) + self._nonce)
        s = list(init)
        for _ in range(10):
            _quarter(s, 0, 4, 8, 12)
            _quarter(s, 1, 5, 9, 13)
            _quarter(s, 2, 6, 10, 14)
            _quarter(s, 3, 7, 11, 15)
            _quarter(s, 0, 5, 10, 15)
            _quarter(s, 1, 6, 11, 12)
            _quarter(s, 2, 7, 8, 13)
            _quarter(s, 3, 4, 9, 14)
        out = [(a + b) & 0xFFFFFFFF for a, b in zip(s, init)]
        return struct.pack("<16I", *out)

    def keystream(self, n: int) -> bytes:
        if self._openssl is not None:
            return self._openssl.update(bytes(n))
        if len(self._buf) < n:
            # wheel-less fallback: draw whole blocks from the numpy
            # block-axis keystream (stdcrypto.py) instead of the 91 µs
            # pure-Python block — _block stays as the spec oracle the
            # tests pin both streams against
            from . import stdcrypto

            n_blocks = (n - len(self._buf) + 63) // 64
            self._buf += stdcrypto.chacha20_keystream(
                self._key_bytes, self._nonce_bytes, n_blocks * 64, self._counter
            )
            self._counter += n_blocks
        out, self._buf = self._buf[:n], self._buf[n:]
        return out


class ChallengeRng:
    """Draws 32-byte challenges; client and server each hold one, seeded
    identically, and advance it on *every* request (reference
    README.md:195-196) — a desync is an implicit session kill."""

    CHALLENGE_SIZE = 32

    def __init__(self, seed: bytes):
        if len(seed) != 32:
            raise ValueError("challenge seed must be 32 bytes")
        self._stream = ChaCha20(seed)
        self.draws = 0

    def next_challenge(self) -> bytes:
        self.draws += 1
        return self._stream.keystream(self.CHALLENGE_SIZE)
