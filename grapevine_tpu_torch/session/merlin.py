"""Merlin transcripts (STROBE-128 over Keccak-f[1600]), pure Python.

Schnorrkel (sr25519) signatures — the reference's per-request auth
scheme (reference README.md:193-199, types/src/lib.rs:13, Cargo.toml:62
pinning ``schnorrkel-og 0.11.0-pre.0``) — derive their Fiat–Shamir
challenge from a *merlin* transcript, not a plain hash. Byte-for-byte
signature compatibility with reference clients therefore requires this
exact construction:

- Keccak-f[1600] (FIPS 202 permutation, 24 rounds);
- STROBE-128 (rate 166, the trimmed subset merlin embeds: AD / meta-AD /
  PRF / KEY operations only);
- the merlin framing: protocol label ``b"Merlin v1.0"``, ``dom-sep``
  domain separator, ``append_message`` = meta-AD(label ‖ LE32(len)) +
  AD(data), ``challenge_bytes`` = meta-AD(label ‖ LE32(len)) + PRF.

Pinned by test against merlin's published transcript test vector
(tests/test_merlin.py). Host-side only; never on the device path.
"""

from __future__ import annotations

import struct

__all__ = ["Strobe128", "Transcript", "keccak_f1600"]

_MASK = (1 << 64) - 1

# FIPS 202 round constants for Keccak-f[1600]
_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

# rotation offsets r[x][y], indexed by lane x + 5y
_ROT = [
    0, 1, 62, 28, 27,
    36, 44, 6, 55, 20,
    3, 10, 43, 25, 39,
    41, 45, 15, 21, 8,
    18, 2, 61, 56, 14,
]


def _rol(v: int, n: int) -> int:
    n &= 63
    return ((v << n) | (v >> (64 - n))) & _MASK


def keccak_f1600(state: bytearray) -> None:
    """In-place Keccak-f[1600] on a 200-byte little-endian lane state.

    Dispatches to the native C permutation when the session library is
    loaded (~100× the pure-Python throughput; signature verification
    runs several permutations per request). The Python path below is
    the fallback and the oracle (tests/test_merlin.py cross-checks)."""
    from .. import native as _native

    if _native.lib is not None:
        _native.keccak_f1600(state)
        return
    _keccak_f1600_py(state)


def _keccak_f1600_py(state: bytearray) -> None:
    """Pure-Python permutation (fallback + correctness oracle)."""
    lanes = list(struct.unpack("<25Q", state))
    for rc in _RC:
        # θ
        c = [lanes[x] ^ lanes[x + 5] ^ lanes[x + 10] ^ lanes[x + 15]
             ^ lanes[x + 20] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rol(c[(x + 1) % 5], 1) for x in range(5)]
        for x in range(5):
            for y in range(0, 25, 5):
                lanes[x + y] ^= d[x]
        # ρ and π
        b = [0] * 25
        for x in range(5):
            for y in range(5):
                b[y + 5 * ((2 * x + 3 * y) % 5)] = _rol(
                    lanes[x + 5 * y], _ROT[x + 5 * y]
                )
        # χ
        for x in range(5):
            for y in range(0, 25, 5):
                lanes[x + y] = b[x + y] ^ (
                    (~b[(x + 1) % 5 + y]) & b[(x + 2) % 5 + y] & _MASK
                )
        # ι
        lanes[0] ^= rc
    state[:] = struct.pack("<25Q", *lanes)


_STROBE_R = 166  # STROBE-128 rate: 200 - (2·128)/8 - 2
_FLAG_I = 1
_FLAG_A = 1 << 1
_FLAG_C = 1 << 2
_FLAG_T = 1 << 3
_FLAG_M = 1 << 4
_FLAG_K = 1 << 5


def _native_strobe():
    """The native module iff the STROBE ops are loaded, else None."""
    from .. import native as _native

    return _native if _native.lib is not None else None


class Strobe128:
    """The trimmed STROBE-128 duplex merlin embeds (merlin strobe.rs).

    The whole duplex lives in one 203-byte blob —
    ``state[200] ‖ pos ‖ pos_begin ‖ cur_flags`` — shared byte-for-byte
    with the C ops in native/r255.c, so a transcript can move freely
    between the native fast path (one library crossing per op) and the
    pure-Python oracle below. The per-request signature path runs ~8
    transcript ops per challenge; the Python framing alone cost ~85 µs
    before the C ops (measured, PERF.md host table)."""

    __slots__ = ("blob",)

    def __init__(self, protocol_label: bytes):
        blob = bytearray(203)
        blob[0:6] = bytes([1, _STROBE_R + 2, 1, 0, 1, 96])
        blob[6:18] = b"STROBEv1.0.2"
        self.blob = blob
        self._f1600()
        self.meta_ad(protocol_label, False)

    # -- pos / pos_begin / cur_flags live in the blob tail ---------------

    @property
    def pos(self) -> int:
        return self.blob[200]

    @property
    def pos_begin(self) -> int:
        return self.blob[201]

    @property
    def cur_flags(self) -> int:
        return self.blob[202]

    def _f1600(self) -> None:
        """Permute the first 200 blob bytes in place.

        Dispatches on the native *library* directly (not the STROBE-op
        dispatch hook): the C permutation predates the C duplex ops, so
        a pure-Python-framing configuration must still use it — that is
        the configuration that actually shipped before the duplex moved
        to C, and what tools/host_ceiling.py --legacy reproduces."""
        from .. import native as _native

        if _native.lib is not None:
            _native.keccak_f1600(self.blob)  # c_char*200 view, 203 buffer
        else:
            st = bytearray(self.blob[:200])
            _keccak_f1600_py(st)
            self.blob[:200] = st

    def _run_f(self) -> None:
        b = self.blob
        b[b[200]] ^= b[201]
        b[b[200] + 1] ^= 0x04
        b[_STROBE_R + 1] ^= 0x80
        self._f1600()
        b[200] = 0
        b[201] = 0

    # the pure-Python duplex ops work in rate-bounded slices, not per
    # byte; they are the oracle for the C ops (tests/test_merlin.py
    # cross-checks every op against this path)

    def _absorb(self, data: bytes) -> None:
        i, n, b = 0, len(data), self.blob
        while i < n:
            take = min(_STROBE_R - b[200], n - i)
            p = b[200]
            b[p : p + take] = (
                int.from_bytes(b[p : p + take], "little")
                ^ int.from_bytes(data[i : i + take], "little")
            ).to_bytes(take, "little")
            b[200] += take
            i += take
            if b[200] == _STROBE_R:
                self._run_f()

    def _overwrite(self, data: bytes) -> None:
        i, n, b = 0, len(data), self.blob
        while i < n:
            take = min(_STROBE_R - b[200], n - i)
            b[b[200] : b[200] + take] = data[i : i + take]
            b[200] += take
            i += take
            if b[200] == _STROBE_R:
                self._run_f()

    def _squeeze(self, n: int) -> bytes:
        out = bytearray(n)
        i, b = 0, self.blob
        while i < n:
            take = min(_STROBE_R - b[200], n - i)
            out[i : i + take] = b[b[200] : b[200] + take]
            b[b[200] : b[200] + take] = bytes(take)
            b[200] += take
            i += take
            if b[200] == _STROBE_R:
                self._run_f()
        return bytes(out)

    def _begin_op(self, flags: int, more: bool) -> None:
        b = self.blob
        if more:
            if flags != b[202]:
                raise ValueError(
                    f"continued op flag mismatch: {flags} != {b[202]}"
                )
            return
        if flags & _FLAG_T:
            raise ValueError("transport ops unsupported in merlin strobe")
        old_begin = b[201]
        b[201] = b[200] + 1
        b[202] = flags
        self._absorb(bytes([old_begin, flags]))
        if (flags & (_FLAG_C | _FLAG_K)) and b[200] != 0:
            self._run_f()

    def meta_ad(self, data: bytes, more: bool) -> None:
        nat = _native_strobe()
        if nat is not None:
            if nat.strobe_op(self.blob, 0, bytes(data), more):
                raise ValueError("continued op flag mismatch")
            return
        self._begin_op(_FLAG_M | _FLAG_A, more)
        self._absorb(data)

    def ad(self, data: bytes, more: bool) -> None:
        nat = _native_strobe()
        if nat is not None:
            if nat.strobe_op(self.blob, 1, bytes(data), more):
                raise ValueError("continued op flag mismatch")
            return
        self._begin_op(_FLAG_A, more)
        self._absorb(data)

    def prf(self, n: int, more: bool) -> bytes:
        nat = _native_strobe()
        if nat is not None:
            out = nat.strobe_prf(self.blob, n, more)
            if out is None:
                raise ValueError("continued op flag mismatch")
            return out
        self._begin_op(_FLAG_I | _FLAG_A | _FLAG_C, more)
        return self._squeeze(n)

    def key(self, data: bytes, more: bool) -> None:
        nat = _native_strobe()
        if nat is not None:
            if nat.strobe_op(self.blob, 3, bytes(data), more):
                raise ValueError("continued op flag mismatch")
            return
        self._begin_op(_FLAG_A | _FLAG_C, more)
        self._overwrite(data)

    def clone(self) -> "Strobe128":
        dup = object.__new__(Strobe128)
        dup.blob = bytearray(self.blob)
        return dup


class Transcript:
    """merlin::Transcript (merlin transcript.rs), byte-compatible."""

    __slots__ = ("strobe",)

    def __init__(self, label: bytes):
        self.strobe = Strobe128(b"Merlin v1.0")
        self.append_message(b"dom-sep", label)

    def append_message(self, label: bytes, message: bytes) -> None:
        nat = _native_strobe()
        if nat is not None:
            # one library crossing for the whole merlin framing
            nat.merlin_append(self.strobe.blob, bytes(label), bytes(message))
            return
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(struct.pack("<I", len(message)), True)
        self.strobe.ad(message, False)

    def append_u64(self, label: bytes, value: int) -> None:
        self.append_message(label, struct.pack("<Q", value))

    def challenge_bytes(self, label: bytes, n: int) -> bytes:
        nat = _native_strobe()
        if nat is not None:
            return nat.merlin_challenge(self.strobe.blob, bytes(label), n)
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(struct.pack("<I", n), True)
        return self.strobe.prf(n, False)

    def clone(self) -> "Transcript":
        dup = object.__new__(Transcript)
        dup.strobe = self.strobe.clone()
        return dup
