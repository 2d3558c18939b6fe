"""Build-on-first-import ctypes loader for the native session library
(a copy of ``grapevine_tpu/native/__init__.py`` over its own ``r255.c``).

``r255.c`` (ristretto255, sr25519 batch verification, STROBE/merlin) is
compiled with the system C compiler into ``build/`` at the repository
root, as ``libgv_r255-<hash>.so`` with a hash of the source and flags in
the name, so this package never shares or rewrites another package's
shared object and a changed source never loads a stale one. Without a
compiler the package degrades to the pure-Python paths, as the
reference does — callers must treat ``lib`` as Optional, and
``BACKEND`` says which is live (``"native"`` or ``"python"``).

Thread-safety contract, per wrapper class:

- group/MSM wrappers (verify1, batch_check, reencode, mult_base) hold
  the module lock because their C functions use static scratch buffers
  (they are called from the scheduler's single collector thread anyway);
- the STROBE/merlin/keccak wrappers are deliberately LOCK-FREE and in
  exchange their C functions must never use static scratch — they touch
  only the caller's buffers, because gRPC worker threads run them
  concurrently on distinct transcripts (one per in-flight signature).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

_SRC = Path(__file__).resolve().parent / "r255.c"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build"
CFLAGS = ("-O2", "-shared", "-fPIC")

_lock = threading.Lock()
lib = None


def library_path() -> Path:
    """Where the library built from this ``r255.c`` and ``CFLAGS`` lives."""
    h = hashlib.sha256(" ".join(CFLAGS).encode())
    h.update(_SRC.read_bytes())
    return BUILD_DIR / f"libgv_r255-{h.hexdigest()[:16]}.so"


def _build() -> Path | None:
    try:
        so = library_path()
    except OSError:
        return None  # no C source: the pure-Python paths
    if so.exists():
        return so
    # compile to a private temp file, then atomically rename: concurrent
    # importers (pytest workers, server + worker processes) must never
    # dlopen a half-written .so or have a mapped one rewritten under them
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
    except OSError:
        return None
    tmp = BUILD_DIR / f"libgv_r255.{os.getpid()}.{threading.get_ident()}.tmp.so"
    cc = os.environ.get("CC", "cc")
    cmd = [cc, *CFLAGS, "-o", str(tmp), str(_SRC)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return None
    return so


def _load():
    global lib
    so = _build()
    if so is None:
        return None
    try:
        handle = ctypes.CDLL(str(so))
    except OSError:
        return None
    try:
        return _bind(handle)
    except AttributeError:
        # a cached .so built from older source (missing a newer export):
        # degrade to pure Python rather than failing the package import
        return None


def _bind(handle):
    handle.r255_init.restype = ctypes.c_int
    handle.r255_verify1.restype = ctypes.c_int
    handle.r255_verify1.argtypes = [ctypes.c_char_p] * 4
    handle.r255_batch_check.restype = ctypes.c_int
    handle.r255_batch_check.argtypes = [ctypes.c_size_t] + [ctypes.c_char_p] * 5
    handle.r255_encode.restype = ctypes.c_int
    handle.r255_encode.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    handle.r255_mult_base.restype = ctypes.c_int
    handle.r255_mult_base.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    handle.r255_keccak_f1600.restype = None
    handle.r255_keccak_f1600.argtypes = [ctypes.POINTER(ctypes.c_char)]
    handle.r255_strobe_op.restype = ctypes.c_int
    handle.r255_strobe_op.argtypes = [
        ctypes.POINTER(ctypes.c_char), ctypes.c_int, ctypes.c_char_p,
        ctypes.c_size_t, ctypes.POINTER(ctypes.c_char), ctypes.c_int,
    ]
    handle.r255_merlin_append.restype = None
    handle.r255_merlin_append.argtypes = [
        ctypes.POINTER(ctypes.c_char), ctypes.c_char_p, ctypes.c_size_t,
        ctypes.c_char_p, ctypes.c_size_t,
    ]
    handle.r255_merlin_challenge.restype = None
    handle.r255_merlin_challenge.argtypes = [
        ctypes.POINTER(ctypes.c_char), ctypes.c_char_p, ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_char), ctypes.c_size_t,
    ]
    handle.r255_schnorrkel_challenge.restype = None
    handle.r255_schnorrkel_challenge.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_size_t,
        ctypes.c_char_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_char),
    ]
    if handle.r255_init() != 0:
        return None
    return handle


lib = _load()
#: which implementation the session layer's group and transcript code uses
BACKEND = "native" if lib is not None else "python"


def verify1(pub: bytes, r_enc: bytes, s: bytes, k: bytes) -> int:
    """1 valid, 0 invalid, -1 malformed. Requires ``lib is not None``."""
    with _lock:
        return lib.r255_verify1(pub, r_enc, s, k)


def batch_check(rs: bytes, as_: bytes, z: bytes, zk: bytes, sb: bytes) -> int:
    n = len(rs) // 32
    with _lock:
        return lib.r255_batch_check(n, rs, as_, z, zk, sb)


def reencode(enc: bytes) -> bytes | None:
    out = ctypes.create_string_buffer(32)
    with _lock:
        rc = lib.r255_encode(out, enc)
    return bytes(out.raw) if rc == 0 else None


def keccak_f1600(state: bytearray) -> None:
    """In-place Keccak-f[1600] on a 200-byte state (merlin hot path).

    No module lock: the C function writes only the caller's buffer (no
    static scratch), so concurrent calls on distinct states are safe."""
    buf = (ctypes.c_char * 200).from_buffer(state)
    lib.r255_keccak_f1600(buf)


def mult_base(scalar_le: bytes) -> bytes | None:
    """Encoded ``scalar * basepoint`` (scalar: 32B LE, already reduced).

    The client-side signing hot path (session/ristretto.py:sign does two
    of these per request when cold, one when the pubkey is cached)."""
    out = ctypes.create_string_buffer(32)
    with _lock:
        rc = lib.r255_mult_base(out, scalar_le)
    return bytes(out.raw) if rc == 0 else None


# -- STROBE-128 / merlin transcript ops (session/merlin.py hot path) ---
# No module lock on any of these: the C functions touch only the
# caller's 203-byte blob (state ‖ pos ‖ pos_begin ‖ cur_flags), so
# concurrent calls on distinct transcripts are safe.

def strobe_op(blob: bytearray, op: int, data: bytes, more: bool) -> int:
    """One STROBE op: 0=meta_ad 1=ad 3=key. Returns 0, or <0 on a
    continued-op flag mismatch (caller raises)."""
    buf = (ctypes.c_char * 203).from_buffer(blob)
    return lib.r255_strobe_op(buf, op, data, len(data), None, 1 if more else 0)


def strobe_prf(blob: bytearray, n: int, more: bool) -> bytes | None:
    """PRF squeeze of ``n`` bytes; None on flag mismatch."""
    buf = (ctypes.c_char * 203).from_buffer(blob)
    out = ctypes.create_string_buffer(n)
    rc = lib.r255_strobe_op(buf, 2, None, n, out, 1 if more else 0)
    return bytes(out.raw) if rc == 0 else None


def merlin_append(blob: bytearray, label: bytes, message: bytes) -> None:
    """merlin append_message in one crossing (meta_ad + len + ad)."""
    buf = (ctypes.c_char * 203).from_buffer(blob)
    lib.r255_merlin_append(buf, label, len(label), message, len(message))


def merlin_challenge(blob: bytearray, label: bytes, n: int) -> bytes:
    """merlin challenge_bytes in one crossing (meta_ad + len + PRF)."""
    buf = (ctypes.c_char * 203).from_buffer(blob)
    out = ctypes.create_string_buffer(n)
    lib.r255_merlin_challenge(buf, label, len(label), out, n)
    return bytes(out.raw)


def schnorrkel_challenge(
    prefix_blob: bytes, message: bytes, pub: bytes, r_enc: bytes
) -> bytes:
    """64 challenge bytes from the cached SigningContext prefix in ONE
    crossing (clone + 4 appends + PRF; schnorrkel sign.rs labels).
    ``prefix_blob`` is the 203-byte transcript blob after
    ``Transcript(b"SigCtx")`` + ``append_message(b"", context)``."""
    out = ctypes.create_string_buffer(64)
    lib.r255_schnorrkel_challenge(
        bytes(prefix_blob), message, len(message), pub, r_enc, out
    )
    return bytes(out.raw)
