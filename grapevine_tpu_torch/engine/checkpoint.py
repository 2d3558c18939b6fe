"""Sealed whole-state checkpoints and the durability orchestrator (port
of ``grapevine_tpu/engine/checkpoint.py``).

- **Sealing**: checkpoints and journal frames are encrypted with ChaCha20
  under per-domain subkeys of a 32-byte root key and authenticated
  encrypt-then-MAC with HMAC-SHA256. A torn, truncated or tampered file
  fails the tag check and is *rejected whole*: there is no partial load.
  Pure stdlib plus an RFC 7539 ChaCha20 vectorized in numpy, run in
  chunks of 2^16 blocks with a running block counter (the same bytes as
  one pass, with a bounded keystream buffer: a checkpoint at 2^20
  messages is ~4.5 GB).
- **Obliviousness**: a checkpoint serializes the *entire* ``EngineState``
  every time and a journal frame the *entire* fixed-size batch, so the
  file-system access pattern of durability is a function of the geometry
  only.
- **Atomicity**: tmp + fsync + ``os.replace`` + directory fsync, so the
  newest ``ckpt-*.sealed`` is always complete; recovery = newest
  checkpoint + replay of the journal tail (``engine/journal.py``) through
  the same engine programs.

The container is the reference's: a JSON manifest (version, geometry
fingerprint, each leaf's dtype and shape), then the leaf buffers in the
reference's pytree order (the ``EngineState`` fields, each ``OramState``
field in order), u32 leaves as ``<u4`` little-endian. The port keeps u32
in int32 lanes, so leaves are converted with a view, never a value cast.
One leaf differs from the reference: the last, ``rng``, holds the
engine's ``torch.Generator`` state (``get_state()``, u8 ``|u1`` bytes)
where the reference holds its ``uint32[2]`` PRNG key, so that replayed
rounds draw exactly what the original rounds drew; a recursive position
map adds its side generator (``pm_rng``) after it, the same way. A
recursive map's internal tree sits inside each ``OramState`` where the
reference's pytree puts it (``posmap.inner.*``, ``posmap.dummy_entry``). The fingerprint
hashes ``repr`` of the port's own ``EngineConfig``, so a checkpoint or
journal written by the JAX package is refused with the reference's
geometry error, never misread (the two packages' generators differ).

Crash points for fault injection (``testing/faults.py``) are inlined at
the protocol-critical spots.
"""

from __future__ import annotations

import hashlib
import hmac
import json
import os
import re
import struct
import time

import numpy as np
import torch

from ..config import DurabilityConfig
from ..device import resolve_device
from ..oram.path_oram import oram_from_leaves, oram_leaf_shapes, oram_leaves
from ..testing import faults
from ..u32 import from_numpy, to_numpy
from .state import EngineConfig, EngineState

MAGIC = b"GVCKPT1\0"
VERSION = 1

_CKPT_RE = re.compile(r"^ckpt-(\d{16})\.sealed$")
#: ChaCha20 blocks per vectorized pass (4 MiB of keystream)
_CHUNK_BLOCKS = 1 << 16
#: EngineState's own leaves after the two trees, in field order (rng last)
_ENGINE_LEAVES = ("freelist", "free_top", "recipients", "seq", "hash_key", "id_key")


class DurabilityError(RuntimeError):
    """Base for checkpoint/journal failures (never a partial load)."""


class CheckpointError(DurabilityError):
    pass


class SealError(DurabilityError):
    """Sealed blob failed structural or integrity checks."""


def write_all(fd: int, data) -> None:
    """os.write until every byte lands: one write() is capped (~2 GiB on
    Linux) and may return short; an unchecked short count would publish a
    truncated sealed file."""
    view = memoryview(data)
    while view:
        n = os.write(fd, view)
        view = view[n:]


# -- sealing primitives (shared with engine/journal.py) -----------------


def _chacha_block_words(key_words, counter0: int, nonce_words, n_blocks: int):
    """RFC 7539 ChaCha20 keystream for ``n_blocks`` consecutive counters
    (mod 2^32 from ``counter0``), vectorized over the block axis with
    numpy, one contiguous lane per state word. Returns u32[n_blocks, 16]."""
    ctrs = (np.arange(n_blocks, dtype=np.uint64) + np.uint64(counter0)).astype(np.uint32)
    const = np.frombuffer(b"expand 32-byte k", dtype="<u4")
    init = [np.full(n_blocks, w, np.uint32)
            for w in (*const, *np.asarray(key_words, np.uint32))]
    init += [ctrs] + [np.full(n_blocks, w, np.uint32)
                      for w in np.asarray(nonce_words, np.uint32)]
    x = [w.copy() for w in init]
    t = np.empty(n_blocks, np.uint32)

    def rot(v, n):
        np.left_shift(v, np.uint32(n), out=t)
        np.right_shift(v, np.uint32(32 - n), out=v)
        np.bitwise_or(v, t, out=v)

    def qr(a, b, c, d):
        np.add(x[a], x[b], out=x[a])
        np.bitwise_xor(x[d], x[a], out=x[d])
        rot(x[d], 16)
        np.add(x[c], x[d], out=x[c])
        np.bitwise_xor(x[b], x[c], out=x[b])
        rot(x[b], 12)
        np.add(x[a], x[b], out=x[a])
        np.bitwise_xor(x[d], x[a], out=x[d])
        rot(x[d], 8)
        np.add(x[c], x[d], out=x[c])
        np.bitwise_xor(x[b], x[c], out=x[b])
        rot(x[b], 7)

    for _ in range(10):
        qr(0, 4, 8, 12)
        qr(1, 5, 9, 13)
        qr(2, 6, 10, 14)
        qr(3, 7, 11, 15)
        qr(0, 5, 10, 15)
        qr(1, 6, 11, 12)
        qr(2, 7, 8, 13)
        qr(3, 4, 9, 14)
    out = np.empty((n_blocks, 16), np.uint32)
    for i in range(16):
        np.add(x[i], init[i], out=out[:, i])
    return out


def chacha20_xor(key: bytes, nonce: bytes, data, counter: int = 0) -> bytes:
    """ChaCha20-XOR ``data`` (encrypt ≡ decrypt), in chunks of
    ``_CHUNK_BLOCKS`` blocks with a running block counter."""
    if len(key) != 32 or len(nonce) != 12:
        raise ValueError("key must be 32 bytes, nonce 12")
    src = np.frombuffer(data, np.uint8)
    n = src.shape[0]
    if n == 0:
        return b""
    out = np.empty(n, np.uint8)
    kw, nw = np.frombuffer(key, "<u4"), np.frombuffer(nonce, "<u4")
    step = 64 * _CHUNK_BLOCKS
    for lo in range(0, n, step):
        hi = min(n, lo + step)
        ks = _chacha_block_words(kw, counter + lo // 64, nw, (hi - lo + 63) // 64)
        ks_bytes = ks.astype("<u4", copy=False).view(np.uint8).reshape(-1)
        np.bitwise_xor(src[lo:hi], ks_bytes[: hi - lo], out=out[lo:hi])
    return out.tobytes()


def derive_key(root_key: bytes, label: bytes) -> bytes:
    """Per-domain 32-byte subkey: HMAC-SHA256(root, label)."""
    if len(root_key) != 32:
        raise ValueError("root key must be 32 bytes")
    return hmac.new(root_key, label, hashlib.sha256).digest()


def _tag(mac_key: bytes, aad: bytes, nonce: bytes, ct) -> bytes:
    h = hmac.new(mac_key, aad, hashlib.sha256)
    h.update(nonce)
    h.update(ct)
    return h.digest()


def seal(root_key: bytes, domain: bytes, plaintext, aad: bytes = b"") -> bytes:
    """Encrypt-then-MAC: returns ``nonce(12) | ct | tag(32)``.

    ``domain`` separates key schedules (checkpoint vs journal); ``aad``
    binds plaintext headers (magic, seq) into the tag without encrypting
    them."""
    enc = derive_key(root_key, b"grapevine-seal-enc:" + domain)
    mac = derive_key(root_key, b"grapevine-seal-mac:" + domain)
    nonce = os.urandom(12)
    ct = chacha20_xor(enc, nonce, plaintext)
    return nonce + ct + _tag(mac, aad, nonce, ct)


def unseal(root_key: bytes, domain: bytes, blob, aad: bytes = b"") -> bytes:
    """Verify and decrypt a :func:`seal` blob; raises SealError on any
    truncation or integrity failure, never returns partial plaintext."""
    if len(blob) < 12 + 32:
        raise SealError("sealed blob truncated (shorter than nonce + tag)")
    view = memoryview(blob)
    nonce, ct, tag = bytes(view[:12]), view[12:-32], bytes(view[-32:])
    mac = derive_key(root_key, b"grapevine-seal-mac:" + domain)
    if not hmac.compare_digest(tag, _tag(mac, aad, nonce, ct)):
        raise SealError(
            "sealed blob failed integrity check (torn, truncated, "
            "tampered, or sealed under a different root key)"
        )
    enc = derive_key(root_key, b"grapevine-seal-enc:" + domain)
    return chacha20_xor(enc, nonce, ct)


def load_or_create_root_key(path: str) -> bytes:
    """32-byte root seal key at ``path``; generated 0600 on first use."""
    try:
        fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_EXCL, 0o600)
    except FileExistsError:
        with open(path, "rb") as fh:
            key = fh.read()
        if len(key) != 32:
            raise SealError(f"root key file {path!r} is {len(key)} bytes, want 32")
        return key
    try:
        key = os.urandom(32)
        os.write(fd, key)
        os.fsync(fd)
    finally:
        os.close(fd)
    return key


# -- EngineState <-> bytes ---------------------------------------------


def engine_fingerprint(ecfg: EngineConfig) -> str:
    """Geometry fingerprint a checkpoint/journal is only valid against:
    ``repr`` of the port's frozen ``EngineConfig`` (every field that
    shapes the state or the replay semantics)."""
    return hashlib.sha256(repr(ecfg).encode()).hexdigest()


def state_spec(ecfg: EngineConfig) -> list[tuple]:
    """``(dtype str, shape)`` of every u32 leaf of an ``EngineState`` in
    serialization order (the generator leaves, last, are checked apart)."""
    engine = dict(freelist=(ecfg.max_messages,), free_top=(), recipients=(), seq=(2,),
                  hash_key=(2,), id_key=(4,))
    shapes = [s for cfg in (ecfg.rec, ecfg.mb) for s in oram_leaf_shapes(cfg).values()]
    shapes += [engine[k] for k in _ENGINE_LEAVES]
    return [("<u4", s) for s in shapes]


def _generators(ecfg: EngineConfig) -> int:
    """Generator leaves a state of this geometry carries: ``rng``, and a
    recursive map's ``pm_rng``."""
    return 2 if ecfg.posmap_impl == "recursive" else 1


def _u32_leaves(state: EngineState) -> list[torch.Tensor]:
    return (list(oram_leaves(state.rec).values()) + list(oram_leaves(state.mb).values())
            + [getattr(state, k) for k in _ENGINE_LEAVES])


def state_to_bytes(ecfg: EngineConfig, state: EngineState) -> bytes:
    """Serialize an EngineState: JSON manifest + raw leaf buffers in the
    reference's pytree order (waits for the device). A tree plane sharded
    over a mesh is written as its logical plane, shards joined in heap
    order without their scratch rows, so the bytes do not depend on the
    shard count and load at any count (``bytes_to_state`` gives a
    one-device state; the facade reshards it)."""
    # tobytes() writes C order; ascontiguousarray would turn 0-d leaves 1-d
    arrays = [to_numpy(t).astype("<u4", copy=False) for t in _u32_leaves(state)]
    arrays += [g.get_state().numpy() for g in (state.rng, state.pm_rng)[:_generators(ecfg)]]
    manifest = {
        "version": VERSION,
        "fingerprint": engine_fingerprint(ecfg),
        "leaves": [[a.dtype.str, list(a.shape)] for a in arrays],
    }
    head = json.dumps(manifest, separators=(",", ":")).encode()
    return b"".join([struct.pack("<I", len(head)), head] + [a.tobytes() for a in arrays])


def bytes_to_state(ecfg: EngineConfig, data, device=None) -> EngineState:
    """Inverse of :func:`state_to_bytes`, onto ``device`` (``None`` → the
    CUDA card); rejects geometry mismatches and truncated buffers whole
    (CheckpointError)."""
    dev = resolve_device(device)
    if len(data) < 4:
        raise CheckpointError("state payload truncated (no manifest)")
    (head_len,) = struct.unpack_from("<I", data, 0)
    if len(data) < 4 + head_len:
        raise CheckpointError("state payload truncated (manifest cut short)")
    try:
        manifest = json.loads(bytes(data[4: 4 + head_len]))
    except ValueError as exc:
        raise CheckpointError(f"state manifest unparseable: {exc}") from None
    if manifest.get("version") != VERSION:
        raise CheckpointError(
            f"state payload version {manifest.get('version')!r}, want {VERSION}")
    if manifest.get("fingerprint") != engine_fingerprint(ecfg):
        raise CheckpointError(
            "checkpoint geometry fingerprint does not match this engine "
            "config — restore requires the identical GrapevineConfig "
            "(capacities, heights, batch size, cipher) it was taken under"
        )
    spec = state_spec(ecfg)
    ngen = _generators(ecfg)
    decl = manifest.get("leaves", [])
    if len(decl) != len(spec) + ngen:
        raise CheckpointError(
            f"state payload has {len(decl)} leaves, geometry wants {len(spec) + ngen}")
    gens = decl[len(spec):]
    for rng_dt, rng_shape in gens:
        if rng_dt != "|u1" or len(rng_shape) != 1:
            raise CheckpointError(
                f"state leaf mismatch: generator state {rng_dt}{rng_shape}")
    off = 4 + head_len
    arrays = []
    for (dt_str, shape), (want_dt, want_shape) in zip(decl, spec + gens):
        shape = tuple(shape)
        if dt_str != want_dt or shape != tuple(want_shape):
            raise CheckpointError(
                f"state leaf mismatch: payload {dt_str}{shape}, geometry wants "
                f"{want_dt}{tuple(want_shape)}")
        dt = np.dtype(dt_str)
        count = int(np.prod(shape, dtype=np.int64))
        if off + dt.itemsize * count > len(data):
            raise CheckpointError("state payload truncated (leaf cut short)")
        arrays.append(np.frombuffer(data, dt, count=count, offset=off).reshape(shape))
        off += dt.itemsize * count
    if off != len(data):
        raise CheckpointError(f"state payload has {len(data) - off} trailing bytes")
    gens = []
    for a in arrays[len(spec):]:
        gen = torch.Generator(device=dev)
        try:
            gen.set_state(torch.from_numpy(a.copy()))
        except RuntimeError as exc:
            raise CheckpointError(f"generator state does not fit {dev}: {exc}") from None
        gens.append(gen)
    leaves = iter(from_numpy(a.astype(np.uint32, copy=False), dev)
                  for a in arrays[:len(spec)])
    rec = oram_from_leaves(ecfg.rec, lambda _name: next(leaves))
    mb = oram_from_leaves(ecfg.mb, lambda _name: next(leaves))
    return EngineState(
        rec=rec, mb=mb, **{k: next(leaves) for k in _ENGINE_LEAVES},
        rng=gens[0], pm_rng=gens[1] if ngen == 2 else None,
    )


# -- sealed checkpoint files -------------------------------------------


def _fsync_dir(path: str) -> None:
    dfd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(dfd)
    finally:
        os.close(dfd)


def checkpoint_path(state_dir: str, seq: int) -> str:
    return os.path.join(state_dir, f"ckpt-{seq:016d}.sealed")


def write_checkpoint(state_dir: str, root_key: bytes, ecfg: EngineConfig,
                     state: EngineState, seq: int) -> str:
    """Atomically write the sealed checkpoint for journal seq ``seq``.

    tmp + fsync + rename + directory fsync: a crash at any point leaves
    either the previous checkpoint set or the new file complete, never a
    half-written ``ckpt-*.sealed``."""
    payload = struct.pack("<Q", seq) + state_to_bytes(ecfg, state)
    head = MAGIC + struct.pack("<I", VERSION)
    blob = head + seal(root_key, b"checkpoint", payload, aad=head)
    del payload
    path = checkpoint_path(state_dir, seq)
    tmp = path + f".tmp.{os.getpid()}"
    fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
    try:
        if faults.active() and faults.hit("checkpoint.tmp.torn"):
            write_all(fd, blob[: len(blob) // 2])
            os.fsync(fd)
            faults.die()
        write_all(fd, blob)
        os.fsync(fd)
    finally:
        os.close(fd)
    if faults.active():
        faults.crash("checkpoint.pre_rename")
    os.replace(tmp, path)
    _fsync_dir(state_dir)
    if faults.active():
        faults.crash("checkpoint.post_rename")
    return path


def load_checkpoint(path: str, root_key: bytes, ecfg: EngineConfig,
                    device=None) -> tuple[int, EngineState]:
    """Load a sealed checkpoint onto ``device``; returns ``(seq, state)``.
    Any truncation, tamper or geometry mismatch raises CheckpointError:
    the state is never half-loaded."""
    with open(path, "rb") as fh:
        blob = fh.read()
    head = MAGIC + struct.pack("<I", VERSION)
    if len(blob) < len(head) or blob[: len(MAGIC)] != MAGIC:
        raise CheckpointError(f"{path}: not a grapevine checkpoint")
    if blob[len(MAGIC): len(head)] != head[len(MAGIC):]:
        (ver,) = struct.unpack_from("<I", blob, len(MAGIC))
        raise CheckpointError(f"{path}: version {ver}, want {VERSION}")
    try:
        payload = unseal(root_key, b"checkpoint", memoryview(blob)[len(head):], aad=head)
    except SealError as exc:
        raise CheckpointError(f"{path}: {exc}") from None
    del blob
    if len(payload) < 8:
        raise CheckpointError(f"{path}: payload truncated")
    (seq,) = struct.unpack_from("<Q", payload, 0)
    return seq, bytes_to_state(ecfg, memoryview(payload)[8:], device)


def find_latest_checkpoint(state_dir: str) -> tuple[int, str] | None:
    """Newest ``ckpt-<seq>.sealed`` by sequence number, or None."""
    best = None
    try:
        names = os.listdir(state_dir)
    except FileNotFoundError:
        return None
    for name in names:
        m = _CKPT_RE.match(name)
        if m:
            seq = int(m.group(1))
            if best is None or seq > best[0]:
                best = (seq, os.path.join(state_dir, name))
    return best


def prune_checkpoints(state_dir: str, keep_seq: int) -> None:
    """Delete every checkpoint except ``keep_seq``'s (called only after
    the kept one is durably renamed), and stale tmp files of crashed
    checkpoint attempts."""
    for name in os.listdir(state_dir):
        m = _CKPT_RE.match(name)
        if (m and int(m.group(1)) != keep_seq) or ".sealed.tmp." in name:
            try:
                os.unlink(os.path.join(state_dir, name))
            except OSError:  # pragma: no cover - concurrent cleanup
                pass


# -- the durability orchestrator ---------------------------------------


class DurabilityManager:
    """Owns a state dir: root key, journal, checkpoints, recovery.

    One per engine, driven from ``GrapevineEngine`` under the engine lock
    (appends and checkpoints are serialized with rounds by construction).
    Loaded checkpoints land on ``device`` (``None`` → the CUDA card).
    With a ``registry`` it exports the reference's eight durability
    series (batch-level only: sequence numbers, counts and durations,
    never content)."""

    def __init__(self, dcfg: DurabilityConfig, ecfg: EngineConfig, device=None,
                 registry=None):
        from .journal import BatchJournal

        self.dcfg = dcfg
        self.ecfg = ecfg
        self.device = resolve_device(device)
        os.makedirs(dcfg.state_dir, exist_ok=True)
        key_path = dcfg.seal_key_file or os.path.join(dcfg.state_dir, "root.key")
        self.root_key = load_or_create_root_key(key_path)
        self._c_records = self._c_fsyncs = self._c_ckpts = None
        self._g_durable = self._g_ckpt = self._g_replayed = None
        self._g_recovery_s = self._g_applied = None
        if registry is not None:
            self._c_records = registry.counter(
                "grapevine_journal_records_total",
                "batches + sweeps appended to the sealed journal")
            self._c_fsyncs = registry.counter(
                "grapevine_journal_fsyncs_total",
                "journal fsync barriers issued")
            self._c_ckpts = registry.counter(
                "grapevine_checkpoints_total",
                "sealed whole-state checkpoints written")
            self._g_durable = registry.gauge(
                "grapevine_last_durable_seq",
                "highest journal sequence fsynced to disk")
            self._g_ckpt = registry.gauge(
                "grapevine_last_checkpoint_seq",
                "journal sequence of the newest sealed checkpoint")
            self._g_replayed = registry.gauge(
                "grapevine_recovery_replayed_records",
                "journal records replayed during the last recovery")
            self._g_recovery_s = registry.gauge(
                "grapevine_recovery_seconds",
                "wall time of the last startup recovery")
            self._g_applied = registry.gauge(
                "grapevine_journal_applied_seq",
                "highest journal sequence applied to engine state (on "
                "the primary this tracks journal_seq; on a follower "
                "replaying shipped journal frames it is the replication "
                "frontier — the fleet aggregator derives "
                "grapevine_fleet_journal_lag_seq from it; ROADMAP "
                "item 4, OPERATIONS.md §20)")
        self.journal = BatchJournal(dcfg.state_dir, self.root_key, ecfg,
                                    fsync_every=dcfg.journal_fsync_every,
                                    on_fsync=self._note_fsync)
        self.ckpt_seq = 0  # journal seq covered by the newest checkpoint
        #: highest journal seq applied to engine state
        self.applied_seq = 0
        self.replayed = 0
        self.recovered_from_checkpoint = False

    # journal callback: runs under the engine lock with the append
    def _note_fsync(self, durable_seq: int) -> None:
        if self._c_fsyncs is not None:
            self._c_fsyncs.inc()
            self._g_durable.set(durable_seq)

    # -- recovery -------------------------------------------------------

    def recover(self, init_state: EngineState, apply_fn) -> EngineState:
        """Restore state: newest checkpoint (if any) + journal replay.

        ``apply_fn(state, record)`` applies one journal record and returns
        the next state (the engine's round/flush/sweep). Corrupt
        checkpoints and mid-journal corruption raise; only a torn *tail*
        frame (the crash-mid-append case) is discarded."""
        t0 = time.monotonic()
        state = init_state
        latest = find_latest_checkpoint(self.dcfg.state_dir)
        if latest is not None:
            seq, state = load_checkpoint(latest[1], self.root_key, self.ecfg, self.device)
            if seq != latest[0]:
                # the filename seq picks which file to load; the sealed
                # payload seq is what replay trusts
                raise CheckpointError(
                    f"{latest[1]}: filename seq {latest[0]} != sealed "
                    f"payload seq {seq} (file renamed?)"
                )
            self.ckpt_seq = seq
            self.recovered_from_checkpoint = True
        self.replayed = 0
        self.note_applied_seq(self.ckpt_seq)
        for rec in self.journal.replay(after_seq=self.ckpt_seq):
            state = apply_fn(state, rec)
            self.replayed += 1
            self.note_applied_seq(self.journal.seq)
            if self._g_replayed is not None:
                self._g_replayed.set(self.replayed)
        self.journal.open_for_append()
        if self._g_ckpt is not None:
            self._g_ckpt.set(self.ckpt_seq)
            self._g_durable.set(self.journal.seq)
            self._g_recovery_s.set(round(time.monotonic() - t0, 6))
        return state

    # -- steady state ---------------------------------------------------

    @property
    def seq(self) -> int:
        return self.journal.seq

    def note_applied_seq(self, seq: int) -> None:
        """Record that engine state now reflects journal records up to
        ``seq`` (the append path calls it on the primary)."""
        self.applied_seq = seq
        if self._g_applied is not None:
            self._g_applied.set(seq)

    def _appended(self, seq: int) -> int:
        if self._c_records is not None:
            self._c_records.inc()
        self.note_applied_seq(seq)
        return seq

    def append_round(self, batch: dict, n_real: int) -> int:
        return self._appended(self.journal.append_round(batch, n_real))

    def append_sweep(self, now: int, now_hi: int, period: int) -> int:
        return self._appended(self.journal.append_sweep(now, now_hi, period))

    def append_flush(self) -> int:
        """Delayed-eviction flush marker (``journal.KIND_FLUSH``); counts
        toward the checkpoint cadence like rounds and sweeps."""
        return self._appended(self.journal.append_flush())

    def append_raw_frame(self, seq: int, frame: bytes) -> int:
        """Follower path (``engine/replication.py``): persist one shipped
        journal frame verbatim. It counts in the records telemetry like a
        locally encoded record; the caller notes the applied seq only
        after the apply on the device was enqueued."""
        seq = self.journal.append_raw(seq, frame)
        if self._c_records is not None:
            self._c_records.inc()
        return seq

    def install_checkpoint(self, seq: int, blob: bytes) -> EngineState:
        """Standby bootstrap: persist a sealed checkpoint the primary
        shipped, load it onto this manager's device and re-base the local
        journal at it. The blob goes through the normal load path (seal,
        geometry fingerprint, payload seq) before anything is re-based, so
        a cross-knob or tampered checkpoint is refused with the usual
        error. Returns the loaded state."""
        path = checkpoint_path(self.dcfg.state_dir, seq)
        tmp = f"{path}.tmp.{os.getpid()}"
        fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_EXCL, 0o600)
        try:
            write_all(fd, blob)
            os.fsync(fd)
        finally:
            os.close(fd)
        os.replace(tmp, path)
        _fsync_dir(self.dcfg.state_dir)
        got_seq, state = load_checkpoint(path, self.root_key, self.ecfg, self.device)
        if got_seq != seq:
            raise CheckpointError(
                f"{path}: shipped checkpoint payload seq {got_seq} != "
                f"advertised {seq}"
            )
        # re-base: a fresh segment at seq+1; every older file is covered
        self.journal.seq = seq
        self.journal.durable_seq = seq
        self.journal.roll()
        prune_checkpoints(self.dcfg.state_dir, seq)
        self.ckpt_seq = seq
        self.recovered_from_checkpoint = True
        if self._c_ckpts is not None:
            self._c_ckpts.inc()
            self._g_ckpt.set(seq)
            self._g_durable.set(seq)
        self.note_applied_seq(seq)
        return state

    def should_checkpoint(self) -> bool:
        return self.journal.seq - self.ckpt_seq >= self.dcfg.checkpoint_every_rounds

    def checkpoint(self, state: EngineState) -> int:
        """Seal the current state at the current journal seq, then roll
        the journal and prune what the new checkpoint covers. Returns the
        checkpointed seq (also when skipped: nothing new journaled)."""
        seq = self.journal.seq
        if seq == self.ckpt_seq and self.recovered_from_checkpoint:
            return seq
        # the journal tail durable first: if the checkpoint crashes half
        # way, recovery must still reach seq through the old chain
        self.journal.sync()
        write_checkpoint(self.dcfg.state_dir, self.root_key, self.ecfg, state, seq)
        self.ckpt_seq = seq
        self.recovered_from_checkpoint = True
        self.journal.roll()
        prune_checkpoints(self.dcfg.state_dir, seq)
        if self._c_ckpts is not None:
            self._c_ckpts.inc()
            self._g_ckpt.set(seq)
        return seq

    def status(self) -> dict:
        """Batch-level durability detail for health views."""
        return {
            "last_durable_seq": self.journal.durable_seq,
            "journal_seq": self.journal.seq,
            "applied_seq": self.applied_seq,
            "last_checkpoint_seq": self.ckpt_seq,
            "recovery_replayed_records": self.replayed,
            "journal_epoch": self.journal.epoch,
        }

    def close(self) -> None:
        self.journal.close()
