"""Journal-shipped hot standby: streaming replication and fenced takeover
(port of ``grapevine_tpu/engine/replication.py``; the wire and the
handshake are the reference's).

The primary engine keeps its append-before-dispatch journal; a
:class:`JournalShipper` tails it and streams every sealed frame, verbatim,
to a :class:`StandbyReplica` over a length-prefixed TCP connection. The
standby appends each frame to its own journal (same fsync discipline,
``BatchJournal.append_raw``) and applies it at once through the programs
crash recovery uses (``GrapevineEngine._replay_record``: B3 on a replayed
fused round, B5 on a replayed flush, B2 on a replayed sweep), so its warm
state trails the primary by the shipping latency alone, and the
``grapevine_journal_applied_seq`` gauge prices the gap.

Obliviousness: a shipped frame is the sealed journal frame, of a constant
size per kind, one per journaled record, shipped at round cadence. The
link's traffic is a function of the round counter only, never of the
buffers' contents; :meth:`JournalShipper.stats` keeps the books
(``cadence_ok``: every frame was one of the geometry's legal sizes).

Fenced takeover: :meth:`StandbyReplica.promote` (1) plants a fence marker
in the dead primary's state dir (O_EXCL: a double promote has exactly one
winner) carrying the bumped journal epoch, so a revived or still running
stale primary's next append raises ``JournalError``; (2) drains the
primary's durable journal tail straight off disk (RPO 0 for durable
frames: a SIGKILL leaves everything written in the page cache); (3)
completes a pending eviction flush as the recovery constructor does;
(4) waits for the device and re-anchors the admission bound on the
promoted state (``_read_bound_locked``), then serves. RTO is the tail
drain and its replay, measured and returned.

Knobs: the standby's ``checkpoint_every_rounds`` bounds its own restart
replay; the primary's bounds how far a standby that never connected must
drain at promote; ``journal_fsync_every`` bounds what a machine crash
(not a process kill) can lose; ``ship_every`` batches doorbell wake-ups
without changing what ships.

Cross-knob legality: journal frames encode batches, not tree-cache
placement, so a ``tree_top_cache_levels=0`` standby replays a k=4
primary's frames from genesis (:func:`replication_fingerprint` is the
frame-compatibility check). Sealed checkpoints do encode placement:
shipping one needs the full geometry fingerprint to match, so a
cross-knob standby must start from an unpruned journal. Both state dirs
must share the root seal key (``seal_key_file``).

A sharded engine (``shards > 1``) reshards every installed checkpoint
(a shipped one on the standby, the newest one at promotion) onto its
mesh, as the reference's ``replication.py`` does.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import socket
import struct
import threading
import time

from ..config import DurabilityConfig, GrapevineConfig
from .checkpoint import engine_fingerprint, find_latest_checkpoint
from .journal import (
    _HEADER,
    BatchJournal,
    JournalError,
    read_epoch,
    write_epoch,
    write_fence,
)
from .state import EngineConfig

log = logging.getLogger("grapevine_tpu_torch.replication")

#: wire protocol: ``u32 total_len | u8 type | payload``
MSG_HELLO = 1  # JSON handshake, the standby speaks first
MSG_CKPT = 2  # u64 seq | sealed checkpoint file bytes
MSG_FRAME = 3  # one raw journal frame, verbatim

_LEN = struct.Struct("<I")


class ReplicationError(RuntimeError):
    """Replication protocol or transport failure (a reconnect may fix it)."""


class FatalReplicationError(ReplicationError):
    """A mismatch no reconnect can fix (fingerprint, stale epoch)."""


def _parse_addr(target) -> tuple[str, int]:
    if isinstance(target, (tuple, list)):
        return str(target[0]), int(target[1])
    host, _, port = str(target).rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"replication address must be host:port, got {target!r}")
    return host, int(port)


def _send_msg(sock: socket.socket, mtype: int, payload: bytes) -> None:
    sock.sendall(_LEN.pack(1 + len(payload)) + bytes([mtype]) + payload)


#: seconds a message already begun may go without a byte before the link
#: is dropped (the primary then reconnects and resends from the standby's
#: applied seq)
MID_MESSAGE_STALL_S = 30.0
#: largest single ``recv``: a corrupt length must not size one buffer
_RECV_CHUNK = 1 << 20


def _recv_exact(sock: socket.socket, n: int, *, start: bool) -> bytes | None:
    """Read exactly ``n`` bytes. EOF at a message boundary (``start``)
    returns None, a clean disconnect; EOF mid-message raises (the peer died
    mid-send; the partial bytes are discarded, never applied).

    The socket's timeout is the caller's idle poll: it propagates only at a
    message boundary. Once a message has begun, a timeout keeps the bytes
    read so far and waits on (dropping them would leave the rest of the
    message to be parsed as the next header); a stall past
    ``MID_MESSAGE_STALL_S`` raises, which drops the link."""
    buf = bytearray()
    last = time.monotonic()
    while len(buf) < n:
        try:
            chunk = sock.recv(min(n - len(buf), _RECV_CHUNK))
        except socket.timeout:
            if start and not buf:
                raise
            if time.monotonic() - last > MID_MESSAGE_STALL_S:
                raise ReplicationError(
                    f"peer stalled mid-message ({len(buf)}/{n} bytes)") from None
            continue
        if not chunk:
            if start and not buf:
                return None
            raise ReplicationError(f"peer closed mid-message ({len(buf)}/{n} bytes)")
        buf += chunk
        last = time.monotonic()
    return bytes(buf)


def _recv_msg(sock: socket.socket) -> tuple[int, bytes] | None:
    hdr = _recv_exact(sock, _LEN.size, start=True)
    if hdr is None:
        return None
    (total,) = _LEN.unpack(hdr)
    if total < 1:
        raise ReplicationError("zero-length replication message")
    body = _recv_exact(sock, total, start=False)
    return body[0], body[1:]


def replication_fingerprint(config: GrapevineConfig) -> str:
    """Frame-compatibility fingerprint: the port's full engine fingerprint
    with ``tree_top_cache_levels`` normalized to 0.

    Journal frames serialize batches, not tree-cache placement, and the
    tree-top cache only re-places bits, so a k=4 primary's frames replay
    on a k=0 standby (the rolling-upgrade drill). Everything else the full
    fingerprint covers (geometry, eviction cadence, position map) still
    fences: frames replay only under the identical resolved program."""
    norm = dataclasses.replace(config, tree_top_cache_levels=0)
    return engine_fingerprint(EngineConfig.from_config(norm))


# -- primary side -------------------------------------------------------


class JournalShipper:
    """Primary-side replication: tail the engine's sealed journal and
    stream its frames to one standby.

    One daemon thread: connect (with backoff), handshake, catch up, drain.
    The journal file is the only source of truth. The ``on_append`` hook,
    called under the engine lock, is a doorbell only (a counter bump and
    an event set, no I/O); the shipper thread re-reads frames off disk
    with a read-only ``BatchJournal`` (page cache, no fsync wait), so a
    reconnect or a race needs no resync."""

    def __init__(self, engine, target, ship_every: int = 1,
                 connect_backoff_s: float = 0.25):
        if engine.durability is None:
            raise ReplicationError(
                "--replicate-to needs --state-dir: the shipper tails the "
                "sealed journal"
            )
        self.engine = engine
        self.target = _parse_addr(target)
        self.ship_every = max(1, int(ship_every))
        self.connect_backoff_s = connect_backoff_s
        dm = engine.durability
        self._dm = dm
        self._reader = BatchJournal(dm.dcfg.state_dir, dm.root_key, dm.ecfg)
        #: the legal on-wire frame sizes of this geometry (the cadence
        #: book): every shipped frame must be one of these constants,
        #: whatever the ops inside are
        self._legal_frame_lens = frozenset(
            _HEADER.size + bl for bl in self._reader._valid_blob_lens
        )
        registry = engine.metrics.registry
        self._c_shipped = registry.counter(
            "grapevine_replication_frames_shipped_total",
            "sealed journal frames streamed to the standby")
        self._c_reconnects = registry.counter(
            "grapevine_replication_reconnects_total",
            "replication link (re)connection attempts")
        self._g_connected = registry.gauge(
            "grapevine_replication_connected",
            "1 while the replication link to the standby is up")
        self._frames_shipped = 0
        self._bytes_shipped = 0
        self._frames_appended = 0
        self._illegal_frames = 0
        self.fatal: str | None = None
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="journal-shipper")

    def start(self) -> None:
        self._dm.journal.on_append = self._on_append
        self._thread.start()

    # runs under the engine lock with the append: a doorbell only
    def _on_append(self, seq: int, frame: bytes) -> None:
        self._frames_appended += 1
        if self._frames_appended % self.ship_every == 0:
            self._wake.set()

    def _run(self) -> None:
        backoff = self.connect_backoff_s
        while not self._stop.is_set():
            self._c_reconnects.inc()
            try:
                self._ship_session()
                backoff = self.connect_backoff_s
            except FatalReplicationError as exc:
                self.fatal = str(exc)
                log.error("replication halted: %s", exc)
                return
            except (OSError, ReplicationError, JournalError) as exc:
                log.info("replication link lost: %s", exc)
            self._stop.wait(backoff)
            backoff = min(backoff * 2, 5.0)

    def _ship_session(self) -> None:
        dm = self._dm
        sock = socket.create_connection(self.target, timeout=5.0)
        try:
            sock.settimeout(10.0)
            msg = _recv_msg(sock)
            if msg is None or msg[0] != MSG_HELLO:
                raise ReplicationError("standby did not send hello")
            hello = json.loads(msg[1])
            my_full = engine_fingerprint(dm.ecfg)
            my_repl = replication_fingerprint(self.engine.config)
            if hello.get("replication_fingerprint") != my_repl:
                raise FatalReplicationError(
                    "standby geometry fingerprint does not match: journal "
                    "frames replay only under the identical resolved "
                    "geometry; refusing to ship"
                )
            if int(hello.get("epoch", 0)) > dm.journal.epoch:
                raise FatalReplicationError(
                    f"standby is at journal epoch {hello['epoch']} > this "
                    f"primary's {dm.journal.epoch}: this primary is stale "
                    "(fenced); refusing to ship"
                )
            _send_msg(sock, MSG_HELLO, json.dumps({
                "fingerprint": my_full,
                "replication_fingerprint": my_repl,
                "epoch": dm.journal.epoch,
                "ckpt_seq": dm.ckpt_seq,
                "seq": dm.seq,
            }).encode())
            sent = int(hello.get("applied_seq", 0))
            if sent < dm.ckpt_seq:
                # frames at or below the checkpoint horizon are pruned:
                # bootstrap from the sealed checkpoint. Checkpoints encode
                # placement, so this needs the FULL fingerprint; a
                # cross-knob standby can only replay from genesis
                if hello.get("fingerprint") != my_full:
                    raise FatalReplicationError(
                        "cross-knob standby must replay the journal from "
                        "genesis, but this primary pruned through seq "
                        f"{dm.ckpt_seq}: bring the standby up before the "
                        "first checkpoint, or match knobs"
                    )
                latest = find_latest_checkpoint(dm.dcfg.state_dir)
                if latest is None:
                    raise ReplicationError(
                        "checkpoint horizon is non-zero but no sealed "
                        "checkpoint is on disk"
                    )
                with open(latest[1], "rb") as fh:
                    blob = fh.read()
                _send_msg(sock, MSG_CKPT, struct.pack("<Q", latest[0]) + blob)
                sent = latest[0]
            sock.settimeout(None)
            self._g_connected.set(1)
            while not self._stop.is_set():
                for seq, frame in self._reader.follow_frames(after_seq=sent):
                    if len(frame) not in self._legal_frame_lens:
                        # unreachable by construction (follow_frames checked
                        # the length); the cadence book's tripwire all the same
                        self._illegal_frames += 1
                    _send_msg(sock, MSG_FRAME, frame)
                    sent = seq
                    self._frames_shipped += 1
                    self._bytes_shipped += _LEN.size + 1 + len(frame)
                    self._c_shipped.inc()
                self._wake.wait(0.2)
                self._wake.clear()
        finally:
            self._g_connected.set(0)
            sock.close()

    def stats(self) -> dict:
        """The cadence books: shipping totals, and whether every byte on
        the wire was one of the geometry's constant frame sizes plus the
        constant framing (``cadence_ok``)."""
        return {
            "frames_shipped": self._frames_shipped,
            "bytes_shipped": self._bytes_shipped,
            "frames_appended": self._frames_appended,
            "illegal_frames": self._illegal_frames,
            "cadence_ok": self._illegal_frames == 0,
        }

    def close(self) -> None:
        self._stop.set()
        self._wake.set()
        # ``==``: each attribute access makes a new bound method, so an
        # identity test would never match and never unhook the doorbell
        if self._dm.journal.on_append == self._on_append:
            self._dm.journal.on_append = None
        if self._thread.is_alive():
            self._thread.join(timeout=5.0)


# -- standby side -------------------------------------------------------


class StandbyReplica:
    """Warm follower: journals shipped frames locally, applies them
    through the engine's own programs on its device, checkpoints on its
    own cadence, and takes over with :meth:`promote`.

    Construction builds a full durable engine over the standby's own state
    dir on ``device`` (``None`` → the CUDA card; raises without one), so a
    standby that restarts recovers its warm state from its checkpoint and
    journal as a primary would. It runs no rounds of its own until
    promoted."""

    def __init__(self, config: GrapevineConfig | None = None, seed: int = 0,
                 durability: DurabilityConfig | None = None, device=None):
        from .batcher import GrapevineEngine

        if durability is None:
            raise ReplicationError("a standby needs its own state dir (DurabilityConfig)")
        self.config = config or GrapevineConfig()
        self.engine = GrapevineEngine(self.config, seed=seed, device=device,
                                      durability=durability)
        self.dm = self.engine.durability
        self.registry = self.engine.metrics.registry
        self.full_fingerprint = engine_fingerprint(self.engine.ecfg)
        self.repl_fingerprint = replication_fingerprint(self.config)
        self.promoted = False
        self.connected = False
        self._c_applied = self.registry.counter(
            "grapevine_replication_frames_applied_total",
            "shipped journal frames applied to standby state")
        self._c_promotions = self.registry.counter(
            "grapevine_replication_promotions_total",
            "fenced takeovers served from this replica")
        self._g_connected = self.registry.gauge(
            "grapevine_replication_connected",
            "1 while a primary is feeding this standby")
        self._g_epoch = self.registry.gauge(
            "grapevine_replication_epoch",
            "journal epoch this replica serves under")
        self._g_rto = self.registry.gauge(
            "grapevine_replication_last_rto_seconds",
            "measured promote() wall time (fence + tail drain + replay)")
        self._g_epoch.set(self.dm.journal.epoch)
        self._stop = threading.Event()
        self._lsock: socket.socket | None = None
        self._accept_thread: threading.Thread | None = None
        self._metrics_server = None

    # -- frame application ---------------------------------------------

    def _decode_frame(self, seq: int, frame: bytes):
        """Verify and decode one shipped frame (the seal checked under the
        shared root key with the header as AAD, the body against this
        standby's geometry) before it becomes local durable state."""
        from .checkpoint import SealError, unseal

        if len(frame) < _HEADER.size:
            raise ReplicationError(f"frame {seq}: shorter than a header")
        header = frame[:_HEADER.size]
        try:
            body = unseal(self.dm.root_key, b"journal", frame[_HEADER.size:], aad=header)
        except SealError as exc:
            raise ReplicationError(
                f"shipped frame {seq} failed its integrity check: {exc}"
            ) from exc
        return self.dm.journal._decode_body(seq, body)

    def _apply_locked(self, seq: int, frame: bytes) -> bool:
        """Journal and apply one frame; the caller holds the engine lock.
        A duplicate (reconnect overlap) is skipped; a gap is a protocol
        error (the journal's contiguity check would refuse it too, but
        failing before the decode says more)."""
        eng = self.engine
        if seq <= self.dm.seq:
            return False
        if seq != self.dm.seq + 1:
            raise ReplicationError(
                f"shipped frame {seq} but the standby journal is at "
                f"{self.dm.seq}: a frame went missing in transit"
            )
        rec = self._decode_frame(seq, frame)
        self.dm.append_raw_frame(seq, frame)
        eng.state = eng._replay_record(eng.state, rec)
        self.dm.note_applied_seq(seq)
        self._c_applied.inc()
        if self.dm.should_checkpoint():
            self.dm.checkpoint(eng.state)
        return True

    def apply_frame(self, seq: int, frame: bytes) -> bool:
        with self.engine._lock:
            if self.promoted:
                raise ReplicationError("promoted replicas do not accept shipped frames")
            return self._apply_locked(seq, frame)

    def _install_locked(self, seq: int, blob: bytes) -> None:
        """Install a sealed checkpoint as the engine's state; the caller
        holds the engine lock. The state is set from outside: the replay
        cadence audit restarts from the new state's window counter, and
        the admission bound, which belongs to the old state's version
        (``GrapevineEngine.state``'s setter bumps it), reads the new state
        exactly before the next round decides."""
        eng = self.engine
        eng.state = eng._shard_state(self.dm.install_checkpoint(seq, blob))
        eng._replay_since = None

    def _install_checkpoint(self, seq: int, blob: bytes) -> None:
        with self.engine._lock:
            if self.promoted:
                raise ReplicationError("promoted replicas do not accept shipped checkpoints")
            if seq <= self.dm.seq:
                return
            self._install_locked(seq, blob)

    # -- transport ------------------------------------------------------

    def listen(self, host: str = "127.0.0.1", port: int = 0) -> int:
        """Accept primary connections on ``host:port`` (0 = ephemeral);
        returns the bound port. One primary at a time: the handshake
        refuses stale epochs, so after a promotion the revived old primary
        can feed no one."""
        self._lsock = socket.create_server((host, port))
        self._lsock.settimeout(0.5)
        self._accept_thread = threading.Thread(target=self._accept_loop, daemon=True,
                                               name="standby-listener")
        self._accept_thread.start()
        return self._lsock.getsockname()[1]

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _addr = self._lsock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            try:
                self._serve_conn(conn)
            except (OSError, ReplicationError, JournalError) as exc:
                log.info("replication feed dropped: %s", exc)
            finally:
                self.connected = False
                self._g_connected.set(0)
                conn.close()

    def _serve_conn(self, conn: socket.socket) -> None:
        if self.promoted:
            return  # serving now; the stale primary gets a closed socket
        conn.settimeout(10.0)
        _send_msg(conn, MSG_HELLO, json.dumps({
            "fingerprint": self.full_fingerprint,
            "replication_fingerprint": self.repl_fingerprint,
            "epoch": self.dm.journal.epoch,
            "applied_seq": self.dm.seq,
        }).encode())
        msg = _recv_msg(conn)
        if msg is None or msg[0] != MSG_HELLO:
            raise ReplicationError("primary did not send hello")
        hello = json.loads(msg[1])
        if hello.get("replication_fingerprint") != self.repl_fingerprint:
            raise ReplicationError(
                "primary geometry fingerprint does not match; refusing the feed"
            )
        if int(hello.get("epoch", 0)) < self.dm.journal.epoch:
            raise ReplicationError(
                f"primary is at journal epoch {hello.get('epoch', 0)} < this "
                f"replica's {self.dm.journal.epoch}: stale primary refused "
                "(split-brain guard)"
            )
        conn.settimeout(0.5)
        self.connected = True
        self._g_connected.set(1)
        while not self._stop.is_set() and not self.promoted:
            try:
                msg = _recv_msg(conn)
            except socket.timeout:
                continue
            if msg is None:
                return  # the primary went away cleanly (or was killed)
            mtype, payload = msg
            if mtype == MSG_CKPT:
                if len(payload) < 8:
                    raise ReplicationError("short checkpoint message")
                (seq,) = struct.unpack_from("<Q", payload)
                self._install_checkpoint(seq, payload[8:])
            elif mtype == MSG_FRAME:
                if len(payload) < _HEADER.size:
                    raise ReplicationError("short frame message")
                _magic, seq, _bl = _HEADER.unpack_from(payload, 0)
                self.apply_frame(seq, payload)
            else:
                raise ReplicationError(f"unknown message type {mtype}")

    # -- takeover -------------------------------------------------------

    def promote(self, primary_state_dir: str | None = None) -> dict:
        """Fenced takeover; returns the measured promotion record.

        1. Plant the fence in ``primary_state_dir`` (O_EXCL: one winner in
           a double-promote race) at the bumped epoch: from this instant
           the stale primary's appends raise.
        2. Drain the primary's durable journal tail off disk and apply it
           (RPO 0 for durable frames: the page cache survives a SIGKILL;
           only frames not yet fsynced when the *machine* crashed are
           lost, bounded by the primary's ``journal_fsync_every``).
        3. Complete a pending eviction flush as the recovery constructor
           does, so the promoted journal keeps the [round E, flush]
           adjacency an uninterrupted run writes.
        4. Wait for the device and re-anchor the admission bound on the
           promoted state, record the epoch locally, and serve.

        RTO is the wall time of 1-4 (the engine's programs are already
        warm: that is the point of a hot standby)."""
        t0 = time.monotonic()
        eng = self.engine
        with eng._lock:
            if self.promoted:
                raise ReplicationError("already promoted")
            new_epoch = self.dm.journal.epoch + 1
            drained = 0
            if primary_state_dir is not None:
                new_epoch = max(new_epoch, read_epoch(primary_state_dir) + 1)
                write_fence(primary_state_dir, epoch=new_epoch,
                            fingerprint=self.repl_fingerprint)
                latest = find_latest_checkpoint(primary_state_dir)
                if latest is not None and latest[0] > self.dm.seq:
                    # the standby fell behind the primary's prune horizon
                    # (disconnected across a checkpoint and roll): the
                    # sealed checkpoint is durable state, so RPO 0 holds —
                    # install it, then drain the frames past it. It encodes
                    # placement, so a cross-knob standby must have been fed
                    # without a break.
                    with open(latest[1], "rb") as fh:
                        blob = fh.read()
                    self._install_locked(latest[0], blob)
                reader = BatchJournal(primary_state_dir, self.dm.root_key, self.dm.ecfg)
                for seq, frame in reader.follow_frames(after_seq=self.dm.seq):
                    self._apply_locked(seq, frame)
                    drained += 1
            if eng.evict_every > 1:
                # the cadence counter from state, never a host mirror; then
                # complete a flush the dead primary journaled the rounds of
                # but never reached (a kill at the window's end)
                eng._rounds_since_flush = int(eng.state.rec.ebuf_rounds)
                if eng._rounds_since_flush >= eng.evict_every:
                    eng._flush_window_locked(min_rounds=eng.evict_every)
            # waits for every replayed round on the device, and restarts the
            # admission bound from the promoted state's exact values
            eng._read_bound_locked()
            self.dm.journal.sync()
            write_epoch(self.dm.dcfg.state_dir, new_epoch)
            self.dm.journal.epoch = new_epoch
            self.promoted = True
        rto = time.monotonic() - t0
        self._c_promotions.inc()
        self._g_epoch.set(new_epoch)
        self._g_rto.set(round(rto, 6))
        log.info("promoted to epoch %d: drained %d durable frames, rto %.3fs",
                 new_epoch, drained, rto)
        return {
            "epoch": new_epoch,
            "rto_seconds": rto,
            "drained_frames": drained,
            "applied_seq": self.dm.applied_seq,
            "rpo_durable_frames": 0,
        }

    # -- serving surface ------------------------------------------------

    def healthz(self) -> tuple[bool, dict]:
        """Standby liveness: healthy while fed, or once promoted. A
        disconnected standby that is not promoted is unhealthy: it is not
        providing the recovery it exists for."""
        detail = {
            "role": "standby",
            "promoted": self.promoted,
            "replication_connected": self.connected,
            "journal_epoch": self.dm.journal.epoch,
            "durability": self.dm.status(),
        }
        return (self.promoted or self.connected), detail

    def start_metrics(self, port: int = 0, host: str = "127.0.0.1") -> int:
        from ..obs import MetricsServer

        self._metrics_server = MetricsServer(self.registry, health=self.healthz,
                                             host=host, port=port)
        return self._metrics_server.start()

    def close(self) -> None:
        self._stop.set()
        if self._lsock is not None:
            self._lsock.close()
        if self._accept_thread is not None and self._accept_thread.is_alive():
            self._accept_thread.join(timeout=5.0)
        if self._metrics_server is not None:
            self._metrics_server.stop()
            self._metrics_server = None
        self.engine.close()
