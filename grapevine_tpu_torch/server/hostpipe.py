"""Multiprocess verify/codec worker pool: the off-GIL host pipeline (a copy
of ``grapevine_tpu/server/hostpipe.py``).

The host path parallelizes (the reference measured ~130 µs of verify +
AEAD + codec per op on one core), but in-process everything runs
under one GIL: the pure-Python AEAD/poly1305 work, challenge draws,
request unpack/validate, and the signature MSM's module-locked native
calls all serialized behind each other. This module moves that work to
a pool of worker *processes* (one Python runtime each — real cores, no
GIL sharing) while keeping every protocol invariant:

- **Sticky sessions.** A session's cipher states are *stateful*
  (directional AEAD counters, lockstep challenge RNG), so a channel's
  frames must always land on the same worker. Routing is the public
  function ``sha256(channel_id) % workers`` — many channels share one
  worker and the worker index reveals nothing a passive observer of the
  channel_id (which travels in the clear) could not already compute.
- **Auth-first semantics preserved.** The worker decrypts before
  drawing a challenge, exactly like the in-process path: an injected
  envelope fails AEAD without consuming a challenge or advancing any
  cipher state (service.py's injection-DoS note).
- **Crash = session loss, loudly.** A worker that dies takes its cipher
  states with it. The pool fails the dead worker's in-flight tasks,
  bumps the worker's epoch (so stale sessions can never resume on a
  respawned worker), notifies crash listeners (GrapevineServer drops
  the affected sessions — clients re-auth), increments
  ``grapevine_host_worker_crash_total``, and — under the same
  ``restart_on_crash`` policy as the batch collector — respawns
  a fresh worker. ``alive()`` folds into /healthz either way.
- **torch-free workers.** Workers are started from a forkserver/spawn
  context and import only the session/wire layers (the stdlib crypto
  backend, the ctypes native library, the pure-Python codec) — never
  the engine, ``torch`` or CUDA, so worker boot costs milliseconds, not
  a device runtime. The forkserver preloads this module only (never the
  parent's ``__main__``, which may import ``torch``); a worker still
  re-imports a ``__main__`` given as a file path, so a server process
  started as ``python -m grapevine_tpu_torch.server.cli`` (whose module
  imports no ``torch`` at the top) keeps its workers torch-free.

Telemetry: the ``grapevine_host_*`` families registered here are
label-free or declared-values-only (task kind under the ``phase`` key,
worker index under the integer-only ``worker`` key — a topology
position, never a channel identity; obs/registry.py)."""

from __future__ import annotations

import hashlib
import logging
import multiprocessing
import os
import threading
from concurrent.futures import Future, TimeoutError as _FutureTimeout

log = logging.getLogger("grapevine_tpu_torch.hostpipe")

#: task kinds — the declared `phase` label values for
#: grapevine_host_tasks_total (anything else is a registration error)
TASK_KINDS = ("attach", "detach", "open", "seal", "verify", "ping")

#: default cap on waiting for one worker task; a worker wedged past
#: this is indistinguishable from dead for the caller
DEFAULT_TIMEOUT_S = 30.0


class HostPipeError(RuntimeError):
    """Base for pool failures."""


class HostWorkerCrash(HostPipeError):
    """The sticky worker died; its sessions are unrecoverable."""


class HostAuthError(HostPipeError):
    """AEAD/authentication failure inside a worker (maps to
    UNAUTHENTICATED; no cipher state was advanced)."""


class HostInvalidRequest(HostPipeError):
    """Malformed/invalid request decoded inside a worker (maps to
    INVALID_ARGUMENT; the challenge WAS consumed, like in-process)."""


class _Categorized(Exception):
    """Worker-side error with a wire category the main side maps back
    to the exception classes above."""

    def __init__(self, category: str, message: str):
        super().__init__(message)
        self.category = category
        self.message = message


_ERROR_CLASSES = {
    "auth": HostAuthError,
    "invalid": HostInvalidRequest,
    "error": HostPipeError,
}


def _worker_main(conn) -> None:
    """Worker process body: a FIFO task loop over one duplex pipe.

    Imports stay inside the function (and torch-free — see module
    docstring): the session channel layer picks its crypto backend
    per-process, the signature scheme loads the cached native .so."""
    from ..session import get_signature_scheme
    from ..session.chacha import ChallengeRng
    from ..session.channel import SecureChannel
    from ..wire.records import QueryRequest
    from ..wire.validate import HardProtocolError, validate_request

    sessions: dict[bytes, tuple] = {}
    schemes: dict[str, object] = {}
    while True:
        try:
            tid, kind, payload = conn.recv()
        except (EOFError, OSError):
            return
        try:
            if kind == "open":
                cid, ciphertext, aad = payload
                sess = sessions.get(cid)
                if sess is None:
                    raise _Categorized("auth", "unknown channel on worker")
                channel, rng = sess
                try:
                    plaintext = channel.decrypt(ciphertext, aad=aad)
                except Exception:
                    # recv counter did not advance (SecureChannel raises
                    # before incrementing) — same injection-DoS immunity
                    # as the in-process path
                    raise _Categorized("auth", "decryption failed") from None
                challenge = rng.next_challenge()
                try:
                    req = QueryRequest.unpack(plaintext)
                    validate_request(req)
                except (ValueError, HardProtocolError) as exc:
                    raise _Categorized("invalid", str(exc)) from None
                result = (req, challenge)
            elif kind == "seal":
                cid, plaintext = payload
                sess = sessions.get(cid)
                if sess is None:
                    raise _Categorized("auth", "unknown channel on worker")
                result = sess[0].encrypt(plaintext)
            elif kind == "attach":
                cid, send_key, recv_key, send_n, recv_n, seed = payload
                channel = SecureChannel(send_key, recv_key)
                channel._send_n = send_n
                channel._recv_n = recv_n
                sessions[cid] = (channel, ChallengeRng(seed))
                result = len(sessions)
            elif kind == "detach":
                sessions.pop(payload, None)
                result = len(sessions)
            elif kind == "verify":
                scheme_name, items = payload
                mod = schemes.get(scheme_name)
                if mod is None:
                    mod = schemes[scheme_name] = get_signature_scheme(
                        scheme_name
                    )
                result = bool(mod.batch_verify(items))
            elif kind == "ping":
                result = os.getpid()
            elif kind == "exit":
                conn.send((tid, True, None))
                return
            else:
                raise _Categorized("error", f"unknown task kind {kind!r}")
            conn.send((tid, True, result))
        except _Categorized as exc:
            conn.send((tid, False, (exc.category, exc.message)))
        except Exception as exc:  # never let one bad task kill the loop
            conn.send((tid, False, ("error", f"{type(exc).__name__}: {exc}")))


class _WorkerSlot:
    """Main-side bookkeeping for one worker process."""

    __slots__ = (
        "index", "process", "conn", "send_lock", "futures", "futures_lock",
        "epoch", "alive", "reader",
    )

    def __init__(self, index: int):
        self.index = index
        self.process = None
        self.conn = None
        self.send_lock = threading.Lock()
        self.futures: dict[int, Future] = {}
        self.futures_lock = threading.Lock()
        self.epoch = 0
        self.alive = False
        self.reader = None


def _mp_context():
    # forkserver: workers fork from a clean helper process — no torch, no
    # CUDA context, no grpc threads, no re-import of heavy parents per
    # worker. spawn is the portable fallback (each worker boots a fresh
    # interpreter).
    try:
        ctx = multiprocessing.get_context("forkserver")
    except ValueError:  # pragma: no cover - non-POSIX fallback
        return multiprocessing.get_context("spawn")
    # the forkserver's default preload is the parent's __main__, which
    # may import torch; preload only this module (effective when this
    # process starts its forkserver)
    ctx.set_forkserver_preload([__name__])
    return ctx


class HostPipeline:
    """The worker pool: sticky session routing + task fan-out.

    ``registry`` (an obs.TelemetryRegistry) is optional; when given, the
    ``grapevine_host_*`` families register there. ``on_crash`` listeners
    receive the dead worker's index *before* any respawn — the session
    owner must drop sessions stuck to that worker (their cipher states
    died with the process)."""

    def __init__(
        self,
        workers: int,
        *,
        scheme: str = "schnorrkel",
        restart_on_crash: bool = False,
        registry=None,
        timeout_s: float = DEFAULT_TIMEOUT_S,
    ):
        if workers < 1:
            raise ValueError(f"host pipeline needs >= 1 worker, got {workers}")
        self.workers = int(workers)
        self.scheme_name = scheme
        self.restart_on_crash = restart_on_crash
        self.timeout_s = timeout_s
        self._ctx = _mp_context()
        self._task_seq = 0
        self._seq_lock = threading.Lock()
        self._closing = False
        self._crash_listeners: list = []
        self.crash_count = 0
        self._g_workers = self._g_alive = self._g_inflight = None
        self._c_tasks = self._c_crash = None
        if registry is not None:
            widx = tuple(str(i) for i in range(self.workers))
            self._g_workers = registry.gauge(
                "grapevine_host_workers",
                "configured hostpipe worker-pool size",
            )
            self._g_alive = registry.gauge(
                "grapevine_host_workers_alive",
                "hostpipe workers currently alive",
            )
            self._g_inflight = registry.gauge(
                "grapevine_host_inflight_tasks",
                "hostpipe tasks submitted and not yet settled",
            )
            self._c_tasks = registry.counter(
                "grapevine_host_tasks_total",
                "hostpipe tasks by kind and worker index",
                labels={"phase": TASK_KINDS, "worker": widx},
            )
            self._c_crash = registry.counter(
                "grapevine_host_worker_crash_total",
                "hostpipe worker processes that died unexpectedly",
                labels={"worker": widx},
            )
            self._g_workers.set(self.workers)
        self._slots = [_WorkerSlot(i) for i in range(self.workers)]
        for slot in self._slots:
            self._start_worker(slot)
        self._set_alive_gauge()

    # -- lifecycle -------------------------------------------------------

    def _start_worker(self, slot: _WorkerSlot) -> None:
        parent_conn, child_conn = self._ctx.Pipe(duplex=True)
        proc = self._ctx.Process(
            target=_worker_main,
            args=(child_conn,),
            name=f"grapevine-hostpipe-{slot.index}",
            daemon=True,
        )
        proc.start()
        child_conn.close()
        slot.process = proc
        slot.conn = parent_conn
        slot.alive = True
        slot.reader = threading.Thread(
            target=self._read_loop,
            args=(slot, parent_conn),
            name=f"hostpipe-reader-{slot.index}",
            daemon=True,
        )
        slot.reader.start()

    def _read_loop(self, slot: _WorkerSlot, conn) -> None:
        while True:
            try:
                tid, ok, result = conn.recv()
            except (EOFError, OSError):
                break
            except TypeError:
                # close() nulled the handle mid-recv (teardown race)
                break
            with slot.futures_lock:
                fut = slot.futures.pop(tid, None)
            if self._g_inflight is not None:
                self._g_inflight.inc(-1)
            if fut is None:
                continue
            if ok:
                fut.set_result(result)
            else:
                category, message = result
                cls = _ERROR_CLASSES.get(category, HostPipeError)
                fut.set_exception(cls(message))
        self._on_worker_exit(slot, conn)

    def _on_worker_exit(self, slot: _WorkerSlot, conn) -> None:
        if self._closing:
            return
        slot.alive = False
        slot.epoch += 1
        self.crash_count += 1
        with slot.futures_lock:
            orphans = list(slot.futures.values())
            slot.futures.clear()
        for fut in orphans:
            fut.set_exception(
                HostWorkerCrash(f"hostpipe worker {slot.index} died")
            )
        if self._g_inflight is not None and orphans:
            self._g_inflight.inc(-len(orphans))
        if self._c_crash is not None:
            self._c_crash.inc(worker=str(slot.index))
        log.warning(
            "hostpipe worker %d died (%d in-flight tasks failed)%s",
            slot.index, len(orphans),
            "; restarting" if self.restart_on_crash else "",
        )
        # listeners first: sessions stuck to this worker must be dropped
        # before a respawned worker could be handed new ones
        for listener in list(self._crash_listeners):
            try:
                listener(slot.index)
            except Exception:  # pragma: no cover - listener bug
                log.exception("hostpipe crash listener failed")
        if self.restart_on_crash:
            try:
                self._start_worker(slot)
            except Exception:  # pragma: no cover - spawn failure
                log.exception("hostpipe worker %d respawn failed", slot.index)
        self._set_alive_gauge()

    def _set_alive_gauge(self) -> None:
        if self._g_alive is not None:
            self._g_alive.set(self.alive_count())

    def close(self) -> None:
        self._closing = True
        for slot in self._slots:
            if slot.process is None:
                continue
            try:
                with slot.send_lock:
                    slot.conn.send((-1, "exit", None))
            except (OSError, ValueError):
                pass
        for slot in self._slots:
            if slot.process is None:
                continue
            slot.process.join(timeout=2.0)
            if slot.process.is_alive():  # pragma: no cover - wedged worker
                slot.process.kill()
                slot.process.join(timeout=2.0)
            try:
                slot.conn.close()
            except OSError:  # pragma: no cover
                pass
            slot.alive = False

    # -- introspection ---------------------------------------------------

    def alive_count(self) -> int:
        return sum(
            1
            for s in self._slots
            if s.alive and s.process is not None and s.process.is_alive()
        )

    def alive(self) -> bool:
        """Every configured worker is serving (healthz contract: a
        degraded pool without restart_on_crash must flip unhealthy, the
        same stance as the batch collector's worker_alive)."""
        return self.alive_count() == self.workers

    def on_crash(self, listener) -> None:
        self._crash_listeners.append(listener)

    def worker_for(self, channel_id: bytes) -> int:
        """The public sticky-routing function (stable across restarts)."""
        digest = hashlib.sha256(channel_id).digest()
        return int.from_bytes(digest[:8], "big") % self.workers

    def epoch_of(self, index: int) -> int:
        return self._slots[index].epoch

    # -- task submission -------------------------------------------------

    def _route(self, sticky: bytes | None) -> _WorkerSlot:
        if sticky is not None:
            return self._slots[self.worker_for(sticky)]
        live = [s for s in self._slots if s.alive]
        if not live:
            raise HostWorkerCrash("no live hostpipe workers")
        return min(live, key=lambda s: len(s.futures))

    def submit(self, kind: str, payload, *, sticky: bytes | None = None) -> Future:
        if self._closing:
            raise HostPipeError("host pipeline is closed")
        slot = self._route(sticky)
        if not slot.alive:
            raise HostWorkerCrash(
                f"hostpipe worker {slot.index} is dead (sticky session lost)"
            )
        with self._seq_lock:
            self._task_seq += 1
            tid = self._task_seq
        fut: Future = Future()
        with slot.futures_lock:
            slot.futures[tid] = fut
        try:
            with slot.send_lock:
                slot.conn.send((tid, kind, payload))
        except (OSError, ValueError):
            with slot.futures_lock:
                slot.futures.pop(tid, None)
            raise HostWorkerCrash(
                f"hostpipe worker {slot.index} pipe is closed"
            ) from None
        if self._g_inflight is not None:
            self._g_inflight.inc(1)
        if self._c_tasks is not None:
            self._c_tasks.inc(phase=kind, worker=str(slot.index))
        return fut

    def call(self, kind: str, payload, *, sticky: bytes | None = None,
             timeout: float | None = None):
        fut = self.submit(kind, payload, sticky=sticky)
        try:
            return fut.result(
                timeout=self.timeout_s if timeout is None else timeout
            )
        except _FutureTimeout:
            # a wedged worker is indistinguishable from a dead one for
            # this caller; surface the pool's own error type so the
            # status-code mapping in service.py stays exhaustive
            raise HostPipeError(
                f"hostpipe {kind} task timed out after "
                f"{self.timeout_s if timeout is None else timeout:.1f}s"
            ) from None

    # -- session-shaped conveniences (GrapevineServer's surface) ---------

    def attach_session(self, channel_id: bytes, secure_channel,
                       challenge_seed: bytes) -> tuple[int, int]:
        """Hand a freshly authenticated session to its sticky worker;
        returns (worker_index, worker_epoch) for crash invalidation."""
        send_key, recv_key, send_n, recv_n = secure_channel.export_keys()
        index = self.worker_for(channel_id)
        self.call(
            "attach",
            (channel_id, send_key, recv_key, send_n, recv_n, challenge_seed),
            sticky=channel_id,
        )
        return index, self._slots[index].epoch

    def detach_session(self, channel_id: bytes) -> None:
        try:
            self.submit("detach", channel_id, sticky=channel_id)
        except HostPipeError:
            pass  # dead worker already forgot it

    def open_request(self, channel_id: bytes, ciphertext: bytes, aad: bytes):
        """Decrypt + challenge-draw + unpack + validate on the sticky
        worker; returns (QueryRequest, challenge)."""
        return self.call(
            "open", (channel_id, ciphertext, aad), sticky=channel_id
        )

    def seal_response(self, channel_id: bytes, plaintext: bytes) -> bytes:
        return self.call("seal", (channel_id, plaintext), sticky=channel_id)

    def verify_parallel(self, items, chunks: int | None = None) -> bool:
        """Fan a batch-verify across the pool; True iff every chunk
        verifies (the scheduler bisects inline on False — failure is the
        attacker-funded path, parallelism optimizes the honest one)."""
        if not items:
            return True
        n = min(chunks or self.workers, len(items))
        if n <= 1:
            return bool(self.call("verify", (self.scheme_name, list(items))))
        step = (len(items) + n - 1) // n
        futs = [
            self.submit("verify", (self.scheme_name, items[i : i + step]))
            for i in range(0, len(items), step)
        ]
        ok = True
        for fut in futs:
            try:
                ok = bool(fut.result(timeout=self.timeout_s)) and ok
            except _FutureTimeout:
                raise HostPipeError(
                    "hostpipe verify task timed out"
                ) from None
        return ok
