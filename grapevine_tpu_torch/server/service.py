"""gRPC frontend: the GrapevineAPI service (Auth, Query); a copy of
``grapevine_tpu/server/service.py`` over the port's engine.

Faithful to the reference service shape (grapevine.proto:10-15): ``Auth``
performs the key exchange and returns the handshake reply plus the
encrypted 32-byte challenge seed (AuthMessageWithChallengeSeed,
grapevine.proto:26-36); ``Query`` carries only encrypted constant-size
blobs. Implemented with grpc's generic handlers and the hand-rolled
protowire codec — no protoc build step.

Per-request auth (reference README.md:187-199): the server advances the
session's challenge RNG on every *authenticated* Query (lockstep,
README.md:195-196; the AEAD decrypt proves channel ownership before a
challenge is consumed), verifies the Schnorr signature over the challenge
under context ``b"grapevine-challenge"``, and fails fast with
INVALID_ARGUMENT on bad signatures or malformed requests (the reference's
hard-error behavior, grapevine.proto:57-64).

The engine runs on the CUDA card unless the caller passes
``device="cpu"`` (and raises without a card, as the facade does). The
device owner attaches the reference's round observability
(``obs.attach_round_observability``: round tracer, commit-latency SLO,
workload and cost telemetry, and with ``profile_enable`` the profiler
gate), with ``leakmon`` the transcript leak monitor, and with
``adaptive_batch`` the scheduler's adaptive window;
``replicate_to`` ships the durable engine's journal to a hot standby
(``engine/replication.py``).
"""

from __future__ import annotations

import logging
import os
import threading
import time
from concurrent import futures

import grpc

from ..config import GrapevineConfig

# the channel layer selects its backend itself: the cryptography wheel
# when present, else the stdlib port (session/stdcrypto.py) — this
# import succeeds in every container
from ..session import channel as chan
from ..session.chacha import ChallengeRng
from ..wire import constants as C
from ..wire import protowire as pw
from ..wire.records import QueryRequest
from ..wire.validate import HardProtocolError, validate_request
from .scheduler import AuthFailure, BatchScheduler, SchedulerShutdown

log = logging.getLogger("grapevine_tpu_torch.server")

from .uri import SERVICE_NAME  # noqa: E402  (re-export, see uri.py)


#: bytes appended to the challenge seed inside the Auth ciphertext: the
#: server-assigned session token the client must present as channel_id.
SESSION_TOKEN_SIZE = 16


#: seconds past its grace a stopping gRPC server, and then its handler
#: pool, may take before the stop returns regardless
STOP_SLACK_S = 5.0


def grpc_server(workers: int):
    """A gRPC server and the thread pool that runs its handlers."""
    pool = futures.ThreadPoolExecutor(max_workers=workers, thread_name_prefix="grapevine-rpc")
    return grpc.server(pool), pool


def stop_grpc(server, pool, grace: float) -> None:
    """Stop ``server`` (calls still running after ``grace`` are cancelled),
    then its handler pool, each wait bounded. The pool's threads end here,
    not at interpreter exit, where ``concurrent.futures`` joins every pool
    thread without a timeout; a handler still running past the slack is
    logged by name, since that join would wait for it."""
    server.stop(grace).wait(grace + STOP_SLACK_S)
    pool.shutdown(wait=False, cancel_futures=True)
    deadline = time.monotonic() + STOP_SLACK_S
    for t in list(getattr(pool, "_threads", ())):
        t.join(timeout=max(0.0, deadline - time.monotonic()))
        if t.is_alive():
            log.warning("gRPC handler thread %s still running after stop", t.name)


def run_expiry_loop(engine, config, stop_event, clock, health=None):
    """The expiry-sweep loop, shared by the monolithic server and the
    engine tier (server/tier.py) — whoever owns the device owns this."""
    interval = max(1.0, config.expiry_period / 10)
    while not stop_event.wait(interval):
        evicted = engine.expire(clock())
        if evicted:
            log.info("expiry sweep evicted %d records", evicted)
        # health() syncs the device (stash sampling) — only pay that
        # when someone is listening at DEBUG
        if log.isEnabledFor(logging.DEBUG):
            log.debug("health %s", (health or engine.health)())


class _Session:
    __slots__ = ("channel", "challenge_rng", "created", "last_used", "lock",
                 "worker", "worker_epoch")

    def __init__(self, secure_channel: chan.SecureChannel, seed: bytes):
        self.channel = secure_channel
        self.challenge_rng = ChallengeRng(seed)
        self.created = time.time()
        self.last_used = self.created
        self.lock = threading.Lock()
        #: hostpipe sticky worker (index, epoch-at-attach) when the
        #: session's cipher states live in a worker process; None = the
        #: in-process path. A crashed worker bumps its epoch, so a stale
        #: session can never resume against a respawned worker's empty
        #: session map with desynced counters.
        self.worker: int | None = None
        self.worker_epoch = 0


class GrapevineServer:
    """The host server: session registry + engine + expiry timer."""

    def __init__(
        self,
        config: GrapevineConfig | None = None,
        seed: int = 0,
        max_wait_ms: float | None = None,
        attestation=None,
        clock=None,
        session_ttl: float = 3600.0,
        max_sessions: int = 4096,
        identity: chan.ServerIdentity | None = None,
        scheduler=None,
        leakmon=None,
        durability=None,
        worker_restart: bool = False,
        trace_ring_size: int = 512,
        slo=None,
        profile_enable: bool = False,
        replicate_to: str | None = None,
        ship_every: int = 1,
        host_workers: int = 0,
        adaptive_batch: bool = False,
        flush_window_ms: float | None = None,
        device=None,
    ):
        self.config = config or GrapevineConfig()
        if scheduler is not None and replicate_to is not None:
            raise ValueError(
                "replication needs the journal in-process (the frontend "
                "role has no journal to ship)"
            )
        if scheduler is not None:
            # injected op sink (server/tier.py's FrontendServer passes
            # its engine-tier RPC stub): no in-process device engine
            if durability is not None:
                raise ValueError(
                    "durability needs the device engine in-process (the "
                    "frontend role has no state to checkpoint)"
                )
            if adaptive_batch or flush_window_ms:
                raise ValueError(
                    "adaptive/flush-aware batching shapes the device "
                    "round collection window — only the engine owner "
                    "has one (the frontend forwards ops unbatched)"
                )
            self.engine = None
            self.scheduler = scheduler
        else:
            from ..engine.batcher import GrapevineEngine

            # constructing a durable engine runs recovery (checkpoint
            # load + journal replay) before the listener ever binds;
            # device=None is the card (raises without one)
            self.engine = GrapevineEngine(
                self.config, seed=seed, device=device, durability=durability
            )
            sched_kwargs = (
                {} if max_wait_ms is None else {"max_wait_ms": max_wait_ms}
            )
            from ..session import get_signature_scheme

            self.scheduler = BatchScheduler(
                self.engine,
                clock=clock,
                scheme=get_signature_scheme(self.config.signature_scheme),
                restart_on_crash=worker_restart,
                flush_window_ms=flush_window_ms,
                **sched_kwargs,
            )
        self.attestation = attestation or chan.NullAttestation()
        #: IX responder static; ``server.identity.public`` is what
        #: clients pin via ``expected_server_static`` (SECURITY.md)
        self.identity = identity or chan.ServerIdentity.generate()
        self._sessions: dict[bytes, _Session] = {}
        self._sessions_lock = threading.Lock()
        self.session_ttl = session_ttl
        self.max_sessions = max_sessions
        self._grpc_server: grpc.Server | None = None
        self._expiry_stop = threading.Event()
        self._expiry_thread: threading.Thread | None = None
        self.clock = clock or (lambda: int(time.time()))
        #: one merged telemetry namespace: the engine's registry when we
        #: own a device engine, a standalone one in the injected-
        #: scheduler (frontend) role — either way /metrics serves engine
        #: + scheduler + session telemetry from a single registry
        if self.engine is not None:
            self.metrics_registry = self.engine.metrics.registry
        else:
            from ..obs import TelemetryRegistry

            self.metrics_registry = TelemetryRegistry()
        self._g_sessions = self.metrics_registry.gauge(
            "grapevine_sessions", "live authenticated sessions"
        )
        #: multiprocess verify/codec pipeline (server/hostpipe.py):
        #: 0 = the historical in-process path, N = a pool of N worker
        #: processes holding the session cipher states sticky by
        #: channel_id. Crash policy rides worker_restart, like the
        #: batch collector.
        self.hostpipe = None
        if host_workers:
            from .hostpipe import HostPipeline

            self.hostpipe = HostPipeline(
                host_workers,
                scheme=self.config.signature_scheme,
                restart_on_crash=worker_restart,
                registry=self.metrics_registry,
            )
            self.hostpipe.on_crash(self._drop_worker_sessions)
            if self.engine is not None:
                # scheduler-side verify fan-out shares the same pool
                self.scheduler.hostpipe = self.hostpipe
        self._metrics_server = None
        #: continuous obliviousness auditing (obs/leakmon.py): pass a
        #: LeakMonitorConfig to watch every round's transcript. Device
        #: owner only — the frontend role never sees a transcript.
        self.leakmon = None
        if leakmon is not None:
            if self.engine is None:
                raise ValueError(
                    "leak monitoring needs the device engine in-process "
                    "(the frontend role has no transcript to audit)"
                )
            from ..obs.leakmon import EngineLeakMonitor

            self.leakmon = EngineLeakMonitor.for_engine(self.engine, leakmon)
            self.engine.attach_leakmon(self.leakmon)
        #: primary-side journal shipping (engine/replication.py): stream
        #: every sealed frame to a hot standby. Device owner only: the
        #: frontend role has no journal.
        self.shipper = None
        if replicate_to is not None:
            from ..engine.replication import JournalShipper

            self.shipper = JournalShipper(self.engine, replicate_to,
                                          ship_every=ship_every)
            self.shipper.start()
            if self.leakmon is not None:
                # fold the shipper's frame-length books into the audit
                # verdict (ship_cadence detector, obs/leakmon.py)
                self.leakmon.attach_shipper(self.shipper)
        #: round tracer + commit-latency SLO + optional capture gate —
        #: one shared attach policy (obs.attach_round_observability has
        #: the rationale and the observe-only default contract)
        self.tracer = self.slo = self.profiler = None
        if self.engine is not None:
            from ..obs import attach_round_observability

            self.tracer, self.slo, self.profiler = attach_round_observability(
                self.engine, self.metrics_registry,
                trace_ring_size=trace_ring_size, slo=slo,
                profile_enable=profile_enable,
            )
            if adaptive_batch:
                # SLO-adaptive window sizing (server/adaptive.py has the
                # policy and its obliviousness argument), planted after
                # observability attaches so the policy reads the same
                # arrival EWMA and burn rates /metrics exports
                from .adaptive import AdaptiveBatchPolicy

                self.scheduler.adaptive = AdaptiveBatchPolicy(
                    self.engine.ecfg.batch_size,
                    self.scheduler.max_wait,
                    self.scheduler.idle_gap,
                    workload=self.engine.workload,
                    slo=self.slo,
                    registry=self.metrics_registry,
                )

    # -- RPC handlers (raw-bytes serializers) ---------------------------

    def _auth(self, request_bytes: bytes, context: grpc.ServicerContext) -> bytes:
        try:
            auth_msg = pw.decode_auth_message(request_bytes)
            reply, secure_channel = chan.server_handshake(
                auth_msg.data, self.attestation, identity=self.identity
            )
        except ValueError as exc:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, f"handshake: {exc}")
        seed = chan.new_challenge_seed()
        # the channel id is a server-assigned random token, delivered only
        # inside the authenticated ciphertext: unguessable, unforgeable,
        # and immune to session-clobbering via a replayed client pubkey
        token = os.urandom(SESSION_TOKEN_SIZE)
        encrypted_seed = secure_channel.encrypt(seed + token)
        session = _Session(secure_channel, seed)
        if self.hostpipe is not None:
            from .hostpipe import HostPipeError

            # hand the cipher states (counters included: send_n is 1
            # after the seed ciphertext above) to the sticky worker
            # BEFORE the client can learn the token from our reply
            try:
                session.worker, session.worker_epoch = (
                    self.hostpipe.attach_session(token, secure_channel, seed)
                )
            except HostPipeError as exc:
                context.abort(
                    grpc.StatusCode.UNAVAILABLE, f"host pipeline: {exc}"
                )
        with self._sessions_lock:
            self._evict_sessions_locked()
            self._sessions[token] = session
            self._g_sessions.set(len(self._sessions))
        return pw.encode_auth_with_seed(
            pw.AuthMessageWithChallengeSeed(
                auth_message=pw.AuthMessage(data=reply),
                encrypted_challenge_seed=encrypted_seed,
            )
        )

    def _evict_sessions_locked(self):
        """Drop idle sessions past the TTL; at the cap, drop the oldest."""
        now = time.time()
        if self.session_ttl > 0:
            dead = [k for k, s in self._sessions.items() if now - s.last_used > self.session_ttl]
            for k in dead:
                self._forget_session_locked(k)
        while len(self._sessions) >= self.max_sessions:
            oldest = min(self._sessions, key=lambda k: self._sessions[k].last_used)
            self._forget_session_locked(oldest)

    def _forget_session_locked(self, token: bytes):
        session = self._sessions.pop(token, None)
        if (
            session is not None
            and session.worker is not None
            and self.hostpipe is not None
        ):
            # fire-and-forget: the worker's copy of the cipher state is
            # garbage once the registry forgets the token
            self.hostpipe.detach_session(token)

    def _drop_worker_sessions(self, worker_index: int):
        """hostpipe crash listener: every session stuck to the dead
        worker lost its cipher states — drop them so clients get a
        clean UNAUTHENTICATED and re-auth, instead of a decrypt loop
        against a respawned worker that never knew them."""
        with self._sessions_lock:
            dead = [
                k for k, s in self._sessions.items()
                if s.worker == worker_index
            ]
            for k in dead:
                del self._sessions[k]
            self._g_sessions.set(len(self._sessions))
        if dead:
            log.warning(
                "dropped %d sessions stuck to dead hostpipe worker %d",
                len(dead), worker_index,
            )

    def _query(self, request_bytes: bytes, context: grpc.ServicerContext) -> bytes:
        try:
            envelope = pw.decode_envelope(request_bytes)
        except ValueError as exc:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, f"malformed envelope: {exc}")
        now = time.time()
        with self._sessions_lock:
            session = self._sessions.get(envelope.channel_id)
            # enforce the TTL at use time too: a quiet server (no Auth
            # traffic) must not serve — or retain — idle-expired sessions
            if (
                session is not None
                and self.session_ttl > 0
                and now - session.last_used > self.session_ttl
            ):
                self._forget_session_locked(envelope.channel_id)
                self._g_sessions.set(len(self._sessions))
                session = None
        if session is None:
            context.abort(grpc.StatusCode.UNAUTHENTICATED, "unknown channel")
        if session.worker is not None:
            return self._query_hostpipe(envelope, session, now, context)
        with session.lock:
            # AEAD authentication FIRST: a replayed or injected envelope
            # (channel_id travels in the clear) must fail here without
            # consuming a challenge or advancing any cipher state —
            # otherwise one injected Query permanently desyncs the
            # legitimate client's lockstep (an injection-DoS the
            # reference never faced behind TLS). The channel's recv
            # counter likewise only advances on successful decryption.
            try:
                plaintext = session.channel.decrypt(envelope.data, aad=envelope.aad)
            except Exception:
                context.abort(grpc.StatusCode.UNAUTHENTICATED, "decryption failed")
            # lockstep: the sender has proven channel ownership; draw
            # their challenge (client drew the same one before signing).
            # Only now refresh the idle timestamp — unauthenticated
            # garbage must not keep a session alive past its TTL or pin
            # it against LRU eviction
            challenge = session.challenge_rng.next_challenge()
            session.last_used = now
            try:
                req = QueryRequest.unpack(plaintext)
                validate_request(req)
            except (ValueError, HardProtocolError) as exc:
                context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(exc))
            # signature checked inside the round's batch verification
            # (scheduler.py: one multi-scalar multiplication per round)
            try:
                resp = self.scheduler.submit(
                    req,
                    auth=(
                        req.auth_identity,
                        C.GRAPEVINE_CHALLENGE_SIGNING_CONTEXT,
                        challenge,
                        req.auth_signature,
                    ),
                )
            except AuthFailure:
                context.abort(grpc.StatusCode.UNAUTHENTICATED, "bad challenge signature")
            except SchedulerShutdown as exc:
                # the drain path's explicit settle: the op never reached
                # the device — UNAVAILABLE tells the client to retry
                # against a serving replica
                context.abort(grpc.StatusCode.UNAVAILABLE, str(exc))
            ciphertext = session.channel.encrypt(resp.pack())
        return pw.encode_envelope(pw.EnvelopeMessage(data=ciphertext))

    def _query_hostpipe(self, envelope, session, now, context) -> bytes:
        """The multiprocess Query path: AEAD open, challenge draw,
        unpack/validate, and the response seal all run on the session's
        sticky hostpipe worker — same semantics as the inline path in
        :meth:`_query` (auth-first, lockstep, fail-fast), same status
        codes, but the GIL-bound work is off this process."""
        from .hostpipe import (
            HostAuthError,
            HostInvalidRequest,
            HostPipeError,
        )

        pipe = self.hostpipe
        token = envelope.channel_id
        with session.lock:
            if pipe.epoch_of(session.worker) != session.worker_epoch:
                # the sticky worker died after this session was looked
                # up (the crash listener races this request): its cipher
                # states are gone — drop and force a re-auth
                with self._sessions_lock:
                    self._sessions.pop(token, None)
                    self._g_sessions.set(len(self._sessions))
                context.abort(
                    grpc.StatusCode.UNAUTHENTICATED,
                    "session lost to a host worker restart",
                )
            try:
                req, challenge = pipe.open_request(
                    token, envelope.data, envelope.aad
                )
            except HostAuthError:
                context.abort(
                    grpc.StatusCode.UNAUTHENTICATED, "decryption failed"
                )
            except HostInvalidRequest as exc:
                context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(exc))
            except HostPipeError:
                with self._sessions_lock:
                    self._forget_session_locked(token)
                    self._g_sessions.set(len(self._sessions))
                context.abort(
                    grpc.StatusCode.UNAVAILABLE,
                    "host worker lost; re-authenticate",
                )
            session.last_used = now
            try:
                resp = self.scheduler.submit(
                    req,
                    auth=(
                        req.auth_identity,
                        C.GRAPEVINE_CHALLENGE_SIGNING_CONTEXT,
                        challenge,
                        req.auth_signature,
                    ),
                )
            except AuthFailure:
                context.abort(
                    grpc.StatusCode.UNAUTHENTICATED, "bad challenge signature"
                )
            except SchedulerShutdown as exc:
                context.abort(grpc.StatusCode.UNAVAILABLE, str(exc))
            try:
                ciphertext = pipe.seal_response(token, resp.pack())
            except HostPipeError:
                with self._sessions_lock:
                    self._forget_session_locked(token)
                    self._g_sessions.set(len(self._sessions))
                context.abort(
                    grpc.StatusCode.UNAVAILABLE,
                    "host worker lost; re-authenticate",
                )
        return pw.encode_envelope(pw.EnvelopeMessage(data=ciphertext))

    # -- lifecycle ------------------------------------------------------

    def _handlers(self) -> grpc.GenericRpcHandler:
        identity = lambda b: b  # noqa: E731 — raw bytes on the wire
        method_handlers = {
            "Auth": grpc.unary_unary_rpc_method_handler(
                self._auth, request_deserializer=identity, response_serializer=identity
            ),
            "Query": grpc.unary_unary_rpc_method_handler(
                self._query, request_deserializer=identity, response_serializer=identity
            ),
        }
        return grpc.method_handlers_generic_handler(SERVICE_NAME, method_handlers)

    def start(self, listen_uri, tls_cert: bytes | None = None, tls_key: bytes | None = None) -> int:
        """Start serving; returns the bound port."""
        from .uri import GrapevineUri

        uri = (
            listen_uri
            if isinstance(listen_uri, GrapevineUri)
            else GrapevineUri.parse(listen_uri)
        )
        self._grpc_server, self._grpc_pool = grpc_server(max(8, 2 * self.config.batch_size))
        self._grpc_server.add_generic_rpc_handlers((self._handlers(),))
        if uri.use_tls:
            if not (tls_cert and tls_key):
                raise ValueError("grapevine:// (TLS) requires tls_cert and tls_key")
            creds = grpc.ssl_server_credentials([(tls_key, tls_cert)])
            port = self._grpc_server.add_secure_port(uri.address, creds)
        else:
            port = self._grpc_server.add_insecure_port(uri.address)
        if port == 0:
            raise RuntimeError(f"failed to bind {uri.address}")
        self._grpc_server.start()
        if self.config.expiry_period > 0 and self.engine is not None:
            self._expiry_thread = threading.Thread(target=self._expiry_loop, daemon=True)
            self._expiry_thread.start()
        log.info("grapevine serving on %s", uri)
        return port

    def health(self) -> dict:
        """Aggregate metrics (SURVEY §5: never keyed by client identity).

        One merged view: engine counters, scheduler/queue gauges, phase
        histograms, and ORAM stash telemetry all come from the shared
        obs registry (engine/metrics.py), so a loopback client sees the
        same picture /metrics exports — not just the engine snapshot.
        """
        with self._sessions_lock:
            n_sessions = len(self._sessions)
        if self.engine is not None:
            detail = self.engine.health()
        else:
            # frontend role: no device engine in-process; the registry
            # still carries the session gauge (engine telemetry lives on
            # the engine tier's own endpoint)
            detail = self.metrics_registry.snapshot()
        return {"sessions": n_sessions, **detail}

    def healthz(self, stall_threshold: float = 30.0) -> tuple[bool, dict]:
        """Liveness verdict for the /healthz endpoint (obs/httpd.py).

        Unhealthy when the scheduler's collector thread has died or its
        oldest queued op has waited past ``stall_threshold`` (the engine
        wedged mid-round); an idle server with an empty queue is healthy
        no matter how long ago the last round committed. Lock-light by
        design — this must answer while a stuck round holds the engine
        lock."""
        healthy = True
        # role tag: the fleet aggregator (obs/fleet.py) folds member
        # healthz docs and needs to tell tiers apart by body alone
        detail: dict = {"role": "frontend" if self.engine is None
                        else "mono"}
        sched = self.scheduler
        if hasattr(sched, "worker_alive"):  # injected stubs may lack it
            alive = sched.worker_alive()
            stall = sched.stall_age()
            detail["worker_alive"] = alive
            detail["stall_age_s"] = round(stall, 3)
            healthy = alive and stall < stall_threshold
        if self.engine is not None:
            age = self.engine.metrics.last_round_age()
            detail["last_round_age_s"] = None if age is None else round(age, 3)
            if self.engine.durability is not None:
                # last-durable-round + recovery progress (batch-level
                # sequence numbers only) — the RPO a probe can alert on
                detail["durability"] = self.engine.durability.status()
        if self.hostpipe is not None:
            # a dead verify/codec worker with restart off means part of
            # the session space can never decrypt again — stop routing
            # here so a supervisor can recycle the process
            alive = self.hostpipe.alive()
            detail["host_workers_alive"] = self.hostpipe.alive_count()
            detail["host_workers"] = self.hostpipe.workers
            healthy = healthy and alive
        if self.shipper is not None:
            detail["replication"] = self.shipper.stats()
            # a fatally refused shipper means a standby promoted out from
            # under this primary: it must stop serving (split brain)
            healthy = healthy and self.shipper.fatal is None
        if self.leakmon is not None:
            # the leak audit verdict is part of liveness: a SUSPECT
            # transcript means the engine is misbehaving even though it
            # is serving — stop routing to it. Cached verdict: /healthz
            # must not pay detector math on the probe path.
            v = self.leakmon.last_verdict()
            detail["leakaudit"] = v["verdict"]
            healthy = healthy and v["verdict"] == "PASS"
        if self.slo is not None:
            # multi-window burn-rate verdict (obs/slo.py): a breached
            # commit-latency SLO is a serving fault like any other — 503
            # stops routing before the error budget is gone
            sv = self.slo.verdict()
            detail["slo"] = sv
            healthy = healthy and sv["ok"]
        return healthy, detail

    def start_metrics(self, port: int, host: str = "127.0.0.1",
                      stall_threshold: float = 30.0) -> int:
        """Serve /metrics + /healthz on ``host:port``; returns the bound
        port (pass 0 for an ephemeral one). Off unless called — the CLI
        wires ``--metrics-port`` here."""
        from ..obs import MetricsServer

        if self.engine is not None:
            # populate the "sort" and "posmap" phase splits before the
            # first scrape (standalone runs at the round's shapes, outside
            # the engine lock); best-effort: metrics must still bind
            for calibrate in (self.engine.calibrate_sort_phase,
                              self.engine.calibrate_posmap_phase):
                try:
                    calibrate()
                except Exception:
                    log.exception("phase calibration failed")
        lm = self.leakmon
        self._metrics_server = MetricsServer(
            self.metrics_registry,
            health=lambda: self.healthz(stall_threshold),
            refresh=(self.engine.sample_stash if self.engine is not None
                     else None),
            host=host,
            port=port,
            leakaudit=lm.verdict if lm is not None else None,
            flightrec=lm.recorder.dump if lm is not None else None,
            trace=(self.tracer.chrome_trace if self.tracer is not None
                   else None),
            profile=(self.profiler.capture if self.profiler is not None
                     else None),
        )
        return self._metrics_server.start()

    def _expiry_loop(self):
        run_expiry_loop(self.engine, self.config, self._expiry_stop,
                        self.clock, health=self.health)

    def stop(self, grace: float = 1.0, checkpoint: bool = False):
        """Drain: stop listeners, settle queued ops (SchedulerShutdown),
        finish the in-flight round, then optionally seal a final
        checkpoint — the SIGTERM path server/cli.py installs."""
        self._expiry_stop.set()
        if self._metrics_server is not None:
            self._metrics_server.stop()
            self._metrics_server = None
        if self._grpc_server is not None:
            stop_grpc(self._grpc_server, self._grpc_pool, grace)
        if self.shipper is not None:
            self.shipper.close()
        self.scheduler.close()
        if self.hostpipe is not None:
            self.hostpipe.close()
        if self.leakmon is not None:
            self.leakmon.close()
        if self.engine is not None:
            if checkpoint:
                self.engine.checkpoint_now()
            self.engine.close()

    def wait(self):
        if self._grpc_server is not None:
            self._grpc_server.wait_for_termination()
