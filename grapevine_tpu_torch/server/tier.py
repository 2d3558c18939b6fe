"""Split frontend/engine serving tier — the horizontal host-path story (a
copy of ``grapevine_tpu/server/tier.py`` over the port's engine).

One CPython process is GIL-bound on session crypto + codec work (the
reference measured ~10k ops/s), while the device engine serves
many times that. The reference never faced this split (its frontend was
C-core gRPC + Rust); here it is explicit: N **frontend** processes
terminate client sessions (IX handshake, channel AEAD, challenge
lockstep, request unpack + validation) and forward validated ops to ONE
**engine** process, which batch-verifies sr25519 signatures ACROSS
frontends (one Pippenger MSM per round — better batching than any
frontend could do alone) and runs the oblivious rounds on the device.

Trust model: frontends are deployment-internal (same boundary as the
reference's untrusted host runtime). The engine accepts pre-decrypted
requests only from them — bind the engine listener to localhost or a
private network; client-facing confidentiality still ends at the
frontends' AEAD channels. The signature check stays in the ENGINE, so a
compromised frontend cannot forge ops for identities it has never seen
sign (it can only replay what the session layer already allows — same
as the reference's host).

Wire (internal, raw-bytes gRPC like the public API):
    /grapevine.EngineAPI/Submit
    request  = packed QueryRequest (wire codec, constant size)
               ‖ challenge (32 B) — the auth identity and signature
               already travel inside the packed request
    response = packed QueryResponse, or gRPC UNAUTHENTICATED /
               INVALID_ARGUMENT mirroring the public service.

The public-facing frontend behaves byte-identically to the monolithic
``GrapevineServer`` (same Auth/Query surface), so clients need no
changes and a load balancer can spread them across frontends.
"""

from __future__ import annotations

import logging
import threading

import grpc

from ..config import GrapevineConfig
from ..wire import constants as C
from ..wire.records import QueryRequest, QueryResponse
from ..wire.validate import HardProtocolError, validate_request
from .scheduler import AuthFailure, SchedulerShutdown
from .service import grpc_server, stop_grpc

log = logging.getLogger("grapevine_tpu_torch.tier")

ENGINE_SERVICE_NAME = "grapevine.EngineAPI"


class EngineServer:
    """The engine tier: one device engine + cross-frontend batching.

    Exposes ``Submit`` (one validated op per RPC). Concurrent RPCs from
    many frontends land in the shared BatchScheduler, which fills
    device rounds and batch-verifies each round's signatures with one
    MSM — exactly the path the monolithic server uses, so every
    scheduler/engine test covers this tier too.
    """

    def __init__(self, config: GrapevineConfig | None = None, seed: int = 0,
                 max_wait_ms: float | None = None, clock=None, leakmon=None,
                 durability=None, worker_restart: bool = False,
                 trace_ring_size: int = 512, slo=None,
                 profile_enable: bool = False, engine=None,
                 replicate_to: str | None = None, ship_every: int = 1,
                 host_workers: int = 0, adaptive_batch: bool = False,
                 flush_window_ms: float | None = None, device=None):
        from ..engine.batcher import GrapevineEngine
        from ..session import get_signature_scheme
        from .scheduler import BatchScheduler

        import time as _time

        self.config = (engine.config if engine is not None
                       else config or GrapevineConfig())
        # durable construction runs recovery before the listener binds;
        # device=None is the card (raises without one). ``engine`` lets a
        # promoted StandbyReplica serve its warm state in-process, with no
        # second recovery
        self.engine = engine or GrapevineEngine(self.config, seed=seed, device=device,
                                                durability=durability)
        #: primary-side journal shipping (engine/replication.py): the
        #: engine tier owns the journal, so it owns the feed
        self.shipper = None
        if replicate_to is not None:
            from ..engine.replication import JournalShipper

            self.shipper = JournalShipper(self.engine, replicate_to,
                                          ship_every=ship_every)
            self.shipper.start()
        #: continuous obliviousness auditing (obs/leakmon.py) — the
        #: engine tier owns the device, so it owns the transcript audit
        self.leakmon = None
        if leakmon is not None:
            from ..obs.leakmon import EngineLeakMonitor

            self.leakmon = EngineLeakMonitor.for_engine(self.engine, leakmon)
            self.engine.attach_leakmon(self.leakmon)
            if self.shipper is not None:
                # ship-cadence detector: the audit verdict folds the
                # shipper's frame-length books (leakmon.py rationale)
                self.leakmon.attach_shipper(self.shipper)
        #: round tracing + commit-latency SLO + optional capture gate —
        #: one shared attach policy (obs.attach_round_observability has
        #: the rationale and the observe-only default contract)
        from ..obs import attach_round_observability

        self.tracer, self.slo, self.profiler = attach_round_observability(
            self.engine, self.engine.metrics.registry,
            trace_ring_size=trace_ring_size, slo=slo,
            profile_enable=profile_enable,
        )
        kwargs = {} if max_wait_ms is None else {"max_wait_ms": max_wait_ms}
        self.scheduler = BatchScheduler(
            self.engine,
            clock=clock,
            scheme=get_signature_scheme(self.config.signature_scheme),
            restart_on_crash=worker_restart,
            flush_window_ms=flush_window_ms,
            **kwargs,
        )
        if adaptive_batch:
            # SLO-adaptive window sizing (server/adaptive.py): planted
            # after observability attaches so the policy reads the same
            # public arrival EWMA and burn rates /metrics exports
            from .adaptive import AdaptiveBatchPolicy

            self.scheduler.adaptive = AdaptiveBatchPolicy(
                self.engine.ecfg.batch_size,
                self.scheduler.max_wait,
                self.scheduler.idle_gap,
                workload=self.engine.workload,
                slo=self.slo,
                registry=self.engine.metrics.registry,
            )
        #: optional verify fan-out pool: the engine tier holds no
        #: sessions, so its hostpipe does nothing but split the round's
        #: batch-verify MSM across worker processes (scheduler.py)
        self.hostpipe = None
        if host_workers:
            from .hostpipe import HostPipeline

            self.hostpipe = HostPipeline(
                host_workers,
                scheme=self.config.signature_scheme,
                restart_on_crash=worker_restart,
                registry=self.engine.metrics.registry,
            )
            self.scheduler.hostpipe = self.hostpipe
        self._grpc_server: grpc.Server | None = None
        self.clock = clock or (lambda: int(_time.time()))
        self._expiry_stop = threading.Event()
        self._expiry_thread: threading.Thread | None = None
        self._metrics_server = None

    def _submit(self, request_bytes: bytes, context: grpc.ServicerContext) -> bytes:
        if len(request_bytes) != C.QUERY_REQUEST_WIRE_SIZE + C.CHALLENGE_SIZE:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, "bad submit size")
        challenge = request_bytes[C.QUERY_REQUEST_WIRE_SIZE:]
        try:
            req = QueryRequest.unpack(request_bytes[: C.QUERY_REQUEST_WIRE_SIZE])
            validate_request(req)
        except (ValueError, HardProtocolError) as exc:
            # same exception scope as the public service's fail-fast —
            # anything else is an engine bug and must crash loudly, not
            # masquerade as malformed client traffic
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(exc))
        try:
            resp: QueryResponse = self.scheduler.submit(
                req,
                auth=(
                    req.auth_identity,
                    C.GRAPEVINE_CHALLENGE_SIGNING_CONTEXT,
                    challenge,
                    req.auth_signature,
                ),
            )
        except AuthFailure:
            context.abort(grpc.StatusCode.UNAUTHENTICATED,
                          "bad challenge signature")
        except SchedulerShutdown as exc:
            # drain settle: UNAVAILABLE is what the frontend stub's
            # bounded retry keys on (and never auth/protocol errors)
            context.abort(grpc.StatusCode.UNAVAILABLE, str(exc))
        return resp.pack()

    def start(self, address: str = "127.0.0.1:0") -> int:
        """Bind the internal listener (plain host:port — deployment-
        internal; keep it on localhost or a private interface)."""
        identity = lambda b: b  # noqa: E731
        handler = grpc.method_handlers_generic_handler(
            ENGINE_SERVICE_NAME,
            {"Submit": grpc.unary_unary_rpc_method_handler(
                self._submit, request_deserializer=identity,
                response_serializer=identity)},
        )
        self._grpc_server, self._grpc_pool = grpc_server(max(8, 2 * self.config.batch_size))
        self._grpc_server.add_generic_rpc_handlers((handler,))
        port = self._grpc_server.add_insecure_port(address)
        if port == 0:
            raise RuntimeError(f"failed to bind engine listener {address}")
        self._grpc_server.start()
        if self.config.expiry_period > 0:
            # the engine tier owns the device, so it owns the sweep —
            # the same loop the monolithic server runs (service.py)
            from .service import run_expiry_loop

            self._expiry_thread = threading.Thread(
                target=run_expiry_loop,
                args=(self.engine, self.config, self._expiry_stop, self.clock),
                daemon=True,
            )
            self._expiry_thread.start()
        log.info("engine tier serving on %s", address)
        return port

    def health(self) -> dict:
        return self.engine.health()

    def healthz(self, stall_threshold: float = 30.0) -> tuple[bool, dict]:
        """Engine-tier liveness: collector thread up, oldest queued op
        not waiting past the threshold (same semantics as the monolithic
        server's healthz, server/service.py)."""
        alive = self.scheduler.worker_alive()
        stall = self.scheduler.stall_age()
        age = self.engine.metrics.last_round_age()
        healthy = alive and stall < stall_threshold
        detail = {
            # role tag: the fleet aggregator (obs/fleet.py) folds member
            # healthz docs and needs to tell tiers apart by body alone
            "role": "engine",
            "worker_alive": alive,
            "stall_age_s": round(stall, 3),
            "last_round_age_s": None if age is None else round(age, 3),
        }
        if self.engine.durability is not None:
            detail["durability"] = self.engine.durability.status()
        if self.hostpipe is not None:
            # degraded verify pool: the scheduler degrades to in-process
            # verification (still correct), but the capacity loss should
            # page — same stance as the monolithic server's fold
            detail["host_workers_alive"] = self.hostpipe.alive_count()
            detail["host_workers"] = self.hostpipe.workers
            healthy = healthy and self.hostpipe.alive()
        if self.shipper is not None:
            detail["replication"] = self.shipper.stats()
            # a fatally refused shipper means a standby promoted out from
            # under this primary: it must stop serving (split brain)
            healthy = healthy and self.shipper.fatal is None
        if self.leakmon is not None:
            # same folding as the monolithic server: a SUSPECT transcript
            # is a serving fault — 503 stops routing (cached verdict; the
            # probe path never pays detector math)
            v = self.leakmon.last_verdict()
            detail["leakaudit"] = v["verdict"]
            healthy = healthy and v["verdict"] == "PASS"
        # commit-latency SLO burn-rate verdict (obs/slo.py): breached =
        # stop routing, same as the monolithic server
        sv = self.slo.verdict()
        detail["slo"] = sv
        healthy = healthy and sv["ok"]
        return healthy, detail

    def start_metrics(self, port: int, host: str = "127.0.0.1",
                      stall_threshold: float = 30.0) -> int:
        """Serve /metrics + /healthz for the engine tier; returns the
        bound port. The engine tier owns the device, so it owns the
        batch/round/stash telemetry — frontends export only their own
        session-layer registry."""
        from ..obs import MetricsServer

        # populate the "sort" and "posmap" phase splits before the first
        # scrape (standalone runs at the round's shapes, outside the
        # engine lock); best-effort: metrics must still bind
        for calibrate in (self.engine.calibrate_sort_phase,
                          self.engine.calibrate_posmap_phase):
            try:
                calibrate()
            except Exception:
                log.exception("phase calibration failed")
        lm = self.leakmon
        self._metrics_server = MetricsServer(
            self.engine.metrics.registry,
            health=lambda: self.healthz(stall_threshold),
            refresh=self.engine.sample_stash,
            host=host,
            port=port,
            leakaudit=lm.verdict if lm is not None else None,
            flightrec=lm.recorder.dump if lm is not None else None,
            trace=self.tracer.chrome_trace,
            profile=(self.profiler.capture if self.profiler is not None
                     else None),
        )
        return self._metrics_server.start()

    def stop(self, grace: float = 1.0, checkpoint: bool = False):
        """Drain the engine tier; with ``checkpoint`` seal the final
        state after the scheduler settles (the SIGTERM path)."""
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
        if checkpoint:
            self.engine.checkpoint_now()
        self.engine.close()


class _EngineStub:
    """Scheduler-shaped adapter over the engine tier's Submit RPC, so
    the frontend can reuse GrapevineServer._query verbatim.

    Every RPC carries a deadline (a wedged engine must fail the client's
    call, not hang the frontend handler thread forever), and UNAVAILABLE
    — the engine restarting, draining, or unreachable — is retried a
    bounded number of times with jittered exponential backoff. Nothing
    else is retried: UNAUTHENTICATED / INVALID_ARGUMENT are deliberate
    rejections (retrying them re-spends a challenge), and
    DEADLINE_EXCEEDED is ambiguous — the op may have committed, and
    Submit is not idempotent."""

    def __init__(self, address: str, deadline_s: float = 30.0,
                 max_retries: int = 3, backoff_s: float = 0.05,
                 backoff_cap_s: float = 2.0):
        self._grpc = grpc.insecure_channel(address)
        identity = lambda b: b  # noqa: E731
        self._submit = self._grpc.unary_unary(
            f"/{ENGINE_SERVICE_NAME}/Submit",
            request_serializer=identity, response_deserializer=identity,
        )
        self.deadline_s = deadline_s
        self.max_retries = max_retries
        self.backoff_s = backoff_s
        self.backoff_cap_s = backoff_cap_s
        self._c_retries = None

    def bind_registry(self, registry) -> None:
        """Register the retry counter on the frontend's telemetry
        registry (counts only — batch-level by construction)."""
        self._c_retries = registry.counter(
            "grapevine_engine_rpc_retries_total",
            "engine-tier Submit RPCs retried after UNAVAILABLE",
        )

    def submit(self, req: QueryRequest, auth=None) -> QueryResponse:
        import random
        import time as _time

        challenge = auth[2] if auth else b"\x00" * C.CHALLENGE_SIZE
        payload = req.pack() + challenge
        attempt = 0
        while True:
            try:
                data = self._submit(payload, timeout=self.deadline_s)
            except grpc.RpcError as e:
                if e.code() == grpc.StatusCode.UNAUTHENTICATED:
                    raise AuthFailure(str(e.details())) from None
                if (
                    e.code() != grpc.StatusCode.UNAVAILABLE
                    or attempt >= self.max_retries
                ):
                    raise
                attempt += 1
                if self._c_retries is not None:
                    self._c_retries.inc()
                delay = min(
                    self.backoff_cap_s,
                    self.backoff_s * (2 ** (attempt - 1)),
                ) * random.uniform(0.5, 1.5)
                log.warning(
                    "engine Submit UNAVAILABLE (%s); retry %d/%d in %.0f ms",
                    e.details(), attempt, self.max_retries, delay * 1e3,
                )
                _time.sleep(delay)
                continue
            return QueryResponse.unpack(data)

    def close(self):
        self._grpc.close()


class FrontendServer:
    """A client-facing session-termination process.

    Byte-identical public surface to the monolithic ``GrapevineServer``
    (Auth + Query, IX handshake, AEAD, lockstep, validation) — but ops
    go to a shared engine tier instead of an in-process engine. Run N
    of these behind a load balancer; each is one CPython process of
    session crypto, and the engine batches across all of them.
    """

    def __init__(self, engine_address: str, config: GrapevineConfig | None = None,
                 attestation=None, clock=None, session_ttl: float = 3600.0,
                 max_sessions: int = 4096, identity=None,
                 host_workers: int = 0, worker_restart: bool = False):
        from .service import GrapevineServer

        # The monolithic server with its scheduler swapped for the
        # engine-tier RPC stub (GrapevineServer's injected-scheduler
        # mode): every session/auth behavior and its tests carry over
        # unchanged, and there is no device engine in this process.
        # ``host_workers`` is where the multiprocess verify/codec
        # pipeline pays off most: the frontend IS the host-crypto tier,
        # so its sessions fan out across worker processes while the
        # engine tier keeps the device.
        stub = _EngineStub(engine_address)
        self._inner = GrapevineServer(
            config=config,
            attestation=attestation,
            clock=clock,
            session_ttl=session_ttl,
            max_sessions=max_sessions,
            identity=identity,
            scheduler=stub,
            host_workers=host_workers,
            worker_restart=worker_restart,
        )
        stub.bind_registry(self._inner.metrics_registry)

    def start(self, listen_uri, tls_cert: bytes | None = None,
              tls_key: bytes | None = None) -> int:
        # expiry sweeps run in the ENGINE process; never start one here
        # (GrapevineServer.start already skips them when engine is None)
        return self._inner.start(listen_uri, tls_cert, tls_key)

    @property
    def identity(self):
        return self._inner.identity

    def health(self) -> dict:
        return self._inner.health()

    def start_metrics(self, port: int, host: str = "127.0.0.1",
                      stall_threshold: float = 30.0) -> int:
        # the frontend's registry carries session-layer telemetry only;
        # round/stash metrics live on the engine tier's endpoint
        return self._inner.start_metrics(port, host, stall_threshold)

    def wait(self):
        self._inner.wait()

    def stop(self, grace: float = 1.0):
        self._inner.stop(grace)
