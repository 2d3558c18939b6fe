"""The port's monolithic server (``grapevine_tpu_torch/server/service.py``)
over gRPC loopback on the CPU, driven by the reference's
``GrapevineClient`` and by the port's: Auth handshake, challenge lockstep,
signed CRUD through the encrypted channel, cross-client batching,
UNAUTHENTICATED / INVALID_ARGUMENT / UNAVAILABLE, session TTL and cap,
``health()``/``healthz()`` keys against the reference server's, the
metrics endpoint with every observability endpoint, the observability
knobs on both device-owning tiers, the host pipeline (whose workers
import no ``torch``), and the port's client against the reference's
server. Modelled on the reference's ``tests/test_server.py`` and
``tests/test_hostpipe.py``.

The reference server (JAX) is imported inside its fixture, so the card
test at the end runs without JAX: ``python -m pytest --noconftest
tests/test_torch_server.py -k cuda``."""

import json
import threading
import time
import urllib.request
from pathlib import Path

import grpc
import pytest
import torch

from grapevine_tpu_torch.config import GrapevineConfig
from grapevine_tpu_torch.server import scheduler as sched_mod
from grapevine_tpu_torch.server.client import GrapevineClient as PortClient
from grapevine_tpu_torch.server.service import GrapevineServer
from grapevine_tpu_torch.server.uri import GrapevineUri
from grapevine_tpu_torch.session import schnorrkel
from grapevine_tpu_torch.wire import constants as C
from grapevine_tpu_torch.wire import protowire as pw
from grapevine_tpu_torch.wire.records import QueryRequest, QueryResponse, RequestRecord
from _torch_threads import one_torch_thread  # noqa: F401

GEO = dict(bucket_cipher_rounds=0, max_messages=64, max_recipients=8, mailbox_cap=8,
           batch_size=4, stash_size=64)
CFG = GrapevineConfig(**GEO)
NOW = 1_700_000_000


def _ref_client_cls():
    from grapevine_tpu.server.client import GrapevineClient

    return GrapevineClient


CLIENTS = {"port": lambda: PortClient, "ref": _ref_client_cls}


@pytest.fixture(scope="module")
def server():
    srv = GrapevineServer(CFG, seed=2, max_wait_ms=5.0, clock=lambda: NOW, device="cpu")
    port = srv.start("insecure-grapevine://127.0.0.1:0")
    yield srv, port
    srv.stop()


def make_client(port, seed_byte, kind="ref"):
    c = CLIENTS[kind]()(f"insecure-grapevine://127.0.0.1:{port}",
                        identity_seed=bytes([seed_byte]) * 32)
    c.auth()
    return c


def pl(text: bytes) -> bytes:
    return text.ljust(C.PAYLOAD_SIZE, b"\x00")


def test_uri_parsing_equals_reference():
    from grapevine_tpu.server.uri import GrapevineUri as RefUri

    for uri in ("grapevine://example.com", "insecure-grapevine://127.0.0.1:0",
                "insecure-grapevine://box", "insecure-grapevine://[::1]:3229"):
        u, r = GrapevineUri.parse(uri), RefUri.parse(uri)
        assert (u.host, u.port, u.use_tls, u.address, str(u)) == \
            (r.host, r.port, r.use_tls, r.address, str(r))
    with pytest.raises(ValueError):
        GrapevineUri.parse("http://example.com")


@pytest.mark.parametrize("kinds", [("ref", "ref"), ("port", "port"), ("ref", "port")])
def test_end_to_end_messaging(server, kinds):
    _, port = server
    base = {("ref", "ref"): 1, ("port", "port"): 4, ("ref", "port"): 7}[kinds]
    alice = make_client(port, base, kinds[0])
    bob = make_client(port, base + 1, kinds[1])

    r = alice.create(bob.public_key, pl(b"hello bob"))
    assert r.status_code == C.STATUS_CODE_SUCCESS
    mid = r.record.msg_id
    assert mid != C.ZERO_MSG_ID
    r = bob.read()
    assert r.status_code == C.STATUS_CODE_SUCCESS
    assert r.record.payload == pl(b"hello bob")
    assert r.record.sender == alice.public_key
    assert r.record.timestamp == NOW
    assert bob.update(mid, bob.public_key, pl(b"edited")).status_code == C.STATUS_CODE_SUCCESS
    assert alice.read(mid).record.payload == pl(b"edited")
    assert bob.delete().status_code == C.STATUS_CODE_SUCCESS
    assert bob.read().status_code == C.STATUS_CODE_NOT_FOUND
    eve = make_client(port, base + 2, kinds[0])
    assert eve.read(mid).status_code == C.STATUS_CODE_NOT_FOUND
    for c in (alice, bob, eve):
        c.close()


def test_challenge_lockstep_many_requests(server):
    _, port = server
    c = make_client(port, 20, "port")
    me = c.public_key
    for i in range(8):  # mailbox cap in CFG
        assert c.create(me, pl(b"x%d" % i)).status_code == C.STATUS_CODE_SUCCESS
    assert c.create(me, pl(b"over")).status_code == \
        C.STATUS_CODE_TOO_MANY_MESSAGES_FOR_RECIPIENT
    seen = {c.delete().record.payload[:2] for _ in range(8)}
    assert len(seen) == 8
    c.close()


def test_concurrent_clients_batched(server):
    """Sessions firing in parallel land in shared engine rounds."""
    srv, port = server
    clients = [make_client(port, 24 + i, "ref" if i % 2 else "port") for i in range(4)]
    target = clients[0].public_key
    rounds0 = srv.engine.metrics.snapshot()["rounds"]
    errors = []

    def worker(c):
        try:
            for _ in range(2):
                assert c.create(target, pl(b"cc")).status_code == C.STATUS_CODE_SUCCESS
        except Exception as exc:  # pragma: no cover
            errors.append(exc)

    threads = [threading.Thread(target=worker, args=(c,)) for c in clients[1:]]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    assert srv.engine.metrics.snapshot()["rounds"] - rounds0 <= 6
    n = 0
    while clients[0].delete().status_code == C.STATUS_CODE_SUCCESS:
        n += 1
    assert n == 6
    for c in clients:
        c.close()


def test_unauthenticated_paths_never_reach_a_round(server):
    """A forged signature, a desynced challenge, and an unknown channel
    get UNAUTHENTICATED; the forged and desynced ops reach no round and
    each counts one auth failure."""
    srv, port = server
    c = make_client(port, 30, "ref")
    snap = srv.engine.metrics.snapshot
    rounds0, fails0 = snap()["rounds"], snap()["grapevine_auth_failures_total"]
    scheme = c._scheme

    class Forged:
        keygen = staticmethod(scheme.keygen)

        @staticmethod
        def sign(sk, ctx, msg):
            return b"\x01" * 63 + b"\x81"  # marked, bogus

    c._scheme = Forged
    with pytest.raises(grpc.RpcError) as err:
        c.create(c.public_key, pl(b"forged"))
    assert err.value.code() == grpc.StatusCode.UNAUTHENTICATED
    c._scheme = scheme
    # lockstep survives a rejected signature: the challenge was consumed
    # on both sides
    assert c.read().status_code == C.STATUS_CODE_NOT_FOUND
    c._challenge.next_challenge()  # skipping a draw desyncs the client
    with pytest.raises(grpc.RpcError) as err:
        c.create(c.public_key, pl(b"desync"))
    assert err.value.code() == grpc.StatusCode.UNAUTHENTICATED
    assert snap()["rounds"] == rounds0 + 1  # only the honest read
    assert snap()["grapevine_auth_failures_total"] == fails0 + 2
    c.close()
    c2 = PortClient(f"insecure-grapevine://127.0.0.1:{port}", b"\x05" * 32)
    with pytest.raises(grpc.RpcError) as err:
        c2._query_rpc(pw.encode_envelope(
            pw.EnvelopeMessage(channel_id=b"\x99" * 16, data=b"\x00" * 64)))
    assert err.value.code() == grpc.StatusCode.UNAUTHENTICATED
    c2.close()


def test_invalid_argument_paths(server):
    _, port = server
    c = make_client(port, 31, "port")
    with pytest.raises(grpc.RpcError) as err:
        c.update(C.ZERO_MSG_ID, c.public_key, pl(b"x"))  # zero-id update
    assert err.value.code() == grpc.StatusCode.INVALID_ARGUMENT
    for junk in (b"\x0a", b"\x0a\x05ab", b"\x0b"):
        with pytest.raises(grpc.RpcError) as err:
            c._query_rpc(junk)
        assert err.value.code() == grpc.StatusCode.INVALID_ARGUMENT
        with pytest.raises(grpc.RpcError) as err:
            c._auth_rpc(junk)
        assert err.value.code() == grpc.StatusCode.INVALID_ARGUMENT
    with pytest.raises(grpc.RpcError) as err:  # a short handshake
        c._auth_rpc(pw.encode_auth_message(pw.AuthMessage(data=b"\x01" * 31)))
    assert err.value.code() == grpc.StatusCode.INVALID_ARGUMENT
    c.close()


def test_replayed_and_injected_envelopes_do_not_desync_session(server):
    _, port = server
    c = make_client(port, 41, "port")
    peer = make_client(port, 42, "ref")
    challenge = c._challenge.next_challenge()
    req = QueryRequest(
        request_type=C.REQUEST_TYPE_CREATE, auth_identity=c.public_key,
        auth_signature=c._scheme.sign(c.sk, C.GRAPEVINE_CHALLENGE_SIGNING_CONTEXT,
                                      challenge),
        record=RequestRecord(recipient=peer.public_key, payload=pl(b"captured")))
    raw = pw.encode_envelope(pw.EnvelopeMessage(channel_id=c._channel_id,
                                                data=c._channel.encrypt(req.pack())))
    reply = pw.decode_envelope(c._query_rpc(raw))
    assert QueryResponse.unpack(c._channel.decrypt(reply.data)).status_code == \
        C.STATUS_CODE_SUCCESS
    for bad in (raw, pw.encode_envelope(pw.EnvelopeMessage(channel_id=c._channel_id,
                                                           data=b"\x13" * 256))):
        with pytest.raises(grpc.RpcError) as exc:
            c._query_rpc(bad)
        assert exc.value.code() == grpc.StatusCode.UNAUTHENTICATED
    r = peer.read()
    assert r.status_code == C.STATUS_CODE_SUCCESS and r.record.payload == pl(b"captured")
    assert c.read().status_code == C.STATUS_CODE_NOT_FOUND
    c.close()
    peer.close()


def test_session_cap_and_ttl():
    srv = GrapevineServer(CFG, seed=9, max_sessions=3, session_ttl=60.0, device="cpu")
    port = srv.start("insecure-grapevine://127.0.0.1:0")
    try:
        clients = [make_client(port, 50 + i, "port") for i in range(4)]
        # the oldest session was evicted when the 4th authenticated
        with pytest.raises(grpc.RpcError) as err:
            clients[0].read()
        assert err.value.code() == grpc.StatusCode.UNAUTHENTICATED
        assert clients[3].read().status_code == C.STATUS_CODE_NOT_FOUND
        assert srv.health()["sessions"] == 3
        # an idle session past the TTL is refused at use time
        srv.session_ttl = 0.2
        time.sleep(0.3)
        with pytest.raises(grpc.RpcError) as err:
            clients[3].read()
        assert err.value.code() == grpc.StatusCode.UNAUTHENTICATED
        assert srv.metrics_registry.get("grapevine_sessions").get() == 2
        for c in clients:
            c.close()
    finally:
        srv.stop()


def test_drained_scheduler_answers_unavailable():
    srv = GrapevineServer(CFG, seed=3, device="cpu")
    port = srv.start("insecure-grapevine://127.0.0.1:0")
    try:
        c = make_client(port, 60, "ref")
        assert c.read().status_code == C.STATUS_CODE_NOT_FOUND
        srv.scheduler.close()
        with pytest.raises(grpc.RpcError) as err:
            c.read()
        assert err.value.code() == grpc.StatusCode.UNAVAILABLE
        c.close()
    finally:
        srv.stop()


@pytest.fixture(scope="module")
def ref_server():
    from grapevine_tpu.config import GrapevineConfig as RefConfig
    from grapevine_tpu.server.service import GrapevineServer as RefServer

    srv = RefServer(RefConfig(**GEO), seed=2, max_wait_ms=5.0, clock=lambda: NOW)
    port = srv.start("insecure-grapevine://127.0.0.1:0")
    yield srv, port
    srv.stop()


def test_port_client_against_reference_server(ref_server):
    _, port = ref_server
    alice, bob = make_client(port, 70, "port"), make_client(port, 71, "port")
    r = alice.create(bob.public_key, pl(b"to the reference"))
    assert r.status_code == C.STATUS_CODE_SUCCESS
    got = bob.read(r.record.msg_id)
    assert (got.status_code, got.record.payload, got.record.sender) == \
        (C.STATUS_CODE_SUCCESS, pl(b"to the reference"), alice.public_key)
    assert bob.delete().status_code == C.STATUS_CODE_SUCCESS
    with pytest.raises(grpc.RpcError) as err:
        alice.update(C.ZERO_MSG_ID, alice.public_key, pl(b"x"))
    assert err.value.code() == grpc.StatusCode.INVALID_ARGUMENT
    alice.close()
    bob.close()


def test_health_keys_equal_reference(server, ref_server):
    """``health()`` and ``healthz()`` have the reference server's keys,
    the round observability's metric families and the SLO verdict
    included; ``health()`` adds the port's round-graph counter."""
    srv, _ = server
    ref, _ = ref_server
    want = set(ref.health())
    assert len(want) > 60
    assert any(k.startswith(("grapevine_cost_", "grapevine_load_", "grapevine_slo_",
                             "grapevine_trace_")) for k in want)
    # the port's engine adds its round-graph counter (engine/round_graph.py)
    assert set(srv.health()) == want | {"round_graph"}
    ok, detail = srv.healthz()
    ref_ok, ref_detail = ref.healthz()
    assert ok and ref_ok
    assert set(detail) == set(ref_detail)
    assert set(detail["slo"]) == set(ref_detail["slo"])
    assert (detail["role"], detail["worker_alive"]) == ("mono", True)


def test_metrics_endpoint_serves_the_registry(server):
    srv, port = server
    mport = srv.start_metrics(0)
    try:
        body = urllib.request.urlopen(f"http://127.0.0.1:{mport}/metrics").read().decode()
        for phase in ("assembly", "verify", "dispatch", "evict", "demux"):
            assert f'grapevine_phase_seconds_count{{phase="{phase}"}}' in body
        assert "grapevine_sessions" in body and "grapevine_auth_failures_total" in body
        hz = urllib.request.urlopen(f"http://127.0.0.1:{mport}/healthz")
        assert hz.status == 200 and json.loads(hz.read())["healthy"] is True
        trace = json.loads(urllib.request.urlopen(f"http://127.0.0.1:{mport}/trace").read())
        assert any(e["name"] == "grapevine/evict" for e in trace["traceEvents"])
        for phase in ("sort", "posmap"):  # calibrated by start_metrics
            assert f'grapevine_phase_seconds_count{{phase="{phase}"}} 1' in body
        for path in ("/leakaudit", "/flightrec", "/profile"):  # not asked for
            with pytest.raises(urllib.error.HTTPError) as err:
                urllib.request.urlopen(f"http://127.0.0.1:{mport}{path}")
            assert err.value.code == 404
    finally:
        srv._metrics_server.stop()
        srv._metrics_server = None
    # with the leak monitor and the profiler gate, all four are served
    from grapevine_tpu_torch.obs.leakmon import LeakMonitorConfig

    obs = GrapevineServer(CFG, seed=3, device="cpu", leakmon=LeakMonitorConfig(),
                          profile_enable=True)
    try:
        obs.engine.handle_queries([QueryRequest(
            request_type=C.REQUEST_TYPE_CREATE, auth_identity=bytes([7]) * 32,
            record=RequestRecord(recipient=bytes([8]) * 32, payload=pl(b"o")))], NOW)
        assert obs.leakmon.flush()
        mport = obs.start_metrics(0)
        url = f"http://127.0.0.1:{mport}"
        audit = urllib.request.urlopen(f"{url}/leakaudit")
        assert audit.status == 200 and json.loads(audit.read())["verdict"] == "PASS"
        assert json.loads(urllib.request.urlopen(f"{url}/flightrec").read())["retained"] == 1
        assert len(json.loads(urllib.request.urlopen(f"{url}/trace").read())["traceEvents"]) > 5
        cap = json.loads(urllib.request.urlopen(f"{url}/profile?ms=20").read())
        assert cap["ms"] == 20 and Path(cap["trace_dir"], "trace.json").exists()
        assert json.loads(urllib.request.urlopen(f"{url}/healthz").read())["leakaudit"] == "PASS"
    finally:
        obs.stop()


def _observability_knob(name):
    from grapevine_tpu_torch.obs import ProfilerGate
    from grapevine_tpu_torch.obs.leakmon import EngineLeakMonitor, LeakMonitorConfig
    from grapevine_tpu_torch.obs.slo import SloConfig
    from grapevine_tpu_torch.server.adaptive import AdaptiveBatchPolicy

    cfg = SloConfig(commit_p99_ms=40.0)
    return {
        "slo": (dict(slo=cfg), lambda s: s.slo.cfg is cfg),
        "profile_enable": (dict(profile_enable=True),
                           lambda s: isinstance(s.profiler, ProfilerGate)),
        "leakmon": (dict(leakmon=LeakMonitorConfig(window_rounds=32)),
                    lambda s: isinstance(s.leakmon, EngineLeakMonitor)
                    and s.engine.leakmon is s.leakmon
                    and s.leakmon.monitor.cfg.window_rounds == 32),
        "adaptive_batch": (dict(adaptive_batch=True),
                           lambda s: isinstance(s.scheduler.adaptive, AdaptiveBatchPolicy)
                           and s.scheduler.adaptive.workload is s.engine.workload
                           and s.scheduler.adaptive.slo is s.slo),
    }[name]


@pytest.mark.parametrize("knob", ["slo", "profile_enable", "leakmon", "adaptive_batch"])
@pytest.mark.parametrize("tier", ["mono", "engine"])
def test_observability_knobs_accepted(knob, tier):
    """Each of the reference's observability knobs is served by both
    device-owning tiers: the tracer, SLO tracker, workload and cost
    telemetry are always attached to the engine, and the knob attaches
    (or configures) its own part."""
    from grapevine_tpu_torch.obs import CostMonitor, RoundTracer, SloTracker, WorkloadTelemetry
    from grapevine_tpu_torch.server.tier import EngineServer

    kw, attached = _observability_knob(knob)
    cls = GrapevineServer if tier == "mono" else EngineServer
    srv = cls(CFG, device="cpu", **kw)
    try:
        eng = srv.engine
        assert isinstance(srv.tracer, RoundTracer) and eng.tracer is srv.tracer
        assert isinstance(srv.slo, SloTracker) and eng.slo is srv.slo
        assert isinstance(eng.workload, WorkloadTelemetry)
        assert isinstance(eng.costmon, CostMonitor)
        assert attached(srv)
    finally:
        srv.stop()
    if knob == "leakmon":
        assert not srv.leakmon._worker.is_alive()


@pytest.mark.parametrize("knob", [dict(leakmon=object()), dict(adaptive_batch=True)])
def test_frontend_refuses_device_owner_knobs(knob):
    with pytest.raises(ValueError, match="frontend"):
        GrapevineServer(CFG, scheduler=object(), **knob)


@pytest.mark.parametrize("tier", ["mono", "engine"])
def test_replicate_to_needs_a_state_dir(tier):
    from grapevine_tpu_torch.engine.replication import ReplicationError
    from grapevine_tpu_torch.server.tier import EngineServer

    cls = GrapevineServer if tier == "mono" else EngineServer
    with pytest.raises(ReplicationError, match="state-dir"):
        cls(CFG, device="cpu", replicate_to="127.0.0.1:1")


def test_frontend_scheduler_refuses_replicate_to():
    with pytest.raises(ValueError, match="no journal to ship"):
        GrapevineServer(CFG, scheduler=object(), replicate_to="127.0.0.1:1")


@pytest.mark.parametrize("tier", ["mono", "engine"])
def test_replicating_server_ships_folds_healthz_and_closes(tmp_path, tier):
    """``replicate_to`` + ``ship_every``: the server's shipper feeds a
    standby; ``healthz`` carries its books and turns unhealthy on a fatal
    refusal; ``stop`` closes it (the journal's doorbell is unhooked)."""
    from grapevine_tpu_torch.config import DurabilityConfig
    from grapevine_tpu_torch.engine.replication import StandbyReplica
    from grapevine_tpu_torch.server.tier import EngineServer

    for d in ("p", "s"):
        (tmp_path / d).mkdir()
        (tmp_path / d / "root.key").write_bytes(bytes(range(32)))
    replica = StandbyReplica(CFG, seed=2, device="cpu",
                             durability=DurabilityConfig(state_dir=str(tmp_path / "s")))
    cls = GrapevineServer if tier == "mono" else EngineServer
    srv = cls(CFG, seed=2, device="cpu", durability=DurabilityConfig(
        state_dir=str(tmp_path / "p")), replicate_to=f"127.0.0.1:{replica.listen()}",
        ship_every=2)
    try:
        assert srv.shipper.ship_every == 2
        eng = srv.engine
        for i in range(3):
            eng.handle_queries([QueryRequest(
                request_type=C.REQUEST_TYPE_CREATE, auth_identity=bytes([i + 1]) * 32,
                record=RequestRecord(recipient=bytes([9]) * 32, payload=pl(b"x")))], NOW + i)
        deadline = time.monotonic() + 30
        while replica.dm.applied_seq < 3 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert replica.dm.applied_seq == eng.durability.seq == 3
        healthy, detail = srv.healthz()
        assert healthy and detail["replication"]["frames_shipped"] == 3
        assert detail["replication"]["cadence_ok"]
        srv.shipper.fatal = "standby promoted"
        assert srv.healthz()[0] is False
    finally:
        srv.stop()
        replica.close()
    assert not srv.shipper._thread.is_alive()
    assert eng.durability.journal.on_append is None


def test_engine_server_serves_an_injected_engine():
    from grapevine_tpu_torch.engine.batcher import GrapevineEngine
    from grapevine_tpu_torch.server.tier import EngineServer

    eng = GrapevineEngine(CFG, seed=4, device="cpu")
    srv = EngineServer(engine=eng, max_wait_ms=5.0)
    try:
        assert srv.engine is eng and srv.config is eng.config and srv.scheduler.engine is eng
    finally:
        srv.stop()


def test_servers_default_to_the_card(monkeypatch):
    from grapevine_tpu_torch.server.tier import EngineServer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        GrapevineServer(CFG)
    with pytest.raises(RuntimeError, match="CUDA"):
        EngineServer(CFG)
    srv = GrapevineServer(CFG, device="cpu")
    assert srv.engine.device.type == "cpu"
    assert srv.tracer is not None and srv.slo is not None and srv.profiler is None
    srv.stop()


def _mapped_libraries(pid: int) -> str:
    return Path(f"/proc/{pid}/maps").read_text()


def test_host_workers_serve_and_import_no_torch():
    """``host_workers=2``: sessions stick to worker processes that open and
    seal every frame and verify signatures; neither worker has loaded
    torch (its shared objects are absent from the worker's mappings)."""
    srv = GrapevineServer(CFG, seed=4, host_workers=2, device="cpu")
    port = srv.start("insecure-grapevine://127.0.0.1:0")
    try:
        alice, bob = make_client(port, 80, "ref"), make_client(port, 81, "port")
        r = alice.create(bob.public_key, pl(b"via workers"))
        assert r.status_code == C.STATUS_CODE_SUCCESS
        assert bob.read().record.payload == pl(b"via workers")
        with pytest.raises(grpc.RpcError) as err:
            bob.update(C.ZERO_MSG_ID, bob.public_key, pl(b"x"))
        assert err.value.code() == grpc.StatusCode.INVALID_ARGUMENT
        pipe = srv.hostpipe
        assert pipe.alive() and srv.healthz()[1]["host_workers_alive"] == 2
        assert pipe.verify_parallel([(alice.public_key, C.GRAPEVINE_CHALLENGE_SIGNING_CONTEXT,
                                      b"m" * 32, schnorrkel.sign(alice.sk,
                                      C.GRAPEVINE_CHALLENGE_SIGNING_CONTEXT, b"m" * 32))])
        for slot in pipe._slots:
            maps = _mapped_libraries(slot.process.pid)
            assert "libtorch" not in maps and "/torch/" not in maps
            assert "jaxlib" not in maps
        alice.close()
        bob.close()
    finally:
        srv.stop()


# -- on the card --------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused round's Hopper kernels have no "
                    "CPU mode (run on the card: python -m pytest --noconftest "
                    "tests/test_torch_server.py -k cuda)")
    return torch.device("cuda")


def _signed(i: int, rtype: int, recipient: bytes, msg_id=C.ZERO_MSG_ID, payload=None):
    sk, pub = schnorrkel.keygen(bytes([i % 251 + 1]) * 32)
    challenge = bytes([i % 256]) * 32
    sig = schnorrkel.sign(sk, C.GRAPEVINE_CHALLENGE_SIGNING_CONTEXT, challenge)
    req = QueryRequest(request_type=rtype, auth_identity=pub, auth_signature=sig,
                       record=RequestRecord(msg_id=msg_id, recipient=recipient,
                                            payload=payload or bytes(C.PAYLOAD_SIZE)))
    return req, (pub, C.GRAPEVINE_CHALLENGE_SIGNING_CONTEXT, challenge, sig)


def test_cuda_scheduler_dispatches_from_its_own_thread(cuda_device):
    """The engine is built on this thread; the scheduler's collector thread
    dispatches and resolves its rounds (depth 2), handler threads submit,
    and an expiry sweep runs from a third thread. Every response equals a
    depth-1 engine's on this thread fed the same rounds."""
    from grapevine_tpu_torch.engine.batcher import GrapevineEngine

    geo = dict(max_messages=2**12, max_recipients=2**8, batch_size=16, mailbox_cap=8,
               vphases_impl="dense", bucket_cipher_impl="pallas_fused", evict_every=2)
    eng = GrapevineEngine(GrapevineConfig(**geo), seed=5, device=cuda_device)
    ref = GrapevineEngine(GrapevineConfig(pipeline_depth=1, **geo), seed=5,
                          device=cuda_device)
    assert eng.pipeline_depth == 2
    sched = sched_mod.BatchScheduler(eng, max_wait_ms=60_000, idle_gap_ms=60_000,
                                     clock=lambda: NOW)
    try:
        ops = [_signed(i, C.REQUEST_TYPE_CREATE, bytes([1 + i % 5]) * 32,
                       payload=bytes([i]) * C.PAYLOAD_SIZE) for i in range(64)]
        futs = [None] * len(ops)

        def submit(lo):
            for j in range(lo, lo + 16):
                futs[j] = sched.submit_nowait(*ops[j])

        for k in range(4):  # one full round at a time keeps the round order fixed
            t = threading.Thread(target=submit, args=(16 * k,))
            t.start()
            t.join()
            if k == 1:
                sweeper = threading.Thread(target=eng.expire, args=(NOW, 10**6))
                sweeper.start()
                sweeper.join()
                ref.expire(NOW, 10**6)
        got = [f.result(timeout=120).pack() for f in futs]
        want = []
        for k in range(4):
            want += [r.pack() for r in ref.handle_queries([q for q, _ in ops[16 * k:16 * k + 16]],
                                                          NOW)]
        assert got == want
    finally:
        sched.close()
