"""A stopped server leaves no thread of its own behind, and its stop
returns even with a handler wedged: the gRPC handler pool is shut down
inside ``stop`` (``server/service.py:stop_grpc``), not left for the
interpreter's exit, which joins every pool thread without a timeout."""

from __future__ import annotations

import threading
import time

import grpc

from grapevine_tpu_torch.config import GrapevineConfig
from grapevine_tpu_torch.server import service
from grapevine_tpu_torch.server.client import GrapevineClient
from grapevine_tpu_torch.server.scheduler import SchedulerShutdown
from grapevine_tpu_torch.server.service import GrapevineServer
from grapevine_tpu_torch.server.tier import EngineServer, FrontendServer
from grapevine_tpu_torch.wire import constants as C
from _torch_threads import one_torch_thread  # noqa: F401

CFG = GrapevineConfig(max_messages=64, max_recipients=8, batch_size=4)
PAYLOAD = b"stop".ljust(C.PAYLOAD_SIZE, b"\x00")


def new_threads(before: set, settle_s: float = 5.0) -> list:
    """Threads started since ``before`` still alive after ``settle_s``."""
    deadline = time.monotonic() + settle_s
    while True:
        left = [t for t in threading.enumerate() if t not in before and t.is_alive()]
        if not left or time.monotonic() > deadline:
            return [t.name for t in left]
        time.sleep(0.05)


def client(port: int, seed: int) -> GrapevineClient:
    c = GrapevineClient(f"insecure-grapevine://127.0.0.1:{port}",
                        identity_seed=bytes([seed]) * 32)
    c.auth()
    return c


def test_a_stopped_server_leaves_no_thread():
    before = set(threading.enumerate())
    srv = GrapevineServer(CFG, seed=2, max_wait_ms=5.0, device="cpu")
    try:
        port = srv.start("insecure-grapevine://127.0.0.1:0")
        c = client(port, 0x51)
        assert c.create(c.public_key, PAYLOAD).status_code == C.STATUS_CODE_SUCCESS
        c.close()
    finally:
        srv.stop()
    assert new_threads(before) == []


def test_a_stopped_tier_leaves_no_thread():
    cfg = GrapevineConfig(max_messages=256, max_recipients=32, batch_size=8,
                          bucket_cipher_rounds=0)
    before = set(threading.enumerate())
    engine = EngineServer(cfg, seed=5, device="cpu")
    fe = None
    try:
        eport = engine.start("127.0.0.1:0")
        fe = FrontendServer(f"127.0.0.1:{eport}", config=cfg)
        c = client(fe.start("insecure-grapevine://127.0.0.1:0"), 0x52)
        assert c.create(c.public_key, PAYLOAD).status_code == C.STATUS_CODE_SUCCESS
        c.close()
    finally:
        if fe is not None:
            fe.stop()
        engine.stop()
    assert new_threads(before) == []


class Wedged:
    """An op sink whose ``submit`` blocks until released."""

    def __init__(self):
        self.entered = threading.Event()
        self.release = threading.Event()

    def submit(self, req, auth=None):
        self.entered.set()
        self.release.wait(60)
        raise SchedulerShutdown("released")

    def close(self):
        pass


def test_stop_returns_with_a_handler_wedged(monkeypatch):
    monkeypatch.setattr(service, "STOP_SLACK_S", 0.5)
    wedged = Wedged()
    before = set(threading.enumerate())
    srv = GrapevineServer(CFG, scheduler=wedged)
    port = srv.start("insecure-grapevine://127.0.0.1:0")
    c = client(port, 0x53)
    errors = []

    def call():
        try:
            c.create(c.public_key, PAYLOAD)
        except grpc.RpcError as exc:
            errors.append(exc.code())

    caller = threading.Thread(target=call, daemon=True)
    caller.start()
    try:
        assert wedged.entered.wait(30)
        t0 = time.monotonic()
        srv.stop(grace=0.2)
        took = time.monotonic() - t0
    finally:
        wedged.release.set()
    caller.join(30)
    c.close()
    # grace, then at most the slack for the server and for its pool
    assert took < 0.2 + 2 * 0.5 + 1.0, took
    assert errors and errors[0] in (grpc.StatusCode.CANCELLED, grpc.StatusCode.UNAVAILABLE)
    assert new_threads(before) == []


def test_stop_bounds_each_wait(monkeypatch):
    """``stop_grpc`` gives the server's stop event and each pool thread a
    bounded wait: a thread that never ends is logged, not joined forever."""
    monkeypatch.setattr(service, "STOP_SLACK_S", 0.2)
    stuck = threading.Event()
    server, pool = service.grpc_server(2)
    pool.submit(stuck.wait, 30)
    server.start()
    t0 = time.monotonic()
    try:
        service.stop_grpc(server, pool, 0.1)
        assert time.monotonic() - t0 < 0.1 + 2 * 0.2 + 1.0
    finally:
        stuck.set()
    pool.shutdown(wait=True)


def test_the_pool_threads_are_named():
    """The handler pool's threads carry the ``grapevine-rpc`` prefix (what
    a stack dump of a stuck process shows)."""
    server, pool = service.grpc_server(1)
    try:
        assert pool.submit(lambda: threading.current_thread().name).result(10) \
            .startswith("grapevine-rpc")
    finally:
        service.stop_grpc(server, pool, 0.0)
