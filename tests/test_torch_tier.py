"""The port's split serving tier (``grapevine_tpu_torch/server/tier.py``)
and its CLI (``grapevine_tpu_torch/server/cli.py``) on the CPU: an
``EngineServer(device="cpu")`` behind two ``FrontendServer``s on gRPC
loopback, driven by the reference's and the port's clients; the internal
Submit API failing closed; the expiry loop on the engine tier; the CLI
started as a subprocess (``--device cpu``) serving one signed op, and
again with every observability flag (leak monitor, SLO target, profiler
gate, adaptive window) serving the four observability endpoints; and the
role/flag matrix as the reference's: valid combinations accepted,
misapplied ones refused (``test_torch_standby_cli.py`` drives the standby
role, ``test_torch_fleet.py`` the fleet role). Modelled on the
reference's ``tests/test_tier.py`` and ``tests/test_cli_roles.py``."""

from __future__ import annotations

import os
import random
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import grpc
import pytest

from grapevine_tpu_torch.config import GrapevineConfig
from grapevine_tpu_torch.server import cli
from grapevine_tpu_torch.server.client import GrapevineClient as PortClient
from grapevine_tpu_torch.server.tier import ENGINE_SERVICE_NAME, EngineServer, FrontendServer
from grapevine_tpu_torch.wire import constants as C
from _torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent


def _ref_client(port, seed_byte):
    from grapevine_tpu.server.client import GrapevineClient

    c = GrapevineClient(f"insecure-grapevine://127.0.0.1:{port}",
                        identity_seed=bytes([seed_byte]) * 32)
    c.auth()
    return c


def _port_client(port, seed_byte):
    c = PortClient(f"insecure-grapevine://127.0.0.1:{port}",
                   identity_seed=bytes([seed_byte]) * 32)
    c.auth()
    return c


@pytest.fixture(scope="module")
def tier():
    cfg = GrapevineConfig(max_messages=256, max_recipients=32, batch_size=8,
                          bucket_cipher_rounds=0)
    engine = EngineServer(cfg, seed=5, device="cpu")
    eport = engine.start("127.0.0.1:0")
    fe_a = FrontendServer(f"127.0.0.1:{eport}", config=cfg)
    fe_b = FrontendServer(f"127.0.0.1:{eport}", config=cfg)
    pa = fe_a.start("insecure-grapevine://127.0.0.1:0")
    pb = fe_b.start("insecure-grapevine://127.0.0.1:0")
    yield {"engine": engine, "eport": eport, "pa": pa, "pb": pb, "fe": fe_a}
    fe_a.stop()
    fe_b.stop()
    engine.stop()


def _submit_stub(eport):
    chan = grpc.insecure_channel(f"127.0.0.1:{eport}")
    identity = lambda b: b  # noqa: E731
    return chan, chan.unary_unary(f"/{ENGINE_SERVICE_NAME}/Submit",
                                  request_serializer=identity,
                                  response_deserializer=identity)


def test_cross_frontend_crud(tier):
    alice = _ref_client(tier["pa"], 0x41)
    bob = _port_client(tier["pb"], 0x42)
    payload = b"tiered".ljust(C.PAYLOAD_SIZE, b"\x00")
    r1 = alice.create(bob.public_key, payload)
    assert r1.status_code == C.STATUS_CODE_SUCCESS
    r2 = bob.read(msg_id=r1.record.msg_id)
    assert (r2.status_code, r2.record.payload, r2.record.sender) == \
        (C.STATUS_CODE_SUCCESS, payload, alice.public_key)
    assert bob.delete(msg_id=r1.record.msg_id, recipient=bob.public_key).status_code == \
        C.STATUS_CODE_SUCCESS
    assert alice.read(msg_id=r1.record.msg_id).status_code == C.STATUS_CODE_NOT_FOUND
    with pytest.raises(grpc.RpcError) as err:
        bob.update(C.ZERO_MSG_ID, bob.public_key, payload)
    assert err.value.code() == grpc.StatusCode.INVALID_ARGUMENT
    alice.close()
    bob.close()


def test_forged_signature_rejected_at_engine(tier):
    """The sr25519 check lives in the engine tier: a forged signature gets
    UNAUTHENTICATED end to end, counts one auth failure there, and
    reaches no round; the session's lockstep survives."""
    eng = tier["engine"].engine
    snap0 = eng.metrics.snapshot()
    mallory = _port_client(tier["pa"], 0x66)
    scheme = mallory._scheme

    class Forged:
        keygen = staticmethod(scheme.keygen)

        @staticmethod
        def sign(sk, ctx, msg):
            return b"\x01" * 63 + b"\x81"  # marked, bogus

    mallory._scheme = Forged
    try:
        with pytest.raises(grpc.RpcError) as ei:
            mallory.create(b"\x05" * 32, b"\x00" * C.PAYLOAD_SIZE)
        assert ei.value.code() == grpc.StatusCode.UNAUTHENTICATED
    finally:
        mallory._scheme = scheme
    snap = eng.metrics.snapshot()
    assert snap["rounds"] == snap0["rounds"]
    assert snap["grapevine_auth_failures_total"] == snap0["grapevine_auth_failures_total"] + 1
    assert mallory.create(b"\x05" * 32, b"\x01" * C.PAYLOAD_SIZE).status_code == \
        C.STATUS_CODE_SUCCESS
    mallory.close()


def test_engine_submit_fails_closed(tier):
    """Malformed and random submissions to the internal API get
    INVALID_ARGUMENT or UNAUTHENTICATED and commit nothing."""
    eng = tier["engine"].engine
    msgs0 = eng.message_count()
    chan, submit = _submit_stub(tier["eport"])
    rng = random.Random(99)
    right = C.QUERY_REQUEST_WIRE_SIZE + C.CHALLENGE_SIZE
    cases = [b"", b"\x00" * 10, b"\xff" * (right - 1), bytes(right)]
    cases += [rng.randbytes(rng.choice((right, rng.randrange(0, 2 * right))))
              for _ in range(12)]
    for data in cases:
        with pytest.raises(grpc.RpcError) as ei:
            submit(data, timeout=30)
        assert ei.value.code() in (grpc.StatusCode.INVALID_ARGUMENT,
                                   grpc.StatusCode.UNAUTHENTICATED)
    assert eng.message_count() == msgs0
    chan.close()


def test_rounds_batch_across_frontends(tier):
    eng = tier["engine"].engine
    rounds0 = eng.metrics.snapshot()["rounds"]
    clients = [(_ref_client if i % 2 else _port_client)(p, 0x70 + i)
               for i, p in enumerate((tier["pa"], tier["pb"], tier["pa"], tier["pb"]))]
    errs = []

    def run(c):
        try:
            for j in range(4):
                assert c.create(c.public_key, bytes([j]) * C.PAYLOAD_SIZE).status_code == \
                    C.STATUS_CODE_SUCCESS
        except Exception as e:  # pragma: no cover
            errs.append(e)

    ts = [threading.Thread(target=run, args=(c,)) for c in clients]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert not errs
    assert 0 < eng.metrics.snapshot()["rounds"] - rounds0 < 16
    for c in clients:
        c.close()


def test_tier_health_and_refusals(tier):
    ok, detail = tier["engine"].healthz()
    assert ok and detail["role"] == "engine" and detail["worker_alive"]
    assert detail["slo"]["ok"] and not detail["slo"]["enforced"]
    assert tier["engine"].engine.tracer is tier["engine"].tracer is not None
    assert tier["engine"].profiler is None and tier["engine"].leakmon is None
    assert "sessions" in tier["fe"].health()
    with pytest.raises(ValueError):
        from grapevine_tpu_torch.server.service import GrapevineServer

        GrapevineServer(scheduler=object(), durability=object())


def test_engine_tier_runs_expiry_sweep():
    cfg = GrapevineConfig(max_messages=64, max_recipients=16, batch_size=4,
                          bucket_cipher_rounds=0, expiry_period=10)
    now = [1_700_000_000]
    engine = EngineServer(cfg, seed=9, clock=lambda: now[0], device="cpu")
    eport = engine.start("127.0.0.1:0")
    fe = FrontendServer(f"127.0.0.1:{eport}", config=cfg)
    port = fe.start("insecure-grapevine://127.0.0.1:0")
    try:
        c = _ref_client(port, 0x77)
        assert c.create(c.public_key, b"\x05" * C.PAYLOAD_SIZE).status_code == \
            C.STATUS_CODE_SUCCESS
        assert engine.engine.message_count() == 1
        now[0] += 1000  # every record now older than the period
        deadline = time.time() + 15  # sweep interval = period/10 = 1 s
        while engine.engine.message_count() and time.time() < deadline:
            time.sleep(0.25)
        assert engine.engine.message_count() == 0, "sweep never evicted"
        assert engine.engine.metrics.snapshot()["sweeps"] >= 1
        c.close()
    finally:
        fe.stop()
        engine.stop()


# -- the CLI ------------------------------------------------------------------


def _wait_line(proc, prefix: str, timeout: float = 120.0) -> str:
    deadline = time.time() + timeout
    while time.time() < deadline:
        line = proc.stdout.readline()
        if line.startswith(prefix):
            return line
        if not line and proc.poll() is not None:
            break
    raise AssertionError(f"no {prefix!r} line; stderr: {proc.stderr.read()[-2000:]}")


def test_cli_serves_a_signed_op_on_the_cpu(tmp_path):
    """``python -m grapevine_tpu_torch.server.cli --device cpu`` at tiny
    caps, with a state dir and the metrics endpoint: one signed CRUD op
    per client package, then SIGTERM drains, seals a checkpoint, exits 0."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.Popen(
        [sys.executable, "-m", "grapevine_tpu_torch.server.cli", "--device", "cpu",
         "--listen", "insecure-grapevine://127.0.0.1:0", "--msg-capacity", "64",
         "--recipient-capacity", "8", "--batch-size", "4", "--batch-wait-ms", "2",
         "--state-dir", str(tmp_path / "state"), "--metrics-port", "0"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        port = int(_wait_line(proc, "grapevine listening on port").split()[-1])
        _wait_line(proc, "metrics endpoint on port")
        alice, bob = _port_client(port, 0x21), _ref_client(port, 0x22)
        r = alice.create(bob.public_key, b"cli".ljust(C.PAYLOAD_SIZE, b"\x00"))
        assert r.status_code == C.STATUS_CODE_SUCCESS
        assert bob.read().record.sender == alice.public_key
        alice.close()
        bob.close()
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert any(n.startswith("ckpt-") and n.endswith(".sealed")
               for n in os.listdir(tmp_path / "state"))


def test_cli_serves_every_observability_endpoint_on_the_cpu():
    """``--leakmon --slo-commit-p99-ms N --profile-enable --adaptive-batch``
    with the metrics endpoint: a signed op commits; ``/leakaudit`` (200,
    PASS, one round audited), ``/flightrec``, ``/trace``, ``/profile``
    and an enforced SLO in ``/healthz`` are served; SIGTERM exits 0."""
    import json
    import urllib.request

    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.Popen(
        [sys.executable, "-m", "grapevine_tpu_torch.server.cli", "--device", "cpu",
         "--listen", "insecure-grapevine://127.0.0.1:0", "--msg-capacity", "64",
         "--recipient-capacity", "8", "--batch-size", "4", "--batch-wait-ms", "2",
         "--leakmon", "--leakmon-window", "64", "--slo-commit-p99-ms", "60000",
         "--profile-enable", "--adaptive-batch", "--trace-ring-size", "32",
         "--metrics-port", "0"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        port = int(_wait_line(proc, "grapevine listening on port").split()[-1])
        url = "http://127.0.0.1:" + _wait_line(proc, "metrics endpoint on port").split()[-1]
        alice = _port_client(port, 0x31)
        r = alice.create(alice.public_key, b"obs".ljust(C.PAYLOAD_SIZE, b"\x00"))
        assert r.status_code == C.STATUS_CODE_SUCCESS
        alice.close()
        deadline = time.time() + 30
        while True:
            audit = json.loads(urllib.request.urlopen(f"{url}/leakaudit").read())
            if audit["rounds_observed"] >= 1 or time.time() > deadline:
                break
            time.sleep(0.05)
        assert audit["verdict"] == "PASS" and audit["rounds_observed"] == 1
        assert audit["window_rounds"] == 64
        assert json.loads(urllib.request.urlopen(f"{url}/flightrec").read())["retained"] == 1
        trace = json.loads(urllib.request.urlopen(f"{url}/trace").read())
        assert trace["otherData"]["rounds_recorded_total"] == 1
        cap = json.loads(urllib.request.urlopen(f"{url}/profile?ms=10").read())
        assert cap["ms"] == 10 and os.path.exists(os.path.join(cap["trace_dir"], "trace.json"))
        hz = json.loads(urllib.request.urlopen(f"{url}/healthz").read())
        assert hz["healthy"] and hz["leakaudit"] == "PASS"
        assert hz["slo"]["enforced"] and hz["slo"]["target_ms"] == 60000.0
        body = urllib.request.urlopen(f"{url}/metrics").read().decode()
        assert "grapevine_host_adaptive_decisions_total" in body
        assert 'grapevine_cost_phase_hbm_bytes{phase="fetch"}' in body
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_cli_observability_configs_built_from_flags():
    args = cli.build_parser().parse_args(
        ["--leakmon", "--leakmon-window", "99", "--leakmon-uniformity-z", "5",
         "--leakmon-collision-threshold", "0.1", "--leakmon-repeat-threshold", "0.2",
         "--leakmon-dump-path", "/d", "--slo-commit-p99-ms", "75"])
    lm, sc = cli._leakmon_config(args), cli._slo_config(args)
    assert (lm.window_rounds, lm.uniformity_z_threshold, lm.collision_threshold,
            lm.repeat_threshold, lm.dump_path) == (99, 5.0, 0.1, 0.2, "/d")
    assert sc.enforce and sc.commit_p99_ms == 75.0
    off = cli.build_parser().parse_args([])
    assert cli._leakmon_config(off) is None and cli._slo_config(off).enforce is False
    with pytest.raises(SystemExit, match="requires --fleet-members"):
        cli.main(["--role", "fleet"])


def test_cli_without_a_card_refuses_to_start(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--listen", "insecure-grapevine://127.0.0.1:0", "--msg-capacity", "64",
                  "--recipient-capacity", "8", "--batch-size", "4"])
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--role", "engine", "--msg-capacity", "64", "--recipient-capacity", "8",
                  "--batch-size", "4"])


def test_cli_standby_needs_a_state_dir_and_a_card(tmp_path, monkeypatch):
    import torch

    with pytest.raises(SystemExit, match="requires --state-dir"):
        cli.main(["--role", "standby", "--device", "cpu", "--msg-capacity", "64"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--role", "standby", "--state-dir", str(tmp_path), "--msg-capacity", "64",
                  "--recipient-capacity", "8", "--batch-size", "4"])


def _check(argv):
    parser = cli.build_parser()
    args = parser.parse_args(argv)
    cli._reject_misapplied_flags(parser, args, argv)
    return args


@pytest.mark.parametrize("argv", [
    ["--role", "engine", "--identity-seed", "ab" * 32],
    ["--role", "engine", "--listen", "insecure-grapevine://0.0.0.0:3229"],
    ["--role", "frontend", "--seed", "0"],
    ["--role", "frontend", "--device", "cpu"],
    ["--role", "frontend", "--expiry-period", "60"],
    ["--role", "frontend", "--pipeline-depth", "1"],
    ["--role", "frontend", "--evict-every", "4"],
    ["--role", "frontend", "--state-dir", "/x"],
    ["--role", "frontend", "--flush-window", "4"],
    ["--role", "mono", "--engine", "x:1"],
    ["--role", "mono", "--engine-listen", "127.0.0.1:0"],
    ["--standby-listen", "127.0.0.1:0"],
    ["--role", "mono", "--promote-from", "/p"],
    ["--role", "engine", "--standby-listen", "127.0.0.1:0"],
    ["--role", "frontend", "--replicate-to", "127.0.0.1:4100"],
    ["--role", "frontend", "--ship-every", "2"],
    ["--role", "standby", "--state-dir", "/x", "--replicate-to", "127.0.0.1:4100"],
    ["--role", "standby", "--state-dir", "/x", "--listen", "insecure-grapevine://0.0.0.0:1"],
    ["--role", "standby", "--state-dir", "/x", "--host-workers", "2"],
    ["--role", "frontend", "--bucket-cipher-impl", "pallas_fused_tiled"],
    ["--fleet-port", "0"],
    ["--role", "frontend", "--leakmon"],
    ["--role", "frontend", "--slo-commit-p99-ms", "250"],
    ["--role", "frontend", "--adaptive-batch"],
    ["--role", "fleet", "--fleet-members", "h0:1", "--device", "cpu"],
    ["--role", "fleet", "--fleet-members", "h0:1", "--leakmon"],
    ["--role", "engine", "--fleet-members", "h0:1"],
])
def test_misapplied_flags_rejected(argv):
    with pytest.raises(SystemExit, match="does not take"):
        _check(argv)


@pytest.mark.parametrize("argv", [
    [],
    ["--device", "cpu", "--role", "mono", "--listen", "insecure-grapevine://0.0.0.0:1",
     "--identity-seed", "ab" * 32, "--expiry-period", "60"],
    ["--role", "engine", "--device", "cuda", "--engine-listen", "127.0.0.1:0",
     "--msg-capacity", "512", "--batch-size", "16", "--seed", "3", "--metrics-port", "0"],
    ["--role", "frontend", "--engine", "127.0.0.1:4000", "--host-workers", "2",
     "--worker-restart"],
    ["--role", "mono", "--pipeline-depth", "2", "--evict-every", "4", "--host-workers", "2",
     "--flush-window", "4", "--state-dir", "/x", "--journal-fsync-every", "1"],
    ["--role", "standby", "--state-dir", "/x"],
    ["--state-dir", "/x", "--replicate-to", "127.0.0.1:4100"],
    ["--ship-every", "1"],
    ["--role", "engine", "--device", "cpu", "--state-dir", "/x",
     "--replicate-to", "127.0.0.1:4100", "--ship-every", "4"],
    ["--role", "standby", "--device", "cuda", "--state-dir", "/s", "--standby-listen",
     "127.0.0.1:0", "--promote-from", "/p", "--engine-listen", "127.0.0.1:0",
     "--metrics-port", "0", "--evict-every", "2", "--batch-wait-ms", "30",
     "--worker-restart", "--seal-key-file", "/k", "--bucket-cipher-impl",
     "pallas_fused_tiled"],
    ["--role", "engine", "--bucket-cipher-impl", "pallas_fused"],
    ["--role", "fleet", "--fleet-members", "h0:1"],
    ["--leakmon"],
    ["--leakmon-window", "256"],
    ["--role", "engine", "--trace-ring-size", "512"],
    ["--slo-commit-p99-ms", "250"],
    ["--role", "engine", "--profile-enable"],
    ["--adaptive-batch"],
    ["--role", "standby", "--state-dir", "/x", "--leakmon"],
    ["--role", "fleet", "--fleet-members", "h0:1,h1:2", "--fleet-port", "0",
     "--fleet-scrape-interval", "0.5", "--metrics-host", "0.0.0.0"],
    ["--role", "standby", "--state-dir", "/x", "--slo-commit-p99-ms", "100",
     "--profile-enable", "--adaptive-batch", "--trace-ring-size", "64"],
])
def test_valid_role_flag_combinations_accepted(argv):
    _check(argv)


def test_every_parser_flag_is_claimed_and_abbreviations_rejected(monkeypatch):
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(["--rol", "engine"])
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(["--device", "tpu"])
    trimmed = {k: v - {"device"} for k, v in cli._ROLE_FLAGS.items()}
    monkeypatch.setattr(cli, "_ROLE_FLAGS", trimmed)
    with pytest.raises(SystemExit, match="missing from _ROLE_FLAGS"):
        _check([])
