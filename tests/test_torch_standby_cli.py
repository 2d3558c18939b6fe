"""The hot-standby runbook over real processes, on the port's CLI
(``python -m grapevine_tpu_torch.server.cli``; the reference's
``tests/test_chaos_recovery.py:test_live_flip_drill_zero_dropped_ops`` is
the model).

On the CPU (``--device cpu``): an engine-role primary with ``--state-dir``
and ``--replicate-to`` ships to a standby-role process; signed writes are
acknowledged over gRPC; the standby's ``/healthz`` shows it caught up;
the primary is SIGKILLed and the standby SIGUSR1ed; it promotes (fencing
the primary's dir), serves the Submit API, and every acknowledged write
reads back from it: zero dropped ops.

On the card (skipped without one): a cuda primary ships to a cuda standby
at 2^14 messages, B=64, E=4, ``"pallas_fused"`` (B3 on every replayed
round, B5 on every replayed flush, B2 on the replayed sweep); the
standby's state equals the primary's after catch-up and the promoted
state equals the dead primary's, bit for bit. This file imports no JAX,
so it runs there: ``python -m pytest --noconftest
tests/test_torch_standby_cli.py``.
"""

import json
import os
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request

import pytest
import torch

from grapevine_tpu_torch.server.tier import _EngineStub
from grapevine_tpu_torch.session import get_signature_scheme
from grapevine_tpu_torch.wire import constants as C
from grapevine_tpu_torch.wire.records import QueryRequest, RequestRecord
from _torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = bytes(range(32))
NOW = 1_700_000_000


def _plant(d: str) -> None:
    os.makedirs(d)
    with open(os.path.join(d, "root.key"), "wb") as fh:
        fh.write(ROOT)
    os.chmod(os.path.join(d, "root.key"), 0o600)


def _wait_line(proc, needle, timeout=120.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        line = proc.stdout.readline()
        if not line:
            raise AssertionError(f"process exited before {needle!r}: "
                                 f"{proc.stderr.read()[-2000:]}")
        if needle in line:
            return line
    raise AssertionError(f"no {needle!r} line within {timeout}s")


def _signed(scheme, seed_byte, rt, recipient, payload_byte, challenge, msg_id=None):
    sk, pub = scheme.keygen(bytes([seed_byte]) * 32)
    sig = scheme.sign(sk, C.GRAPEVINE_CHALLENGE_SIGNING_CONTEXT, challenge)
    req = QueryRequest(request_type=rt, auth_identity=pub, auth_signature=sig,
                       record=RequestRecord(msg_id=msg_id or C.ZERO_MSG_ID,
                                            recipient=recipient,
                                            payload=bytes([payload_byte]) * C.PAYLOAD_SIZE))
    return req, (pub, C.GRAPEVINE_CHALLENGE_SIGNING_CONTEXT, challenge, sig)


def _healthz(mport: int) -> dict:
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{mport}/healthz", timeout=5) as r:
            return json.loads(r.read().decode())
    except urllib.error.HTTPError as e:
        return json.loads(e.read().decode())


def test_live_flip_drill_zero_dropped_ops(tmp_path):
    """Kill the primary, promote the standby: every acknowledged write
    (three into one mailbox, popped in order; five elsewhere, read back by
    id) survives the flip, and the promoted engine takes new writes."""
    scheme = get_signature_scheme("schnorrkel")
    pdir, sdir = str(tmp_path / "primary"), str(tmp_path / "standby")
    _plant(pdir)
    _plant(sdir)
    cli = [sys.executable, "-m", "grapevine_tpu_torch.server.cli", "--device", "cpu"]
    geometry = ["--msg-capacity", "64", "--recipient-capacity", "8", "--batch-size", "4",
                "--evict-every", "2", "--tree-top-cache-levels", "0",
                "--pipeline-depth", "1", "--batch-wait-ms", "30"]
    procs = []
    try:
        standby = subprocess.Popen(
            cli + ["--role", "standby", "--state-dir", sdir, "--standby-listen", "127.0.0.1:0",
                   "--promote-from", pdir, "--engine-listen", "127.0.0.1:0",
                   "--metrics-port", "0"] + geometry,
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        procs.append(standby)
        feed_port = int(_wait_line(standby, "standby replica on port").rsplit(" ", 1)[1])
        mport = int(_wait_line(standby, "metrics endpoint on port").rsplit(" ", 1)[1])
        hz = _healthz(mport)
        assert hz["role"] == "standby" and not hz["promoted"]

        primary = subprocess.Popen(
            cli + ["--role", "engine", "--engine-listen", "127.0.0.1:0", "--state-dir", pdir,
                   "--replicate-to", f"127.0.0.1:{feed_port}"] + geometry,
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        procs.append(primary)
        eport = int(_wait_line(primary, "engine tier listening on port").rsplit(" ", 1)[1])

        stub = _EngineStub(f"127.0.0.1:{eport}", deadline_s=60.0)
        x_sk, x_pub = scheme.keygen(b"\x07" * 32)
        ids = []
        for i in range(8):
            req, auth = _signed(scheme, i + 10, C.REQUEST_TYPE_CREATE,
                                x_pub if i < 3 else bytes([i + 40]) * 32, 0x70 + i,
                                bytes([i + 1]) * C.CHALLENGE_SIZE)
            resp = stub.submit(req, auth=auth)
            assert resp.status_code == C.STATUS_CODE_SUCCESS, i
            ids.append(resp.record.msg_id)
        stub.close()

        deadline = time.monotonic() + 60
        while True:
            hz = _healthz(mport)
            if hz.get("replication_connected") and hz["durability"]["applied_seq"] >= 8:
                break
            assert time.monotonic() < deadline, f"standby never caught up: {hz}"
            time.sleep(0.2)

        primary.send_signal(signal.SIGKILL)
        primary.wait(timeout=30)
        standby.send_signal(signal.SIGUSR1)
        line = _wait_line(standby, "standby promoted: epoch")
        assert "epoch 1," in line
        pport = int(_wait_line(standby, "promoted engine tier listening on port")
                    .rsplit(" ", 1)[1])
        assert _healthz(mport)["promoted"]
        assert os.path.exists(os.path.join(pdir, "fenced"))

        stub = _EngineStub(f"127.0.0.1:{pport}", deadline_s=60.0)
        # the writes acknowledged into other mailboxes read back by id, each
        # by its sender, with its payload
        for i in range(3, 8):
            req, auth = _signed(scheme, i + 10, C.REQUEST_TYPE_READ, bytes([i + 40]) * 32, 0,
                                bytes([0x90 + i]) * C.CHALLENGE_SIZE, msg_id=ids[i])
            resp = stub.submit(req, auth=auth)
            assert resp.status_code == C.STATUS_CODE_SUCCESS, i
            assert resp.record.payload == bytes([0x70 + i]) * C.PAYLOAD_SIZE, i
        popped = []
        for i in range(3):
            challenge = bytes([0x80 + i]) * C.CHALLENGE_SIZE
            sig = scheme.sign(x_sk, C.GRAPEVINE_CHALLENGE_SIGNING_CONTEXT, challenge)
            req = QueryRequest(request_type=C.REQUEST_TYPE_DELETE, auth_identity=x_pub,
                               auth_signature=sig, record=RequestRecord(
                                   msg_id=C.ZERO_MSG_ID, recipient=C.ZERO_PUBKEY,
                                   payload=b"\x00" * C.PAYLOAD_SIZE))
            resp = stub.submit(req, auth=(x_pub, C.GRAPEVINE_CHALLENGE_SIGNING_CONTEXT,
                                          challenge, sig))
            assert resp.status_code == C.STATUS_CODE_SUCCESS
            popped.append(resp.record.payload[0])
        assert popped == [0x70, 0x71, 0x72], popped
        req, auth = _signed(scheme, 99, C.REQUEST_TYPE_CREATE, b"\x63" * 32, 0x63,
                            b"\xaa" * C.CHALLENGE_SIZE)
        assert stub.submit(req, auth=auth).status_code == C.STATUS_CODE_SUCCESS
        stub.close()

        standby.send_signal(signal.SIGTERM)
        assert standby.wait(timeout=120) == 0, standby.stderr.read()[-2000:]
        procs = []
    finally:
        for p in procs:
            p.kill()
            p.wait(timeout=10)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused round's Hopper kernels have no CPU "
                    "mode (run on the card: python -m pytest --noconftest "
                    "tests/test_torch_standby_cli.py -k cuda)")
    return torch.device("cuda")


def test_cuda_standby_promotes_bit_equal(cuda_device, tmp_path):
    """A cuda primary → a cuda standby over loopback at 2^14, E=4,
    ``"pallas_fused"``: equal to the primary after catch-up (every leaf,
    generator included; the replay launches the primary's kernels), and
    after a cut, a 3-round tail and the promote equal to the dead primary."""
    from grapevine_tpu_torch.config import DurabilityConfig, GrapevineConfig
    from grapevine_tpu_torch.engine.batcher import GrapevineEngine
    from grapevine_tpu_torch.engine.checkpoint import state_to_bytes
    from grapevine_tpu_torch.engine.replication import JournalShipper, StandbyReplica
    from grapevine_tpu_torch.oblivious import cipher_kernels as ck
    from grapevine_tpu_torch.oblivious import gather_kernels as gk

    cfg = GrapevineConfig(max_messages=2**14, max_recipients=2**10, batch_size=64,
                          bucket_cipher_impl="pallas_fused", vphases_impl="dense",
                          evict_every=4)
    pdir, sdir = str(tmp_path / "p"), str(tmp_path / "s")
    _plant(pdir)
    _plant(sdir)
    dkw = dict(checkpoint_every_rounds=1 << 20)
    primary = GrapevineEngine(cfg, seed=3, device=cuda_device,
                              durability=DurabilityConfig(state_dir=pdir, **dkw))
    replica = StandbyReplica(cfg, seed=3, device=cuda_device,
                             durability=DurabilityConfig(state_dir=sdir, **dkw))
    shipper = JournalShipper(primary, ("127.0.0.1", replica.listen()))
    shipper.start()

    def same(a, b):
        return (state_to_bytes(a.ecfg, a.state) == state_to_bytes(b.ecfg, b.state)
                and torch.equal(a.state.rng.get_state(), b.state.rng.get_state()))

    def round_of(k):
        return [QueryRequest(request_type=C.REQUEST_TYPE_CREATE,
                             auth_identity=bytes([k + 1, i + 1]) * 16,
                             record=RequestRecord(recipient=bytes([i % 32 + 1]) * 32,
                                                  payload=bytes([k]) * C.PAYLOAD_SIZE))
                for i in range(cfg.batch_size)]

    try:
        gk.reset_launches()
        ck.reset_launches()
        for k in range(8):
            primary.handle_queries(round_of(k), NOW + k)
        assert primary.expire(NOW + 100, 95) > 0
        deadline = time.monotonic() + 300
        while replica.dm.applied_seq < primary.durability.seq:
            assert time.monotonic() < deadline, "the standby never caught up"
            time.sleep(0.05)
        # both engines: 3 B3 a round the wrappers launch (the standby's
        # every round; the primary's warm-up and its round graph's capture,
        # whose 7 replays launch from the graph), 2 B5 a flush, one sweep's
        # B2 each
        replayed = primary.health()["round_graph"]["replayed"]
        assert replayed == 7
        assert gk.LAUNCHES["gather_decrypt_rows"] == 3 * 8 + 3 * (8 - replayed + 1)
        assert gk.LAUNCHES["scatter_encrypt_rows"] == 2 * 2 * 2
        assert ck.LAUNCHES["cipher_rows_pallas"] % 2 == 0 < ck.LAUNCHES["cipher_rows_pallas"]
        with replica.engine._lock:
            assert same(replica.engine, primary)
        shipper.close()
        for k in range(8, 11):
            primary.handle_queries(round_of(k), NOW + k)
        dead_seq = primary.durability.seq
        dead = state_to_bytes(primary.ecfg, primary.state)
        dead_rng = primary.state.rng.get_state()
        primary.close()
        info = replica.promote(primary_state_dir=pdir)
        assert info["epoch"] == 1 and info["drained_frames"] == 3
        assert info["applied_seq"] == dead_seq
        assert state_to_bytes(replica.engine.ecfg, replica.engine.state) == dead
        assert torch.equal(replica.engine.state.rng.get_state(), dead_rng)
    finally:
        shipper.close()
        primary.close()
        replica.close()
