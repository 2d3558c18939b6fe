"""Kill-at-every-phase chaos campaigns of the port (slow): SIGKILL the
engine process at every instrumented fault site of the journal,
checkpoint, round and flush protocol — plus timer kills inside the
schedule — restart, and require recovery bit-identical to an
uninterrupted run with the leak monitor PASS throughout; then the live
flip drill over the port's CLI.

Drives ``grapevine_tpu_torch/testing/chaos_run.py`` on the CPU with the
arguments and seeds of the reference's ``tests/test_chaos_recovery.py``
(``--device cpu`` added; restart trials run four at a time, which changes
no draw). Each trial spawns child processes and a campaign runs for
minutes, so this file is ``-m slow``, as its reference is; the unmarked
twins are ``test_torch_chaos_twins.py``. Every subprocess wait has a
timeout, and every process is killed and reaped in a ``finally``.
"""

import os
import queue
import signal
import subprocess
import sys
import threading
import time

import pytest

from grapevine_tpu_torch.testing import chaos_run as chaos
from grapevine_tpu_torch.testing.faults import ALL_POINTS
from _torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.slow

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ["--device", "cpu", "--jobs", "4"]


def _campaign(argv, n_trials=0, modes=None):
    args = chaos.parse_args(CPU + argv)
    reports: list = []
    failures = chaos.run_trials(n_trials, args, modes=modes, reports=reports)
    assert not failures, "\n".join(failures)
    return reports[1:]


def test_kill_at_every_fault_point_recovers_bit_identical():
    """One trial per crash site plus one timer kill (the flush sites skip
    at E=1): recovered state and every recorded response hash match the
    uninterrupted oracle, leakmon PASS on the recovered engine."""
    reps = _campaign(["--events", "18"], modes=list(ALL_POINTS) + ["timer"])
    assert sum(r["kills"] for r in reps) >= len(ALL_POINTS) - 2


def test_randomized_kill_trials_recover_bit_identical():
    """Randomized trials (site and trigger count drawn per trial)."""
    assert len(_campaign(["--events", "18", "--seed", "77"], n_trials=6)) == 6


def test_delayed_eviction_kill_trials_recover_bit_identical():
    """At ``--evict-every 4`` every fault site runs again, the flush
    boundary windows included, multi-incarnation where the trigger
    re-arms; each incarnation's hashes and the final state match the
    uninterrupted E=4 oracle."""
    reps = _campaign(["--events", "16", "--evict-every", "4", "--seed", "52",
                      "--checkpoint-every", "5"], modes=list(ALL_POINTS) + ["timer"])
    assert {r["mode"] for r in reps if r["kills"]} >= {"flush.pre_dispatch",
                                                       "flush.post_dispatch"}


def test_sharded_flush_kill_trials_recover_bit_identical():
    """``--shards 2 --evict-every 2``: the child runs the owner-masked
    sharded flush on a 2-shard CPU mesh, kills land at the flush
    boundaries, a mid-accumulation append and a timer; the oracle is the
    one-device serial E=2 program."""
    _campaign(["--events", "16", "--evict-every", "2", "--shards", "2", "--seed", "64",
               "--checkpoint-every", "5"],
              modes=["flush.pre_dispatch", "flush.post_dispatch",
                     "journal.append.post_fsync", "timer"])


def test_pipelined_kill_trials_recover_bit_identical():
    """``--pipeline-depth 2``: a round is in flight while the next one
    journals and fsyncs; kills between fsync and dispatch, mid-flight, at
    the fsync barrier, the torn frame, and a timer; the oracle is the
    serial depth-1 program."""
    _campaign(["--events", "18", "--seed", "99", "--pipeline-depth", "2"],
              modes=["round.pre_dispatch", "round.post_dispatch",
                     "journal.append.post_fsync", "journal.append.torn", "timer"])


def test_standby_kill_at_every_fault_point_promotes_bit_identical():
    """The hot-standby drill at every fault site plus a timer at
    ``--evict-every 2 --pipeline-depth 2``: the primary ships to an
    in-parent StandbyReplica, is SIGKILLed once, the replica promotes and
    finishes the schedule bit-identical to the serial oracle with leakmon
    PASS, and the fenced primary dir refuses a revived stale writer."""
    reps = _campaign(["--standby", "--events", "16", "--evict-every", "2",
                      "--pipeline-depth", "2", "--checkpoint-every", "5", "--seed", "43"],
                     modes=list(ALL_POINTS) + ["timer"])
    assert all(r["promote"]["epoch"] == 1 for r in reps)


# -- live flip drill: CLI processes, SIGKILL + SIGUSR1, zero dropped ----


class _Lines:
    """A process's stdout lines, read on a thread so a wait can time out."""

    def __init__(self, proc):
        self.proc = proc
        self.q: queue.Queue = queue.Queue()
        threading.Thread(target=self._pump, daemon=True).start()

    def _pump(self):
        for line in self.proc.stdout:
            self.q.put(line)
        self.q.put(None)

    def wait(self, needle: str, timeout: float = 120.0) -> str:
        deadline = time.monotonic() + timeout
        while True:
            try:
                line = self.q.get(timeout=max(0.0, deadline - time.monotonic()))
            except queue.Empty:
                raise AssertionError(f"no {needle!r} line within {timeout}s") from None
            if line is None:
                raise AssertionError(f"process exited before {needle!r}: "
                                     f"{self.proc.stderr.read()[-2000:]}")
            if needle in line:
                return line


def _signed_req(scheme, seed_byte, rt, recipient, payload_byte, challenge):
    from grapevine_tpu_torch.wire import constants as C
    from grapevine_tpu_torch.wire.records import QueryRequest, RequestRecord

    sk, pub = scheme.keygen(bytes([seed_byte]) * 32)
    sig = scheme.sign(sk, C.GRAPEVINE_CHALLENGE_SIGNING_CONTEXT, challenge)
    req = QueryRequest(
        request_type=rt, auth_identity=pub, auth_signature=sig,
        record=RequestRecord(msg_id=C.ZERO_MSG_ID, recipient=recipient,
                             payload=bytes([payload_byte]) * C.PAYLOAD_SIZE),
    )
    return req, (pub, C.GRAPEVINE_CHALLENGE_SIGNING_CONTEXT, challenge, sig)


def test_live_flip_drill_zero_dropped_ops(tmp_path):
    """An engine-role primary shipping to a standby-role process, clients
    acknowledged over gRPC, SIGKILL the primary, SIGUSR1 the standby, and
    every acknowledged write is readable from the promoted engine port —
    zero dropped ops across the flip."""
    import json
    import urllib.error
    import urllib.request

    from grapevine_tpu_torch.server.tier import _EngineStub
    from grapevine_tpu_torch.session import get_signature_scheme
    from grapevine_tpu_torch.wire import constants as C
    from grapevine_tpu_torch.wire.records import QueryRequest, RequestRecord

    scheme = get_signature_scheme("schnorrkel")
    pdir, sdir = str(tmp_path / "primary"), str(tmp_path / "standby")
    for d in (pdir, sdir):
        os.makedirs(d)
        with open(os.path.join(d, "root.key"), "wb") as fh:
            fh.write(bytes(range(32)))
        os.chmod(os.path.join(d, "root.key"), 0o600)

    cli = [sys.executable, "-m", "grapevine_tpu_torch.server.cli", "--device", "cpu"]
    geometry = ["--msg-capacity", "64", "--recipient-capacity", "8", "--batch-size", "4",
                "--evict-every", "2", "--tree-top-cache-levels", "0",
                "--pipeline-depth", "1", "--batch-wait-ms", "30"]
    procs = []
    try:
        standby = subprocess.Popen(
            cli + ["--role", "standby", "--state-dir", sdir,
                   "--standby-listen", "127.0.0.1:0", "--promote-from", pdir,
                   "--engine-listen", "127.0.0.1:0", "--metrics-port", "0"] + geometry,
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        procs.append(standby)
        s_out = _Lines(standby)
        feed_port = int(s_out.wait("standby replica on port").rsplit(" ", 1)[1])
        mport = int(s_out.wait("metrics endpoint on port").rsplit(" ", 1)[1])

        primary = subprocess.Popen(
            cli + ["--role", "engine", "--engine-listen", "127.0.0.1:0",
                   "--state-dir", pdir, "--replicate-to", f"127.0.0.1:{feed_port}"] + geometry,
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        procs.append(primary)
        eport = int(_Lines(primary).wait("engine tier listening on port").rsplit(" ", 1)[1])

        # acknowledged writes: 3 messages into mailbox X + filler ops
        stub = _EngineStub(f"127.0.0.1:{eport}", deadline_s=60.0)
        _, x_pub = scheme.keygen(b"\x07" * 32)
        for i in range(8):
            req, auth = _signed_req(
                scheme, seed_byte=i + 10, rt=C.REQUEST_TYPE_CREATE,
                recipient=x_pub if i < 3 else bytes([i + 40]) * 32,
                payload_byte=0x70 + i, challenge=bytes([i + 1]) * C.CHALLENGE_SIZE)
            assert stub.submit(req, auth=auth).status_code == C.STATUS_CODE_SUCCESS, i
        stub.close()

        # the live feed has applied the acknowledged tail before the kill
        deadline = time.monotonic() + 60
        while True:
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{mport}/healthz",
                                            timeout=5) as r:
                    hz = json.loads(r.read().decode())
            except urllib.error.HTTPError as e:
                hz = json.loads(e.read().decode())
            if hz.get("replication_connected") and hz["durability"]["applied_seq"] >= 8:
                break
            assert time.monotonic() < deadline, f"standby never caught up: {hz}"
            time.sleep(0.2)

        primary.send_signal(signal.SIGKILL)
        primary.wait(timeout=30)
        standby.send_signal(signal.SIGUSR1)
        s_out.wait("standby promoted: epoch")
        pport = int(s_out.wait("promoted engine tier listening on port").rsplit(" ", 1)[1])

        # zero dropped: pops from mailbox X return the acknowledged payloads
        stub = _EngineStub(f"127.0.0.1:{pport}", deadline_s=60.0)
        x_sk, x_pub2 = scheme.keygen(b"\x07" * 32)
        assert x_pub2 == x_pub
        popped = []
        for i in range(3):
            challenge = bytes([0x80 + i]) * C.CHALLENGE_SIZE
            sig = scheme.sign(x_sk, C.GRAPEVINE_CHALLENGE_SIGNING_CONTEXT, challenge)
            req = QueryRequest(
                request_type=C.REQUEST_TYPE_DELETE, auth_identity=x_pub, auth_signature=sig,
                record=RequestRecord(msg_id=C.ZERO_MSG_ID, recipient=C.ZERO_PUBKEY,
                                     payload=b"\x00" * C.PAYLOAD_SIZE))
            resp = stub.submit(req, auth=(x_pub, C.GRAPEVINE_CHALLENGE_SIGNING_CONTEXT,
                                          challenge, sig))
            assert resp.status_code == C.STATUS_CODE_SUCCESS
            popped.append(resp.record.payload[0])
        assert popped == [0x70, 0x71, 0x72], popped
        # ...and the promoted engine keeps taking new writes
        req, auth = _signed_req(scheme, seed_byte=99, rt=C.REQUEST_TYPE_CREATE,
                                recipient=b"\x63" * 32, payload_byte=0x63,
                                challenge=b"\xaa" * C.CHALLENGE_SIZE)
        assert stub.submit(req, auth=auth).status_code == C.STATUS_CODE_SUCCESS
        stub.close()

        standby.send_signal(signal.SIGTERM)
        assert standby.wait(timeout=120) == 0, standby.stderr.read()[-2000:]
        procs = []
    finally:
        for p in procs:
            p.kill()
            p.wait(timeout=10)
