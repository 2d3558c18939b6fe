"""Timing uniformity of the port's rounds (the JAX package's
``tests/test_timing_uniformity.py`` is the model, case for case).

The reference's invariant covers timing, not only access patterns (the
upstream ``grapevine.proto:120-122``). Transcript equality cannot see a
timing channel, so this suite measures round walls on the host clock:
all-READ, all-UPDATE and all-DELETE rounds at one batch size must draw
from indistinguishable time distributions.

- One program serves every op mix in the port too: op semantics are
  masks over a fixed-shape round, never a branch on the op type. The
  admission branch depends on the quotas alone, and every measured round
  here is far from them. What this guards against is a change that adds
  op-keyed host work or an op-keyed launch.
- The kinds are interleaved in measurement order (R, U, D, R, ...) so
  host-load drift hits each kind alike.
- DELETE rounds target an absent id (NOT_FOUND), so the state is
  unchanged and every measured round sees the same bus: the failing
  path must cost what the succeeding one does (the upstream
  ``grapevine.proto:81-86``).
- The canary (``-m slow``) injects an op-keyed slowdown of one round's
  cost and asserts that the statistic flags it.

Each engine is the port's facade on the CPU, ChaCha8 at rest.
"""


from __future__ import annotations

import time

import numpy as np
import pytest

from grapevine_tpu_torch.config import GrapevineConfig
from grapevine_tpu_torch.engine.batcher import GrapevineEngine
from grapevine_tpu_torch.testing.leakcheck import timing_twosample_z
from grapevine_tpu_torch.wire import constants as C
from grapevine_tpu_torch.wire.records import QueryRequest, RequestRecord
from _torch_threads import one_torch_thread  # noqa: F401

NOW = 1_700_000_000
N_ROUNDS = 30  # per condition
#: |z| threshold for honest rounds: Mann-Whitney z ~ N(0,1) under the
#: null; 4.5 is a ~7e-6 false-positive cut per comparison
HONEST_Z = 4.5


def _mk_engine(batch=8):
    cfg = GrapevineConfig(
        max_messages=256,
        max_recipients=32,
        mailbox_cap=8,
        batch_size=batch,
        bucket_cipher_rounds=8,
    )
    return GrapevineEngine(cfg, seed=3, device="cpu"), cfg


def _populate(eng, cfg, n=16):
    """Create n records (spread over recipients under the 62/8-cap);
    returns (ids, recips, sender)."""
    ids = []
    recips = []
    sender = b"\x31" * 32
    bs = cfg.batch_size
    per_recip = max(1, cfg.mailbox_cap // 2)
    reqs = [
        QueryRequest(
            request_type=C.REQUEST_TYPE_CREATE,
            auth_identity=sender,
            record=RequestRecord(
                recipient=bytes([0x40 + i // per_recip]) * 32,
                payload=bytes([i]) * C.PAYLOAD_SIZE,
            ),
        )
        for i in range(n)
    ]
    for i in range(0, n, bs):
        for j, r in enumerate(eng.handle_queries(reqs[i : i + bs], NOW)):
            assert r.status_code == C.STATUS_CODE_SUCCESS, r.status_code
            ids.append(r.record.msg_id)
            recips.append(reqs[i + j].record.recipient)
    return ids, recips, sender


def _round_reqs(kind: str, ids, recips, sender, bs):
    if kind == "read":
        return [
            QueryRequest(
                request_type=C.REQUEST_TYPE_READ,
                auth_identity=sender,
                record=RequestRecord(msg_id=ids[j % len(ids)]),
            )
            for j in range(bs)
        ]
    if kind == "update":
        return [
            QueryRequest(
                request_type=C.REQUEST_TYPE_UPDATE,
                auth_identity=sender,
                record=RequestRecord(
                    msg_id=ids[j % len(ids)],
                    recipient=recips[j % len(ids)],
                    payload=bytes([j]) * C.PAYLOAD_SIZE,
                ),
            )
            for j in range(bs)
        ]
    # delete of ABSENT ids: NOT_FOUND, state unchanged, same touches
    absent = bytes([0xEE]) * 15 + b"\x01"
    return [
        QueryRequest(
            request_type=C.REQUEST_TYPE_DELETE,
            auth_identity=sender,
            record=RequestRecord(msg_id=absent, recipient=recips[0]),
        )
        for _ in range(bs)
    ]


def _measure(eng, cfg, ids, recips, sender, slow_delete_s: float = 0.0):
    """Interleaved R/U/D round times; returns {kind: np.ndarray}."""
    bs = cfg.batch_size
    kinds = ("read", "update", "delete")
    reqs = {k: _round_reqs(k, ids, recips, sender, bs) for k in kinds}
    # warmup: compile + settle every condition once
    for k in kinds:
        eng.handle_queries(reqs[k], NOW)
    times: dict[str, list[float]] = {k: [] for k in kinds}
    for _ in range(N_ROUNDS):
        for k in kinds:
            t0 = time.perf_counter()
            out = eng.handle_queries(reqs[k], NOW)
            if k == "delete" and slow_delete_s:
                time.sleep(slow_delete_s)  # canary: op-keyed slowdown
            times[k].append(time.perf_counter() - t0)
            assert len(out) == bs
    return {k: np.asarray(v) for k, v in times.items()}


def test_rud_round_times_indistinguishable():
    eng, cfg = _mk_engine()
    ids, recips, sender = _populate(eng, cfg)
    times = _measure(eng, cfg, ids, recips, sender)
    z_ru = timing_twosample_z(times["read"], times["update"])
    z_rd = timing_twosample_z(times["read"], times["delete"])
    z_ud = timing_twosample_z(times["update"], times["delete"])
    assert abs(z_ru) < HONEST_Z, f"read-vs-update timing z={z_ru:.2f}"
    assert abs(z_rd) < HONEST_Z, f"read-vs-delete timing z={z_rd:.2f}"
    assert abs(z_ud) < HONEST_Z, f"update-vs-delete timing z={z_ud:.2f}"


@pytest.mark.slow  # wall-clock noise inside a concurrent tier-1 run can
# pull the canary's z under its cut (the reference's stated reason); a
# randomized timing campaign, so it rides -m slow as the reference's
# does. The honest-timing assertion stays always-on.
def test_timing_canary_has_teeth():
    """A deliberate op-keyed slowdown (1× the round cost — e.g. a
    second ORAM pass only DELETE pays) must be flagged loudly, proving
    the detector catches an op-keyed cost difference.

    Note the rank statistic saturates: with N=30 per condition the
    maximum |z| at complete separation is sqrt(3·N²/(2N+1)) ≈ 6.65, so
    the canary cut sits between HONEST_Z and that ceiling."""
    eng, cfg = _mk_engine()
    ids, recips, sender = _populate(eng, cfg)
    # estimate the round cost to scale the injected delta
    t0 = time.perf_counter()
    eng.handle_queries(_round_reqs("read", ids, recips, sender, cfg.batch_size), NOW)
    per_round = time.perf_counter() - t0
    times = _measure(
        eng, cfg, ids, recips, sender, slow_delete_s=max(per_round, 5e-3)
    )
    z_rd = timing_twosample_z(times["read"], times["delete"])
    assert abs(z_rd) > HONEST_Z + 1, f"canary not detected: z={z_rd:.2f}"


def test_detector_statistics_sane():
    rng = np.random.default_rng(0)
    a = rng.normal(1.0, 0.1, 200)
    b = rng.normal(1.0, 0.1, 200)
    assert abs(timing_twosample_z(a, b)) < 4
    c = rng.normal(1.25, 0.1, 200)  # clearly shifted
    assert abs(timing_twosample_z(a, c)) > 10
    # ties + empty inputs do not crash
    assert timing_twosample_z(np.ones(50), np.ones(50)) == pytest.approx(0, abs=1e-9)
    assert timing_twosample_z(np.ones(0), np.ones(5)) == 0.0
