"""Gated concurrency stress of the port's pipelined scheduler and server
(the JAX package's ``tests/test_server_stress.py`` is the model).

Set ``GRAPEVINE_STRESS=seconds`` to run (skipped by default, as the
reference's is). Six client threads hammer one ``GrapevineServer`` on the
CPU with mixed CRUD, mid-traffic re-auths and hand-rolled queries with a
bad signature (``grapevine_tpu_torch/testing/soak.py:stress``); then
every thread has finished (no deadlock in the pipeline's drain paths),
every response was protocol-consistent, each bad signature was refused
and counted, and the engine's aggregates are in range.
"""

import os

import pytest

from grapevine_tpu_torch.config import GrapevineConfig
from grapevine_tpu_torch.server.service import GrapevineServer
from grapevine_tpu_torch.testing.soak import stress
from _torch_threads import one_torch_thread  # noqa: F401

STRESS_S = float(os.environ.get("GRAPEVINE_STRESS", "0"))

pytestmark = pytest.mark.skipif(
    STRESS_S <= 0, reason="set GRAPEVINE_STRESS=<seconds> to run"
)


def test_concurrent_stress_with_churn_and_bad_signatures():
    cfg = GrapevineConfig(
        bucket_cipher_rounds=0,
        max_messages=1 << 10,
        max_recipients=64,
        batch_size=8,
        stash_size=128,
    )
    srv = GrapevineServer(config=cfg, seed=1, device="cpu")
    try:
        port = srv.start("insecure-grapevine://127.0.0.1:0")
        tallies = stress(f"insecure-grapevine://127.0.0.1:{port}", STRESS_S)
        h = srv.health()
        assert h["stash_overflow"] == 0
        assert tallies["bad_sig"] > 0
        assert h["auth_failures"] >= tallies["bad_sig"]
        assert 0 <= h["messages"] <= cfg.max_messages
        assert h["real_ops"] > 0 and h["rounds"] > 0
        print(f"stress ok: {h['real_ops']} ops in {h['rounds']} rounds "
              f"(occupancy {h['batch_occupancy']:.2f}), {h['auth_failures']} bad "
              f"signatures rejected, {h['messages']} live messages")
    finally:
        srv.stop()
