"""The scan vphases through the engine against the JAX package: a
recursive position map under scan (its internal rounds dedup with the
sorted masks and ``posmap._group_last_slot`` takes its scan branch), and
the admission walk's slow branch — three batches of creates against a
16-message bus, so from the second round on ``free_top`` < B. The
campaign and its checks are ``test_torch_vphases_scan_engine_jax.py``'s."""

import numpy as np
import pytest

from grapevine_tpu_torch.wire import constants as C
from test_torch_engine import NOW, PW
from test_torch_vphases_scan_engine_jax import SCAN_GEOS, run_scan_campaign
from _torch_jax_cache import shared_jax_compile_cache  # noqa: F401

#: the bus within B of full after one round of creates; mailbox_cap
#: raised so the bus quota binds before the per-recipient cap
SAT_BUS = dict(max_messages=16, max_recipients=8, mailbox_cap=16, batch_size=8,
               stash_size=96)


@pytest.mark.parametrize("seed", [2, 7])
def test_scan_campaign_matches_jax_recursive(seed):
    st = run_scan_campaign(SCAN_GEOS["recursive"], seed, n_rounds=4)
    assert any((s == C.STATUS_CODE_SUCCESS).any() for s in st)


def _create_batches(seed, n_rounds, b):
    rng = np.random.default_rng(seed)
    a, x = bytes([1]) * 32, bytes([2]) * 32
    for rnd in range(n_rounds):
        yield {"req_type": np.full(b, C.REQUEST_TYPE_CREATE, np.uint32),
               "auth": np.tile(np.frombuffer(a, "<u4"), (b, 1)),
               "msg_id": np.zeros((b, 4), np.uint32),
               "recipient": np.tile(np.frombuffer(x, "<u4"), (b, 1)),
               "payload": rng.integers(0, 2**32, (b, PW), dtype=np.uint64).astype(np.uint32),
               "now": np.uint32(NOW + rnd), "now_hi": np.uint32(0)}


@pytest.mark.parametrize("seed", [9, 4])
def test_scan_saturation_slow_branch_matches_jax(seed):
    b = SAT_BUS["batch_size"]
    st = run_scan_campaign(SAT_BUS, seed, batches=list(_create_batches(seed, 3, b)))
    # the quota was hit, so rounds 2-3 ran the sequential admission walk
    assert (st[-1] == C.STATUS_CODE_TOO_MANY_MESSAGES).any()
