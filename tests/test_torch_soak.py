"""Gated randomized soak of the port: engine ≡ oracle over many seeds and
configurations (the JAX package's ``tests/test_soak.py`` is the model).

The campaigns are skipped by default, as the reference's are; set
``GRAPEVINE_SOAK=N`` to run N seeded campaigns on the CPU, each a full
randomized CRUD session (25 batches with same-key hazards) against the
port's oracle, then a drain to empty through the sweep, cycling tree
density, cipher rounds, batch size and cipher impl
(``grapevine_tpu_torch/testing/soak.py``; the reference's ``"pallas"``
takes each of the port's three kernel impls in turn, their plain
versions on the CPU). One ungated case pins that a campaign runs on the
card unless the CPU is asked for.
"""

import os

import pytest

from grapevine_tpu_torch.testing.soak import SMALL, campaign, variant_config
from _torch_threads import one_torch_thread  # noqa: F401

N_SOAK = int(os.environ.get("GRAPEVINE_SOAK", "0"))


@pytest.mark.skipif(N_SOAK <= 0, reason="set GRAPEVINE_SOAK=N to run N soak campaigns")
@pytest.mark.parametrize("i", range(max(N_SOAK, 0)))
def test_soak_campaign(i):
    out = campaign(variant_config(i), seed=1000 + i, device="cpu")
    assert out["ops"] > 0 and out["rounds"] > 0


def test_campaign_runs_on_the_card_unless_asked():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is the card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        campaign(SMALL, seed=0)
