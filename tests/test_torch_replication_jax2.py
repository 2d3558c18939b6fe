"""The hot-standby drill of ``test_torch_replication_jax.py`` at a second
geometry (2^8 messages, B=16, a two-level tree-top cache, depth 2), two
seeds: the standby journals byte-identical, the promote records equal,
the promoted states equal leaf for leaf (junk masked) and the next round's
responses and transcripts equal, at tolerance 0."""

import pytest

from test_torch_replication_jax import run_drill

GEO = dict(max_messages=256, max_recipients=32, mailbox_cap=8, batch_size=16,
           stash_size=96, evict_every=2, vphases_impl="dense", pipeline_depth=2,
           bucket_cipher_rounds=8, tree_top_cache_levels=2)


@pytest.mark.parametrize("seed", [5, 23])
def test_standby_drill_matches_reference(tmp_path, monkeypatch, seed):
    run_drill(tmp_path, monkeypatch, GEO, seed)
