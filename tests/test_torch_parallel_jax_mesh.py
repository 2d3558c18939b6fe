"""The port's sharded step and flush against the JAX package's OWN
sharded programs (``make_sharded_step``, ``make_sharded_flush``) on the
conftest's 8-device CPU mesh, in the plaintext 2-shard E=2 geometry of
``tests/test_parallel.py:test_sharded_flush_matches_single_chip_fast``:
equal responses, transcripts and logical state after every round and
flush, and each device's shard of every tree and nonce plane equal to
the port's shard on the same mesh position (its scratch row left out) —
the same contiguous heap ranges."""

import jax
import jax.numpy as jnp
import numpy as np

from grapevine_tpu.config import GrapevineConfig as JConfig
from grapevine_tpu.engine.state import EngineConfig as JEcfg, init_engine
from grapevine_tpu.parallel import (
    make_mesh as jmake_mesh,
    make_sharded_flush as jmake_flush,
    make_sharded_step as jmake_step,
    shard_engine_state as jshard,
)
from grapevine_tpu_torch.config import GrapevineConfig
from grapevine_tpu_torch.engine.batcher import batch_to_device
from grapevine_tpu_torch.engine.convert import first_difference, from_jax_state, to_numpy
from grapevine_tpu_torch.engine.round_step import RoundDraws
from grapevine_tpu_torch.engine.state import EngineConfig
from grapevine_tpu_torch.parallel import (
    make_mesh,
    make_sharded_flush,
    make_sharded_step,
    shard_engine_state,
)
from grapevine_tpu_torch.u32 import from_numpy
from grapevine_tpu_torch.u32 import to_numpy as t2n
from grapevine_tpu_torch.wire import constants as C
from test_torch_engine import crud_batches, jax_draws, jax_leaves
from _torch_jax_cache import shared_jax_compile_cache  # noqa: F401

KW = dict(max_messages=64, max_recipients=8, mailbox_cap=4, batch_size=4, stash_size=64,
          bucket_cipher_rounds=0, evict_every=2, vphases_impl="dense")


def _same_shards(tst, jst, where):
    for name in ("rec", "mb"):
        jo, to = getattr(jst, name), getattr(tst, name)
        for f in ("tree_idx", "tree_val", "nonces"):
            jx = getattr(jo, f)
            got = [t2n(s) for s in getattr(to, f).local()]
            want = [np.asarray(s.data) for s in
                    sorted(jx.addressable_shards, key=lambda s: s.index[0].start or 0)]
            assert len(got) == len(want) == 2, f"{where}: {name}.{f} shard count"
            for i, (g, w) in enumerate(zip(got, want)):
                np.testing.assert_array_equal(g, w, f"{where}: {name}.{f} shard {i}")


def test_port_mesh_matches_jax_mesh():
    assert len(jax.devices()) >= 2, "conftest forces an 8-device CPU mesh"
    jecfg = JEcfg.from_config(JConfig(**KW))
    tecfg = EngineConfig.from_config(GrapevineConfig(**KW, shards=2))
    jmesh = jmake_mesh(jax.devices()[:2])
    jst = jshard(init_engine(jecfg, seed=3), jmesh)
    jstep, jflush = jmake_step(jecfg, jmesh), jmake_flush(jecfg, jmesh)
    mesh = make_mesh(["cpu", "cpu"])
    tst = shard_engine_state(from_jax_state(tecfg, jax_leaves(jst), device="cpu"), mesh)
    step, flush = make_sharded_step(tecfg, mesh), make_sharded_flush(tecfg, mesh)
    _same_shards(tst, jst, "init")
    created: list = []
    b = tecfg.batch_size
    for rnd, batch in enumerate(crud_batches(b, 5, 3, lambda: created)):
        where = f"round {rnd}"
        draws = RoundDraws(*(from_numpy(x, "cpu") for x in jax_draws(jecfg, jst.rng, b)))
        jst, jresp, jtr = jstep(jst, {k: jnp.asarray(v) for k, v in batch.items()})
        tst, tresp, ttr = step(tst, batch_to_device(batch, "cpu"), draws=draws)
        for k in jresp:
            np.testing.assert_array_equal(t2n(tresp[k]), np.asarray(jresp[k]),
                                          f"{where}: response {k}")
        np.testing.assert_array_equal(t2n(ttr), np.asarray(jtr), f"{where}: transcript")
        if rnd % 2 == 1:
            jst, tst = jflush(jst), flush(tst)
            where += " + flush"
        diff = first_difference(to_numpy(tst), jax_leaves(jst), mask_junk=False)
        assert diff is None, f"{where}: state differs at {diff}"
        _same_shards(tst, jst, where)
        st = np.asarray(jresp["status"])
        for i in np.flatnonzero((batch["req_type"] == C.REQUEST_TYPE_CREATE)
                                & (st == C.STATUS_CODE_SUCCESS)):
            created.append((np.asarray(jresp["msg_id"])[i].tobytes(),
                            batch["auth"][i].tobytes(), batch["recipient"][i].tobytes()))
    assert len(created) > 0
    assert int(tst.rec.ebuf_gen) == 3  # two flushes ran
