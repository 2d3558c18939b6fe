"""The port's sharded engine step held against the JAX package's
single-chip ``engine_round_step`` at tolerance 0 — the mesh contract.

Multi-round CRUD campaigns through ``grapevine_tpu``'s jitted
``engine_round_step`` (and ``engine_flush_step``, ``expiry_sweep``) and
the port's ``make_sharded_step`` (``make_sharded_flush``, the sweep on
the sharded state) over a virtual mesh of 2 or 4 CPU shards, fed the same
batches and random draws (computed from the JAX ``state.rng`` as the
reference does), give equal responses, transcripts and full logical
state — every leaf, the padded junk bucket included — after every round,
flush and sweep. The reference runs its jnp cipher (its Pallas kernels
give the same words); the port runs ``"pallas"`` and ``"pallas_fused"``,
whose sharded path decrypts and encrypts through the row cipher (B2's
plain version on the CPU) and never reaches a fused gather or scatter.

This file runs geometry ``g1`` at E=1; ``_step2`` ``g2`` (k=2 cache, one
mailbox choice); ``_step3`` the recursive map with a k=2 cache; ``_step4``
an E=2 window with its flush. One JAX compile set each.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from grapevine_tpu.config import GrapevineConfig as JConfig
from grapevine_tpu.engine.state import EngineConfig as JEcfg, init_engine
from grapevine_tpu_torch.config import GrapevineConfig
from grapevine_tpu_torch.engine.batcher import batch_to_device
from grapevine_tpu_torch.engine.convert import first_difference, from_jax_state, to_numpy
from grapevine_tpu_torch.engine.expiry import expiry_sweep
from grapevine_tpu_torch.engine.round_step import RoundDraws
from grapevine_tpu_torch.engine.state import EngineConfig
from grapevine_tpu_torch.oram import path_oram, round as round_mod
from grapevine_tpu_torch.oram.path_oram import ShardedPlane
from grapevine_tpu_torch.parallel import (
    make_mesh,
    make_sharded_flush,
    make_sharded_step,
    shard_engine_state,
)
from grapevine_tpu_torch.u32 import from_numpy
from grapevine_tpu_torch.u32 import to_numpy as t2n
from grapevine_tpu_torch.wire import constants as C
from test_torch_engine import GEOMETRIES, _jax_step, crud_batches, jax_draws
from test_torch_posmap_engine_jax import (
    SWEEP,
    _jax_flush,
    _jax_sweep,
    injected_draws,
    jax_state_leaves,
)
from _torch_jax_cache import shared_jax_compile_cache  # noqa: F401


def _check(tst, jst, where):
    # the sharded write-back never touches the junk bucket, nor does the
    # reference's jnp scatter: every byte compares
    diff = first_difference(to_numpy(tst), jax_state_leaves(jst), mask_junk=False)
    assert diff is None, f"{where}: state differs at {diff}"


def _no_fused(monkeypatch):
    """Make any fused gather or scatter call fail, and count the row
    cipher's calls (the kernel's wrapper, B2)."""
    calls = {"cipher_rows_pallas": 0}
    real = path_oram.cipher_rows_pallas

    def counted(*a, **k):
        calls["cipher_rows_pallas"] += 1
        return real(*a, **k)

    def refuse(*a, **k):
        raise AssertionError("a fused kernel was called on the sharded path")

    monkeypatch.setattr(path_oram, "cipher_rows_pallas", counted)
    for name in ("gather_decrypt_rows", "gather_decrypt_rows_tiled",
                 "scatter_encrypt_rows", "scatter_encrypt_rows_tiled"):
        monkeypatch.setattr(round_mod, name, refuse)
    return calls


def run_sharded_campaign(geo: str, seed: int, impl: str, shards: int, monkeypatch,
                         evict_every: int = 1, recursive: bool = False,
                         n_rounds: int = 4):
    """``n_rounds`` CRUD rounds (a flush every ``evict_every``), a sweep,
    one more round; every step compared in full against the reference's
    single-chip programs."""
    kw = dict(GEOMETRIES[geo], vphases_impl="dense", evict_every=evict_every)
    if recursive:
        kw["posmap_impl"] = "recursive"
    jecfg = JEcfg.from_config(JConfig(**kw))
    tecfg = EngineConfig.from_config(GrapevineConfig(**kw, bucket_cipher_impl=impl,
                                                     shards=shards))
    mesh = make_mesh(["cpu"] * shards)
    step = make_sharded_step(tecfg, mesh)
    flush = make_sharded_flush(tecfg, mesh) if evict_every > 1 else None
    calls = _no_fused(monkeypatch)
    jst = init_engine(jecfg, seed)
    tst = shard_engine_state(from_jax_state(tecfg, jax_state_leaves(jst), device="cpu"),
                             mesh)
    for tree in (tst.rec, tst.mb):
        assert isinstance(tree.tree_val, ShardedPlane) and len(tree.tree_val.shards) == shards
        assert isinstance(tree.nonces, ShardedPlane) and isinstance(tree.tree_idx, ShardedPlane)
        assert isinstance(tree.tree_leaf, ShardedPlane) == recursive
    created: list = []
    b = tecfg.batch_size
    batches = list(crud_batches(b, n_rounds + 1, seed, lambda: created))
    for rnd, batch in enumerate(batches):
        where = f"{geo}/{impl}/{shards} shards/E={evict_every} round {rnd}"
        if rnd == n_rounds:
            jst = _jax_sweep(jecfg, jst, *SWEEP)
            tst = expiry_sweep(tecfg, tst, SWEEP[0], SWEEP[1], 0)
            _check(tst, jst, f"{where}: sweep")
            batch = dict(batch, now=np.uint32(SWEEP[0] + 1))
        draws = (injected_draws(jecfg, jst.rng, b) if recursive else
                 RoundDraws(*(from_numpy(x, "cpu") for x in jax_draws(jecfg, jst.rng, b))))
        jst, jresp, jtr = _jax_step(jecfg, jst, {k: jnp.asarray(v) for k, v in batch.items()})
        tst, tresp, ttr = step(tst, batch_to_device(batch, "cpu"), draws=draws)
        for k in jresp:
            np.testing.assert_array_equal(t2n(tresp[k]), np.asarray(jresp[k]),
                                          f"{where}: response {k}")
        np.testing.assert_array_equal(t2n(ttr), np.asarray(jtr), f"{where}: transcript")
        _check(tst, jst, where)
        if flush is not None and (rnd + 1) % evict_every == 0:
            jst = _jax_flush(jecfg, jst)
            tst = flush(tst)
            _check(tst, jst, f"{where}: flush")
        st = np.asarray(jresp["status"])
        for i in np.flatnonzero((batch["req_type"] == C.REQUEST_TYPE_CREATE)
                                & (st == C.STATUS_CODE_SUCCESS)):
            created.append((np.asarray(jresp["msg_id"])[i].tobytes(),
                            batch["auth"][i].tobytes(), batch["recipient"][i].tobytes()))
    assert len(tst.rec.tree_val.shards) == shards  # still sharded after the sweep
    assert int(tst.rec.overflow) == int(tst.mb.overflow) == 0
    # every decrypt and encrypt went through the row cipher
    assert calls["cipher_rows_pallas"] > 0
    return created


@pytest.mark.parametrize("impl,shards", [("pallas", 2), ("pallas_fused", 4)])
@pytest.mark.parametrize("seed", [3, 4])
def test_sharded_step_matches_single_chip_g1(seed, impl, shards, monkeypatch):
    assert len(run_sharded_campaign("g1", seed, impl, shards, monkeypatch)) > 0
