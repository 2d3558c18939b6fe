"""The scan vphases through the engine, held against the JAX package at
tolerance 0.

Multi-round CRUD campaigns through ``grapevine_tpu``'s jitted
``engine_round_step`` (and ``engine_flush_step`` at E > 1) and the
port's, both under ``vphases_impl="scan"``, fed the same batches and
random draws (the internal ORAMs' too under a recursive map), give equal
responses, transcripts and full state after every round and flush. The
JAX step is jitted as ``GrapevineEngine`` jits it. Each file runs one
geometry x two seeds (one JAX compile set): this one ``max_messages``
2^8, B=8, E=1, flat, ``"xla"``, plus a state carried across from a JAX
scan engine after two rounds of its own; ``_jax2`` 2^7, B=16, E=2,
``sort_impl="radix"``; ``_jax3`` a recursive map under scan (the scan
branch of ``posmap._group_last_slot``) and the admission walk's slow
branch within B of the bus quota.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from grapevine_tpu.config import GrapevineConfig as JConfig
from grapevine_tpu.engine.round_step import engine_flush_step as jax_flush
from grapevine_tpu.engine.state import EngineConfig as JEcfg, init_engine
from grapevine_tpu_torch.config import GrapevineConfig
from grapevine_tpu_torch.engine.batcher import batch_to_device
from grapevine_tpu_torch.engine.convert import first_difference, from_jax_state, to_numpy
from grapevine_tpu_torch.engine.round_step import (
    RoundDraws,
    engine_flush_step,
    engine_round_step,
)
from grapevine_tpu_torch.engine.state import EngineConfig
from grapevine_tpu_torch.u32 import from_numpy
from grapevine_tpu_torch.u32 import to_numpy as t2n
from grapevine_tpu_torch.wire import constants as C
from test_torch_engine import _jax_step, crud_batches, jax_draws
from test_torch_posmap_engine_jax import injected_draws, jax_state_leaves
from _torch_jax_cache import shared_jax_compile_cache  # noqa: F401

_jax_flush = jax.jit(jax_flush, static_argnums=(0,), donate_argnums=(1,))

#: the three geometries the scan engine is held against the JAX package at
SCAN_GEOS = {
    "flat": dict(max_messages=2**8, max_recipients=16, mailbox_cap=4, batch_size=8,
                 stash_size=64),
    "radix_e2": dict(max_messages=2**7, max_recipients=16, mailbox_cap=4,
                     batch_size=16, stash_size=96, evict_every=2, sort_impl="radix"),
    "recursive": dict(max_messages=64, max_recipients=8, mailbox_cap=4, batch_size=8,
                      stash_size=64, posmap_impl="recursive"),
}


def scan_configs(kw, impl: str = "jnp"):
    kw = dict(kw, vphases_impl="scan")
    jecfg = JEcfg.from_config(JConfig(**kw))
    tecfg = EngineConfig.from_config(GrapevineConfig(**kw, bucket_cipher_impl=impl))
    assert jecfg.vphases_impl == tecfg.vphases_impl == "scan"
    return jecfg, tecfg


def _draws(jecfg, tecfg, rng, b):
    if tecfg.posmap_impl == "recursive":
        return injected_draws(jecfg, rng, b)
    return RoundDraws(*(from_numpy(x, "cpu") for x in jax_draws(jecfg, rng, b)))


def run_scan_campaign(kw, seed: int, n_rounds: int = 4, impl: str = "jnp",
                      batches=None, jax_only: int = 0):
    """``n_rounds`` rounds (a flush every ``evict_every``) through both
    packages' scan engines, every step compared in full. The first
    ``jax_only`` rounds run on the JAX engine alone; its state is then
    carried across to the port. ``batches`` overrides the CRUD mix.
    Returns the (JAX) response status arrays."""
    jecfg, tecfg = scan_configs(kw, impl)
    jst = init_engine(jecfg, seed)
    tst = None
    mask = impl != "jnp"
    created: list = []
    b = tecfg.batch_size
    ee = tecfg.evict_every
    statuses = []
    if batches is None:
        batches = crud_batches(b, n_rounds, seed, lambda: created)
    for rnd, batch in enumerate(batches):
        where = f"seed {seed} round {rnd}"
        if rnd == jax_only:
            tst = from_jax_state(tecfg, jax_state_leaves(jst), device="cpu")
        draws = _draws(jecfg, tecfg, jst.rng, b) if tst is not None else None
        jst, jresp, jtr = _jax_step(jecfg, jst, {k: jnp.asarray(v) for k, v in batch.items()})
        if tst is not None:
            tst, tresp, ttr = engine_round_step(tecfg, tst, batch_to_device(batch, "cpu"),
                                                draws=draws)
            for k in jresp:
                np.testing.assert_array_equal(t2n(tresp[k]), np.asarray(jresp[k]),
                                              f"{where}: response {k}")
            np.testing.assert_array_equal(t2n(ttr), np.asarray(jtr), f"{where}: transcript")
            diff = first_difference(to_numpy(tst), jax_state_leaves(jst), mask_junk=mask)
            assert diff is None, f"{where}: state differs at {diff}"
        if ee > 1 and (rnd + 1) % ee == 0:
            jst = _jax_flush(jecfg, jst)
            if tst is not None:
                tst = engine_flush_step(tecfg, tst)
                diff = first_difference(to_numpy(tst), jax_state_leaves(jst), mask_junk=mask)
                assert diff is None, f"{where}: flush state differs at {diff}"
        st = np.asarray(jresp["status"])
        statuses.append(st)
        for i in np.flatnonzero((batch["req_type"] == C.REQUEST_TYPE_CREATE)
                                & (st == C.STATUS_CODE_SUCCESS)):
            created.append((np.asarray(jresp["msg_id"])[i].tobytes(),
                            batch["auth"][i].tobytes(), batch["recipient"][i].tobytes()))
    assert int(np.asarray(jst.rec.overflow)) == 0
    return statuses


@pytest.mark.parametrize("seed", [3, 8])
def test_scan_campaign_matches_jax_flat(seed):
    st = run_scan_campaign(SCAN_GEOS["flat"], seed, n_rounds=5)
    assert any((s == C.STATUS_CODE_SUCCESS).any() for s in st)


def test_jax_scan_state_carries_into_the_port_scan_engine():
    """Two rounds on the JAX scan engine alone, then its state converted
    and both run on: the port's scan engine continues it exactly."""
    run_scan_campaign(SCAN_GEOS["flat"], 5, n_rounds=5, jax_only=2)
