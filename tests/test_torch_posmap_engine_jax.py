"""The recursive position map and the radix sort through the engine, held
against the JAX package at tolerance 0.

Multi-round CRUD campaigns through ``grapevine_tpu``'s
``engine_round_step`` (and ``engine_flush_step``, ``expiry_sweep``) and
the port's, with ``posmap_impl="recursive"`` and ``sort_impl="radix"``,
fed the same batches and random draws — the internal ORAMs' leaves too,
computed from the JAX ``state.rng`` as the reference's
``round_step.py:224-240`` does and injected as ``RoundDraws.pm`` — give
equal responses, ``[B, 2(2D+1)]`` transcripts and full state (both
internal trees and the leaf planes included) after every round, flush
and sweep. Each file runs one geometry x two seeds (one JAX compile
set): this one E=1 at ``g1`` under the jnp cipher; ``_jax2`` E=1 at
``g2`` with the port's ``"pallas_fused_tiled"``; ``_jax3`` E=2 at ``g1``
with ``"pallas_fused"``; ``_jax4`` E=2 at ``g2`` under jnp.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from grapevine_tpu.config import GrapevineConfig as JConfig
from grapevine_tpu.engine.expiry import expiry_sweep as jax_sweep
from grapevine_tpu.engine.round_step import engine_flush_step as jax_flush
from grapevine_tpu.engine.state import EngineConfig as JEcfg, init_engine
from grapevine_tpu.oram.posmap import read_table as jread
from grapevine_tpu_torch.config import GrapevineConfig
from grapevine_tpu_torch.engine.batcher import batch_to_device
from grapevine_tpu_torch.engine.convert import first_difference, from_jax_state, to_numpy
from grapevine_tpu_torch.engine.expiry import expiry_sweep
from grapevine_tpu_torch.engine.round_step import (
    PosmapDraws,
    RoundDraws,
    engine_flush_step,
    engine_round_step,
)
from grapevine_tpu_torch.engine.state import EngineConfig
from grapevine_tpu_torch.oram import posmap as tpm
from grapevine_tpu_torch.u32 import from_numpy
from grapevine_tpu_torch.u32 import to_numpy as t2n
from grapevine_tpu_torch.wire import constants as C
from test_torch_engine import GEOMETRIES, NOW, _jax_step, crud_batches, jax_draws
from test_torch_posmap import jflat

U32 = jnp.uint32

_jax_flush = jax.jit(jax_flush, static_argnums=(0,), donate_argnums=(1,))
_jax_sweep = jax.jit(jax_sweep, static_argnums=(0,))

#: the sweep after the campaign: what the first rounds wrote is older
#: than the period and expires
SWEEP = (NOW + 40, 37)


def jax_state_leaves(st) -> dict:
    """A JAX ``EngineState`` as the port's dotted leaves (``convert``)."""
    out = {}
    for name in ("rec", "mb"):
        out.update({f"{name}.{k}": v for k, v in jflat(getattr(st, name)).items()})
    for k in ("freelist", "free_top", "recipients", "seq", "hash_key", "id_key"):
        out[k] = np.asarray(getattr(st, k))
    return out


def jax_pm_draws(jecfg, rng, b) -> list:
    """The reference round's internal-ORAM draws, as round_step.py:229-240."""
    d = jecfg.mb_choices
    mbm = U32(jecfg.mb.posmap.inner_leaves - 1)
    recm = U32(jecfg.rec.posmap.inner_leaves - 1)
    kpm = jax.random.split(jax.random.fold_in(rng, 0x504D), 6)
    sizes = ((b * d, mbm), (b * d, mbm), (b, recm), (b, recm), (b * d, mbm), (b * d, mbm))
    return [np.asarray(jax.random.bits(k, (n,), U32) & m) for k, (n, m) in zip(kpm, sizes)]


def injected_draws(jecfg, rng, b) -> RoundDraws:
    main = (from_numpy(x, "cpu") for x in jax_draws(jecfg, rng, b))
    pm = PosmapDraws(*(from_numpy(x, "cpu") for x in jax_pm_draws(jecfg, rng, b)))
    return RoundDraws(*main, pm=pm)


def _configs(geo, evict_every, impl):
    kw = dict(GEOMETRIES[geo], vphases_impl="dense", posmap_impl="recursive",
              sort_impl="radix", evict_every=evict_every)
    jecfg = JEcfg.from_config(JConfig(**kw))
    tecfg = EngineConfig.from_config(GrapevineConfig(**kw, bucket_cipher_impl=impl))
    return jecfg, tecfg


def _check(tst, jst, where, mask):
    diff = first_difference(to_numpy(tst), jax_state_leaves(jst), mask_junk=mask)
    assert diff is None, f"{where}: state differs at {diff}"


def run_recursive_campaign(geo: str, seed: int, evict_every: int, impl: str = "jnp",
                           n_rounds: int = 4):
    """``n_rounds`` CRUD rounds (a flush every ``evict_every``), a sweep,
    one more round; every step compared in full. The reference runs its
    jnp cipher, the port ``impl``'s plain version (junk masked)."""
    jecfg, tecfg = _configs(geo, evict_every, impl)
    for tree in ("rec", "mb"):  # EngineConfig derives both specs as the reference
        assert (dataclasses.asdict(getattr(tecfg, tree).posmap)
                == dataclasses.asdict(getattr(jecfg, tree).posmap))
    jst = init_engine(jecfg, seed)
    tst = from_jax_state(tecfg, jax_state_leaves(jst), device="cpu")
    assert tst.pm_rng is not None
    mask = impl != "jnp"
    created: list = []
    b = tecfg.batch_size
    d = tecfg.mb_choices
    batches = list(crud_batches(b, n_rounds + 1, seed, lambda: created))
    for rnd, batch in enumerate(batches):
        where = f"{geo}/E={evict_every}/{impl} round {rnd}"
        if rnd == n_rounds:
            jst = _jax_sweep(jecfg, jst, *SWEEP)
            tst = expiry_sweep(tecfg, tst, SWEEP[0], SWEEP[1], 0)
            _check(tst, jst, f"{where}: sweep", mask)
            batch = dict(batch, now=np.uint32(SWEEP[0] + 1))
        draws = injected_draws(jecfg, jst.rng, b)
        jst, jresp, jtr = _jax_step(jecfg, jst, {k: jnp.asarray(v) for k, v in batch.items()})
        tst, tresp, ttr = engine_round_step(tecfg, tst, batch_to_device(batch, "cpu"),
                                            draws=draws)
        for k in jresp:
            np.testing.assert_array_equal(t2n(tresp[k]), np.asarray(jresp[k]),
                                          f"{where}: response {k}")
        assert tuple(ttr.shape) == (b, 2 * (2 * d + 1))
        np.testing.assert_array_equal(t2n(ttr), np.asarray(jtr), f"{where}: transcript")
        _check(tst, jst, where, mask)
        if evict_every > 1 and (rnd + 1) % evict_every == 0:
            jst = _jax_flush(jecfg, jst)
            tst = engine_flush_step(tecfg, tst)
            _check(tst, jst, f"{where}: flush", mask)
        st = np.asarray(jresp["status"])
        for i in np.flatnonzero((batch["req_type"] == C.REQUEST_TYPE_CREATE)
                                & (st == C.STATUS_CODE_SUCCESS)):
            created.append((np.asarray(jresp["msg_id"])[i].tobytes(),
                            batch["auth"][i].tobytes(), batch["recipient"][i].tobytes()))
    for tree, jtree, cfg in ((tst.rec, jst.rec, tecfg.rec), (tst.mb, jst.mb, tecfg.mb)):
        assert int(tree.overflow) == 0 == int(tree.posmap.inner.overflow)
        jcfg = jecfg.rec if cfg is tecfg.rec else jecfg.mb
        np.testing.assert_array_equal(tpm.read_table(cfg, tree.posmap),
                                      jread(jcfg, jtree.posmap))
    return created


@pytest.mark.parametrize("seed", [2, 7])
def test_recursive_radix_campaign_matches_jax(seed):
    assert len(run_recursive_campaign("g1", seed, 1)) > 0
