"""The knob's followers, held against the JAX package at a scan geometry:

- ``analysis/costmodel.engine_cost_ledger``'s occurrence machinery
  defaults from ``ecfg.vphases_impl``: a scan engine's ledger equals the
  reference's scan ledger in every phase;
- the facade's calibrations run the scan round's sorts: the sort sites
  of ``calibrate_sort_phase`` (group sorts by kind) and
  ``calibrate_posmap_phase`` (sorted dedup masks) are the reference's,
  counted by wrapping the sort functions both packages call;
- the sizing helpers ``tree_cache_private_bytes``,
  ``evict_buffer_private_bytes`` and ``tree_occupancy`` equal the
  reference's.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grapevine_tpu.analysis import costmodel as rcm
from grapevine_tpu.config import GrapevineConfig as JConfig
from grapevine_tpu.engine.state import EngineConfig as JEcfg
from grapevine_tpu.oram import path_oram as jpo
from grapevine_tpu_torch.analysis import costmodel
from grapevine_tpu_torch.config import GrapevineConfig
from grapevine_tpu_torch.engine.state import EngineConfig
from grapevine_tpu_torch.oram import path_oram as tpo
from grapevine_tpu_torch.u32 import from_numpy
from _torch_jax_cache import shared_jax_compile_cache  # noqa: F401

GEOS = [
    dict(max_messages=2**10, max_recipients=64, batch_size=8, tree_top_cache_levels=0),
    dict(max_messages=2**12, max_recipients=2**8, batch_size=32, evict_every=2,
         tree_top_cache_levels=2, sort_impl="radix"),
    dict(max_messages=2**10, max_recipients=64, batch_size=16, evict_every=4,
         posmap_impl="recursive", mailbox_choices=2),
]


def _ecfgs(geo, v="scan"):
    kw = dict(geo, vphases_impl=v)
    return EngineConfig.from_config(GrapevineConfig(**kw)), JEcfg.from_config(JConfig(**kw))


@pytest.mark.parametrize("geo", GEOS, ids=["e1", "e2-radix", "e4-recursive"])
def test_cost_ledger_occ_follows_vphases_impl(geo):
    ecfg, jecfg = _ecfgs(geo)
    ours, theirs = costmodel.engine_cost_ledger(ecfg), rcm.engine_cost_ledger(jecfg)
    for ph in costmodel.COST_PHASES:
        assert vars(ours.phases[ph]) == vars(theirs.phases[ph]), ph
    assert ours.steady_round_sort_keys == theirs.steady_round_sort_keys
    dense, _ = _ecfgs(geo, "dense")
    assert vars(ours.phases["writeback"]) == vars(
        costmodel.engine_cost_ledger(dense, occ_impl="scan").phases["writeback"])
    assert ours.steady_round_sort_keys != costmodel.engine_cost_ledger(
        dense).steady_round_sort_keys


def _count(monkeypatch, mod, names, counts, depth, also=()):
    """Count the outermost calls of each of ``names`` (a sort site; a
    sort one of them makes inside another is not counted) through
    ``mod`` and through any module in ``also`` that binds the same name
    at import. ``depth`` is a one-item list shared by the wrappers."""
    for name in names:
        for other in also:
            if other is not mod and hasattr(other, name):
                _count(monkeypatch, other, (name,), counts, depth)
        fn = getattr(mod, name)

        def wrapped(*a, _fn=fn, _name=name, **k):
            if not depth[0]:
                counts[_name] = counts.get(_name, 0) + 1
            depth[0] += 1
            try:
                return _fn(*a, **k)
            finally:
                depth[0] -= 1

        monkeypatch.setattr(mod, name, wrapped)


SORTS = ("group_sort", "multiword_group_sort")
RADIX = ("radix_group_sort", "radix_rank")
OCC = ("occurrence_masks", "occurrence_masks_sorted")


@pytest.mark.parametrize("sort_impl", ["xla", "radix"])
def test_calibrations_run_the_scan_rounds_sorts(monkeypatch, sort_impl):
    """Per calibration run, the port reaches each sort function from the
    calibration as often as the reference's jitted workload does when it
    is traced (once per site): the scan round's dedup, index and
    recipient group sorts and the sorted dedup masks of the three ORAM
    rounds."""
    import grapevine_tpu.oblivious.radix as jrx
    import grapevine_tpu.oblivious.segmented as jseg
    import grapevine_tpu.oram.round as jround
    import grapevine_tpu_torch.oblivious.radix as trx
    import grapevine_tpu_torch.oblivious.segmented as tseg
    import grapevine_tpu_torch.oram.round as tround
    from grapevine_tpu.engine.batcher import GrapevineEngine as JEngine
    from grapevine_tpu_torch.engine.batcher import GrapevineEngine

    kw = dict(max_messages=64, max_recipients=8, mailbox_cap=4, batch_size=8,
              stash_size=64, vphases_impl="scan", sort_impl=sort_impl)
    teng = GrapevineEngine(GrapevineConfig(**kw), device="cpu")
    jeng = JEngine(JConfig(**kw))
    reps = 2
    for phase, mods in (("sort", ((jseg, tseg, SORTS), (jrx, trx, RADIX))),
                        ("posmap", ((jround, tround, OCC),))):
        jc, tc = {}, {}
        with monkeypatch.context() as m:
            jd, td = [0], [0]
            for jm, tm, names in mods:
                _count(m, jm, names, jc, jd, also=(jseg,))
                _count(m, tm, names, tc, td, also=(tseg,))
            getattr(jeng, f"calibrate_{phase}_phase")(reps=reps)
            getattr(teng, f"calibrate_{phase}_phase")(reps=reps)
        per_run = {k: v // (reps + 1) for k, v in tc.items()}
        assert per_run == jc, (phase, per_run, jc)
        assert sum(v for k, v in jc.items() if k != "radix_rank") > 0
        snap = teng.metrics.snapshot()
        assert any(phase in str(k) for k in snap)


@pytest.mark.parametrize("geo", GEOS, ids=["e1", "e2-radix", "e4-recursive"])
def test_sizing_helpers_equal_reference(geo):
    ecfg, jecfg = _ecfgs(geo)
    for t, j in ((ecfg.rec, jecfg.rec), (ecfg.mb, jecfg.mb)):
        assert tpo.tree_cache_private_bytes(t) == jpo.tree_cache_private_bytes(j)
        assert tpo.evict_buffer_private_bytes(t) == jpo.evict_buffer_private_bytes(j)
    rng = np.random.default_rng(1)
    idx = rng.integers(0, 2**32, 64, dtype=np.uint64).astype(np.uint32)
    idx[rng.random(64) < 0.4] = 0xFFFFFFFF  # the empty-slot sentinel
    jst = types.SimpleNamespace(tree_idx=jnp.asarray(idx))
    tst = types.SimpleNamespace(tree_idx=from_numpy(idx, "cpu"))
    assert int(tpo.tree_occupancy(tst)) == int(jpo.tree_occupancy(jst))
    assert isinstance(tpo.tree_occupancy(tst), torch.Tensor)
