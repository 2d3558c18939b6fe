"""The cost model's traced half for the engine (rounds A+B+C at E=1 and
E=2, the flush, the expiry sweep's chunk passes): the port's captured
rows equal its analytic ledger and the reference's traced rows, per
shape class, at two geometries. The sweep's classes are keyed by plane
shape here and by the scan's ``[n_chunks, rows, ·]`` chunk shape in the
reference; each pass covers the whole plane in both."""

from __future__ import annotations

import pytest

from grapevine_tpu.analysis import costmodel as rcm
from grapevine_tpu_torch.analysis import costmodel as cm
from _torch_jax_cache import shared_jax_compile_cache  # noqa: F401

#: (max_messages log2, max_recipients log2, B, E): the reference's two
#: audit engines and a second geometry of each
ENGINES = [(8, 7, 4, 1), (8, 8, 2, 2), (9, 7, 4, 1), (9, 8, 2, 2)]


def _twin(log2m, log2r, b, e):
    from grapevine_tpu.config import GrapevineConfig as RC
    from grapevine_tpu.engine.state import EngineConfig as RE
    from grapevine_tpu_torch.config import GrapevineConfig
    from grapevine_tpu_torch.engine.state import EngineConfig

    kw = dict(max_messages=1 << log2m, max_recipients=1 << log2r, batch_size=b,
              evict_every=e)
    return EngineConfig.from_config(GrapevineConfig(**kw)), RE.from_config(RC(**kw))


@pytest.mark.parametrize("geo", ENGINES, ids=[f"m{g[0]}_r{g[1]}_b{g[2]}_e{g[3]}" for g in ENGINES])
def test_engine_round_and_flush_rows(geo):
    ecfg, recfg = _twin(*geo)
    ours = cm.traced_access_rows(cm.trace_engine_round(ecfg, "cpu"), cm.engine_planes(ecfg))
    assert ours == cm.predicted_access_rows(cm.engine_round_rows(ecfg))
    assert ours == rcm.traced_access_rows(rcm.trace_engine_round(recfg),
                                          rcm.engine_planes(recfg))
    if ecfg.evict_every > 1:
        fl = cm.traced_access_rows(cm.trace_engine_flush(ecfg, "cpu"), cm.engine_planes(ecfg))
        assert fl == cm.predicted_access_rows(cm.engine_flush_rows(ecfg))
        assert fl == rcm.traced_access_rows(rcm.trace_engine_flush(recfg),
                                            rcm.engine_planes(recfg))


@pytest.mark.parametrize("geo", ENGINES[:2] + ENGINES[3:],
                         ids=[f"m{g[0]}_e{g[3]}" for g in ENGINES[:2] + ENGINES[3:]])
def test_sweep_rows(geo):
    ecfg, recfg = _twin(*geo)
    chunk = {**cm.sweep_chunk_planes(ecfg.rec, "rec_"), **cm.sweep_chunk_planes(ecfg.mb, "mb_")}
    ours = cm.traced_scan_rows(cm.trace_expiry_sweep(ecfg, "cpu"), chunk)
    assert ours == cm.sweep_predicted_rows(ecfg)
    rchunk = {**rcm.sweep_chunk_planes(recfg.rec, "rec_"),
              **rcm.sweep_chunk_planes(recfg.mb, "mb_")}
    theirs = rcm.traced_scan_rows(rcm.trace_expiry_sweep(recfg), rchunk)
    assert ours == {(s[0] * s[1],) + tuple(s[2:]): rows for s, rows in theirs.items()}
