"""The cost model's traced half (``grapevine_tpu_torch/analysis/costmodel.py``)
for one ORAM's round and flush: the rows the port's captured graph moves
equal its analytic ledger AND the reference's traced rows
(``grapevine_tpu/analysis/costmodel.py:traced_access_rows`` over its
jaxpr), per operand shape class, at tolerance 0 — over cache-k ∈ {0, 2},
flat and recursive maps, E ∈ {1, 2}, at two geometries."""

from __future__ import annotations

import pytest

from grapevine_tpu.analysis import costmodel as rcm
from grapevine_tpu_torch.analysis import costmodel as cm
from _torch_jax_cache import shared_jax_compile_cache  # noqa: F401


def twin(height, blocks, k, *, cipher=8, recursive=False, e=1, f=0, buf=0):
    """The same geometry in both packages: (port cfg, reference cfg)."""
    from grapevine_tpu.oram.path_oram import OramConfig as RefOramConfig
    from grapevine_tpu.oram.posmap import derive_posmap_spec as ref_spec
    from grapevine_tpu_torch.oram.path_oram import OramConfig
    from grapevine_tpu_torch.oram.posmap import derive_posmap_spec

    out = []
    for cls, spec in ((OramConfig, derive_posmap_spec), (RefOramConfig, ref_spec)):
        pm = (spec(blocks, top_cache_levels=k, evict_window=e, evict_fetch_count=f)
              if recursive else None)
        out.append(cls(height=height, value_words=8, n_blocks=blocks, cipher_rounds=cipher,
                       top_cache_levels=k, posmap=pm, evict_window=e, evict_fetch_count=f,
                       evict_buffer_slots=buf))
    return tuple(out)


#: (name, height, blocks, b, k, kwargs): the reference's audit geometry
#: (height 5 / 7) and a second one (height 6 / 8), b·(path_len−k) off
#: every padded bucket count, flush targets unsaturated
ROUNDS = [
    ("h5_flat_k0", 5, 32, 8, 0, {}),
    ("h5_flat_k2", 5, 32, 8, 2, {}),
    ("h5_flat_k2_plaintext", 5, 32, 8, 2, {"cipher": 0}),
    ("h5_recursive_k2", 5, 32, 6, 2, {"recursive": True}),
    ("h7_flat_k2_e2", 7, 128, 8, 2, {"e": 2, "f": 8, "buf": 64}),
    ("h7_recursive_k2_e2", 7, 128, 6, 2, {"recursive": True, "e": 2, "f": 8, "buf": 64}),
    ("h6_flat_k0", 6, 64, 8, 0, {}),
    ("h6_flat_k2", 6, 64, 8, 2, {}),
    ("h6_recursive_k0", 6, 64, 6, 0, {"recursive": True}),
    ("h6_recursive_k2", 6, 64, 6, 2, {"recursive": True}),
    ("h8_flat_k0_e2", 8, 256, 8, 0, {"e": 2, "f": 8, "buf": 64}),
    ("h8_recursive_k2_e2", 8, 256, 6, 2, {"recursive": True, "e": 2, "f": 8, "buf": 64}),
]


@pytest.mark.parametrize("case", ROUNDS, ids=[c[0] for c in ROUNDS])
def test_round_rows_equal_ledger_and_reference(case):
    _, height, blocks, b, k, kw = case
    cfg, rcfg = twin(height, blocks, k, **kw)
    ours = cm.traced_access_rows(cm.trace_oram_round(cfg, b, "cpu"), cm.oram_planes(cfg))
    assert ours == cm.predicted_access_rows(cm.oram_round_rows(cfg, b))
    assert cm.oram_planes(cfg) == rcm.oram_planes(rcfg)
    assert ours == rcm.traced_access_rows(rcm.trace_oram_round(rcfg, b), rcm.oram_planes(rcfg))
    cm.cross_validate_round(cfg, b, device="cpu")


@pytest.mark.parametrize("case", [c for c in ROUNDS if "e" in c[5]],
                         ids=[c[0] for c in ROUNDS if "e" in c[5]])
def test_flush_rows_equal_ledger_and_reference(case):
    _, height, blocks, _, k, kw = case
    cfg, rcfg = twin(height, blocks, k, **kw)
    ours = cm.traced_access_rows(cm.trace_oram_flush(cfg, "cpu"), cm.oram_planes(cfg))
    assert ours == cm.predicted_access_rows(cm.oram_flush_rows(cfg))
    assert ours == rcm.traced_access_rows(rcm.trace_oram_flush(rcfg), rcm.oram_planes(rcfg))
    cm.cross_validate_flush(cfg, device="cpu")
