"""The cost model's traced half on a 2-shard virtual mesh, its nine
undercount mutants, and its knob verdicts, each held against the
reference.

The port captures every shard's owner-masked flush in one graph, each
shard's planes ``[n/2 + 1, ·]`` (its heap range and scratch row); the
reference traces one chip's ``shard_map`` body, planes ``[n/2, ·]``. So
a sharded class carries 2x the reference's per-chip rows, and a
replicated class (the inner position map) the same rows."""

from __future__ import annotations

import os

import pytest

from grapevine_tpu.analysis import costmodel as rcm
from grapevine_tpu_torch.analysis import costmodel as cm
from _torch_jax_cache import shared_jax_compile_cache  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def twin(height, blocks, f, recursive):
    from grapevine_tpu.oram.path_oram import OramConfig as RefOramConfig
    from grapevine_tpu.oram.posmap import derive_posmap_spec as ref_spec
    from grapevine_tpu_torch.oram.path_oram import OramConfig
    from grapevine_tpu_torch.oram.posmap import derive_posmap_spec

    geo = dict(height=height, value_words=8, n_blocks=blocks, cipher_rounds=8,
               top_cache_levels=2, evict_window=2, evict_fetch_count=f, evict_buffer_slots=64)
    return tuple(cls(**geo, posmap=spec(blocks, top_cache_levels=2, evict_window=2,
                                        evict_fetch_count=f) if recursive else None)
                 for cls, spec in ((OramConfig, derive_posmap_spec),
                                   (RefOramConfig, ref_spec)))


#: the reference's sharded-flush geometry (height 7, F=6) and a second one
MESH = [(7, 128, 6, False), (7, 128, 6, True), (8, 256, 6, False), (8, 256, 6, True)]


@pytest.mark.parametrize("geo", MESH, ids=[f"h{g[0]}_{'rec' if g[3] else 'flat'}" for g in MESH])
def test_sharded_flush_rows(geo):
    cfg, rcfg = twin(*geo)
    cm.cross_validate_sharded_flush(cfg, 2, device="cpu")
    local = cm.shard_local_rows(cm.oram_flush_rows(cfg), 2)
    ours = cm.traced_access_rows(cm.trace_oram_flush(cfg, "cpu", 2),
                                 {n: (p.shape, p.divisor) for n, p in local.items()})
    rlocal = rcm.shard_local_rows(rcm.oram_flush_rows(rcfg), 2)
    theirs = rcm.traced_access_rows(rcm.trace_sharded_oram_flush(rcfg, 2),
                                    {n: (p.shape, p.divisor) for n, p in rlocal.items()})
    n_local = cfg.n_buckets_padded // 2
    mapped = {}
    for (shape, div), (g, s) in theirs.items():
        if shape[0] == n_local:  # a sharded plane: both shards' programs
            mapped[((n_local + 1,) + tuple(shape[1:]), div)] = (2 * g, 2 * s)
        else:
            mapped[(shape, div)] = (g, s)
    assert ours == mapped


def test_cost_mutants_are_the_references_and_all_caught():
    assert cm.cost_mutant_names() == tuple(rcm._COST_MUTANTS)
    results = cm.run_cost_mutants("cpu")
    for name, (rep, kind, hit) in results.items():
        assert kind == rcm._COST_MUTANTS[name][3], name
        assert hit and [m.kind for m in rep.findings] == [kind], name
        assert isinstance(rep.findings[0], cm.CostModelMismatch)


def _grade_calls() -> list:
    """Every ``ab_verdict`` call ``tools/check_cost_model.py`` makes to
    grade the banked A/B trajectory, as (kwargs, the reference's result)."""
    import importlib
    import sys

    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        tool = importlib.import_module("check_cost_model")
    finally:
        sys.path.pop(0)
    calls, orig = [], tool.cm.ab_verdict

    def spy(kind, **kw):
        res = orig(kind, **kw)
        calls.append(((kind, kw), res))
        return res

    tool.cm.ab_verdict = spy
    try:
        tool.grade_trajectory(tool.TRAJECTORY)
    finally:
        tool.cm.ab_verdict = orig
    return calls


def test_ab_verdicts_equal_the_references():
    calls = _grade_calls()
    kinds = {(k, kw.get("scope", "machinery")) for (k, kw), _ in calls}
    assert {"sort", "tree_cache", "evict", "sharded_evict", "pipeline"} <= {k for k, _ in kinds}
    for (kind, kw), ref in calls:
        ours = cm.ab_verdict(kind, **kw)
        assert ours["winner"] == ref["winner"], (kind, kw)
        assert set(ours["arms"]) == set(ref["arms"])
        for arm, d in ref["arms"].items():
            if "modeled_bytes" in d:
                a, b = ours["arms"][arm]["modeled_bytes"], d["modeled_bytes"]
                assert abs(a - b) <= 1e-12 * max(abs(b), 1), (kind, kw, arm)
    assert cm.TIE_BAND == rcm.TIE_BAND
    with open(os.path.join(REPO, "BENCH_trajectory.jsonl")) as fh:
        assert sum(1 for ln in fh if ln.strip()) > 0


def test_grade_waits_and_the_gate_runs_on_the_card_unless_asked():
    import torch

    from grapevine_tpu_torch.analysis import check_cost_model

    assert check_cost_model.main(["--grade"]) == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            check_cost_model.main(["--smoke"])
