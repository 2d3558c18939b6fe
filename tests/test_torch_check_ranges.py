"""The range gate (``grapevine_tpu_torch/analysis/check_ranges.py``): its
smoke run, the allowlist's contract, and the certified-geometry guard
held against the reference's edges. The geometry-30 default sweep runs
in ``test_torch_check_ranges30*.py`` (two knob combinations a file) and,
end to end with its reachability check, under ``-m slow``."""

from __future__ import annotations

import pytest

from grapevine_tpu_torch.analysis import check_ranges as cr
from grapevine_tpu_torch.analysis.allowlist import RANGE_ALLOWLIST
from _torch_threads import one_torch_thread  # noqa: F401


def test_smoke_gate_on_the_cpu():
    assert cr.main(["--smoke", "--device", "cpu"]) == 0


def test_gate_runs_on_the_card_unless_asked():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is the card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cr.main(["--smoke"])


def test_toy_audit_exercises_the_allowlist_and_reachability_accounting():
    problems, hits, lines = cr.run_audit((cr.SMOKE_COMBO,), cr.SMOKE_GEOMETRY, device="cpu",
                                         with_subrounds=False)
    assert problems == []
    assert sum(hits.values()) > 100 and len(lines) == 4
    assert "aten.add@oblivious/bucket_cipher.py:_qr" in hits
    dead = cr.check_allowlist_reachability(hits)
    assert len(dead) == len([e for e in RANGE_ALLOWLIST if e.key not in hits]) > 0
    assert all("dead range-allowlist entry" in d for d in dead)
    assert cr.check_allowlist_reachability({e.key: 1 for e in RANGE_ALLOWLIST}) == []


def test_every_entry_has_its_argument_and_reference():
    keys = [e.key for e in RANGE_ALLOWLIST]
    assert len(keys) == len(set(keys))
    for e in RANGE_ALLOWLIST:
        assert e.prim.startswith("aten.") and ":" in e.site
        assert len(e.reason) > 40 and ("ref " in e.reason or "no ref entry" in e.reason), e.key


@pytest.mark.parametrize("height,blocks", [(29, None), (30, None), (29, 1 << 30),
                                          (29, (1 << 30) + 1)])
def test_guard_edges_match_the_reference(height, blocks):
    from grapevine_tpu.oram.path_oram import OramConfig as RefOramConfig
    from grapevine_tpu_torch.oram.path_oram import OramConfig

    def outcome(cls):
        try:
            cls(height=height, value_words=1, n_blocks=blocks)
        except ValueError as exc:
            assert "certified bound" in str(exc)
            return False
        return True

    assert outcome(OramConfig) == outcome(RefOramConfig)


def test_design_point_is_refused_by_both_packages():
    import importlib
    import sys
    import os

    tools = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools")
    sys.path.insert(0, tools)
    try:
        ref_gate = importlib.import_module("check_ranges")
    finally:
        sys.path.remove(tools)
    problems, refusal = cr.certify_design_point(cr.DESIGN_POINT)
    ref_problems, ref_refusal = ref_gate.certify_design_point(ref_gate.DESIGN_POINT)
    assert problems == ref_problems == [] and cr.DESIGN_POINT == ref_gate.DESIGN_POINT == 36
    assert "certified bound" in refusal and "certified" in ref_refusal
    assert refusal.split(" exceeds")[0] == ref_refusal.split(" exceeds")[0] == "height 35"


def test_journal_blob_len_guard_refuses_as_the_reference():
    """The host prong of the anchors (``engine/journal.py``): a batch whose
    sealed frame cannot fit the u32 blob_len field refuses at
    construction, in both packages; a sane one constructs."""
    from grapevine_tpu.engine.journal import BatchJournal as RefJournal
    from grapevine_tpu_torch.engine.journal import BatchJournal

    class _HugeBatch:
        batch_size = 1 << 23

    class _Sane:
        batch_size = 4

    for cls in (BatchJournal, RefJournal):
        with pytest.raises(ValueError, match="blob_len"):
            cls("/nonexistent/x", b"\x00" * 32, _HugeBatch())
        cls("/nonexistent/x", b"\x00" * 32, _Sane())


@pytest.mark.slow
def test_full_certification_at_the_certified_geometry_and_the_design_point():
    """The acceptance sweep end to end: every shipped combination at 2^30
    with every allowlist entry reached, then the 2^36 refusal."""
    assert cr.main(["--geometry", "30", "--device", "cpu"]) == 0
    assert cr.main(["--geometry", "36", "--device", "cpu", "--skip-mutants"]) == 0
