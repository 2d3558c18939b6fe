"""The range gate's default sweep at geometry 30 (records 2^30 a tree, the
states built under a fake tensor mode, nothing allocated), one of its
four knob combinations (the scan/recursive one): zero findings outside
the allowlist. The sweep is split over three files to keep each within
the tier-1 budget; the union's reachability is checked by the full gate
(``-m slow`` and the card's phase 20b)."""

from __future__ import annotations

import pytest

from grapevine_tpu_torch.analysis import check_ranges as cr
from _torch_threads import one_torch_thread  # noqa: F401

IDX = (1,)


@pytest.mark.parametrize("i", IDX)
def test_combination_certifies_clean_at_geometry_30(i):
    problems, hits, lines = cr.run_audit(
        (cr.DEFAULT_COMBOS[i],), cr.DEFAULT_GEOMETRY, device="cpu",
        cipher_impls=(cr.DEFAULT_CIPHER_IMPLS[i],))
    assert problems == []
    assert hits and all(ln["findings"] == 0 for ln in lines)
    if cr.DEFAULT_CIPHER_IMPLS[i] != "jnp":  # the kernels' address operands were audited
        assert any(ln["kernels"] for ln in lines)
