"""The six range mutants (``grapevine_tpu_torch/analysis/mutants.py``):
the reference's names, each caught for the reference's finding kind, and
none covered by the production ``RANGE_ALLOWLIST``."""

from __future__ import annotations

from grapevine_tpu.analysis.allowlist import RANGE_ALLOWLIST as REF_ALLOWLIST
from grapevine_tpu.analysis.mutants import range_mutant_names as ref_names
from grapevine_tpu.analysis.mutants import run_range_mutants as ref_run
from grapevine_tpu_torch.analysis.allowlist import RANGE_ALLOWLIST
from grapevine_tpu_torch.analysis.mutants import (
    control_failures,
    range_mutant_names,
    run_range_mutants,
)
from _torch_jax_cache import shared_jax_compile_cache  # noqa: F401


def test_names_are_the_references():
    assert range_mutant_names() == ref_names()
    assert len(range_mutant_names()) == 6


def test_each_caught_for_the_references_kind():
    ours = run_range_mutants(RANGE_ALLOWLIST)
    theirs = ref_run(REF_ALLOWLIST)
    for name in range_mutant_names():
        rep, kind, hit = ours[name]
        assert hit and kind == theirs[name][1] and theirs[name][2], (name, rep.summary())
        assert kind in {f.kind for f in rep.findings}
    lines = []
    assert control_failures(ours, "range mutant", lines.append) == []
    assert len(lines) == 6 and all(ln.endswith("FAIL (expected)") for ln in lines)


def test_the_production_allowlist_covers_none():
    for name, (rep, _, _) in run_range_mutants(RANGE_ALLOWLIST).items():
        assert rep.allowed == {}, (name, rep.allowed)
