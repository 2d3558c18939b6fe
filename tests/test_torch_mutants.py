"""The port's seeded mutants (``grapevine_tpu_torch/analysis/mutants.py``):
the reference's nine obliviousness mutants under the same names, each
caught by the port's analyzer for its own reason under the production
allowlist. The reference's mutant matrix is red under jax 0.9.0, so the
port's verdicts stand alone; the names are held against the reference's."""

from __future__ import annotations

import functools

import pytest

from grapevine_tpu.analysis.mutants import mutant_names as ref_mutant_names
from grapevine_tpu_torch.analysis.allowlist import ENGINE_ALLOWLIST
from grapevine_tpu_torch.analysis.mutants import control_failures, mutant_names, run_mutants
from _torch_jax_cache import shared_jax_compile_cache  # noqa: F401


@functools.lru_cache(maxsize=None)
def _results():
    return run_mutants(ENGINE_ALLOWLIST)


def test_names_equal_the_references():
    assert mutant_names() == ref_mutant_names()
    assert len(mutant_names()) == 9


@pytest.mark.parametrize("name", ref_mutant_names())
def test_mutant_caught_for_its_own_reason(name):
    rep, kind, hit = _results()[name]
    kinds = [v.kind for v in rep.violations]
    assert hit and kinds.count(kind) >= 1, (name, kind, kinds)
    # the finding names the mutant's secret, or the capture stopped on it
    for v in rep.violations:
        if v.kind == kind and kind not in ("trace-dependence", "program-mismatch"):
            assert v.labels, v


def test_secret_shaped_output_has_census_teeth():
    """Its fake capture records an unbacked size; two concrete secrets
    capture programs of different shapes (``census_equal``)."""
    rep, _, _ = _results()["secret_shaped_output"]
    assert {"trace-dependence", "program-mismatch"} <= {v.kind for v in rep.violations}


def test_control_failures_reports_a_toothless_mutant():
    rep, kind, _ = _results()["key_indexed_gather"]
    lines = []
    failures = control_failures({"x": (rep, kind, False)}, "mutant", lines.append)
    assert lines == ["mutant x: PASSED — NO TEETH"] and len(failures) == 1
    assert control_failures(_results(), "mutant", lines.append) == []


def test_check_oblivious_smoke_gate():
    """The gate's tier-1 budget end to end: the smoke combo's round at
    both admission branches, every mutant, locklint and importlint."""
    from grapevine_tpu_torch.analysis import check_oblivious

    assert check_oblivious.main(["--smoke", "--device", "cpu"]) == 0
