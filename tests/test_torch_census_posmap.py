"""The position-map census gate (``analysis/check_posmap_oblivious.py``)
against the reference tool (``tools/check_posmap_oblivious.py``): the same
access counts at the same geometry, and a lookup with a shortcut for
all-dummy batches is caught."""

from __future__ import annotations

import importlib.util
import os

import pytest
import torch

from grapevine_tpu_torch.analysis import check_posmap_oblivious as cpo
from _torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def reference_tool(name: str):
    """A ``tools/`` gate loaded under a name of its own."""
    spec = importlib.util.spec_from_file_location(f"ref_{name}",
                                                  os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ACCESS_KEYS = ("accesses", "gathers", "scatters")


def test_access_schedule_equals_the_reference():
    ref = reference_tool("check_posmap_oblivious").check_posmap_access_schedule(b=12)
    port = cpo.check_posmap_access_schedule(b=12, device="cpu")
    for impl in ("flat", "recursive"):
        assert {k: port[impl][k] for k in ACCESS_KEYS} == \
            {k: ref[impl][k] for k in ACCESS_KEYS}, impl
        assert port[impl]["census_size"] > 0
    assert port["flat"] == {"accesses": 2, "gathers": 1, "scatters": 1,
                            "census_size": port["flat"]["census_size"]}


@pytest.mark.parametrize("occ,srt", [("scan", "xla"), ("scan", "radix")])
def test_scan_dedup_schedules_are_index_blind(occ, srt):
    out = cpo.check_posmap_access_schedule(b=8, occ_impl=occ, sort_impl=srt, device="cpu")
    assert out["recursive"]["accesses"] > out["flat"]["accesses"] > 0


def test_all_dummy_shortcut_is_caught(monkeypatch):
    """A lookup that returns early when every index is the dummy reads the
    indices on the host and captures another program for that set."""
    from grapevine_tpu_torch.oram import posmap

    orig = posmap.lookup_remap_round

    def shortcut(cfg, pm_state, idxs, new_leaves, dummy_leaves, first_occ, last_occ,
                 *args, **kw):
        if bool((idxs == cfg.dummy_index).all()):
            inner = None if cfg.posmap is None else torch.zeros_like(dummy_leaves)
            return pm_state, dummy_leaves, inner
        return orig(cfg, pm_state, idxs, new_leaves, dummy_leaves, first_occ, last_occ,
                    *args, **kw)

    monkeypatch.setattr(posmap, "lookup_remap_round", shortcut)
    flat, _ = cpo.posmap_configs()
    with pytest.raises(AssertionError, match="DIFFERENT program|data-dependent control"):
        cpo.schedule_census(flat, 8, device="cpu", name="flat")


def test_a_host_read_is_a_control_node(monkeypatch):
    """The same lookup with the host read alone (no shortcut) captures one
    program for every index set, and is refused for its control node."""
    from grapevine_tpu_torch.oram import posmap

    orig = posmap.lookup_remap_round

    def peek(cfg, pm_state, idxs, *args, **kw):
        int(idxs.sum())
        return orig(cfg, pm_state, idxs, *args, **kw)

    monkeypatch.setattr(posmap, "lookup_remap_round", peek)
    flat, _ = cpo.posmap_configs()
    with pytest.raises(AssertionError, match="data-dependent control"):
        cpo.schedule_census(flat, 8, device="cpu", name="flat")


def test_main_passes_on_the_cpu(capsys):
    assert cpo.main(["--batch", "8", "--device", "cpu"]) == 0
    assert "[check_posmap_oblivious] PASS" in capsys.readouterr().out
