"""The port's engine programs through its taint analyzer at the
reference's smoke combination (``check_oblivious.SMOKE_COMBO``: dense,
xla, flat map, no cache, E=2): the round at both admission branches,
the flush and the sweep are free of violations outside the reviewed
allowlist, and every sink carries a site inside the package (census
equality: ``test_torch_oblint_engine3.py``). The reference's
engine-round audit is red under jax 0.9.0, so the port's result stands
alone here."""

from __future__ import annotations

import functools

import pytest

from grapevine_tpu_torch.analysis import check_oblivious as co
from grapevine_tpu_torch.analysis import fx_walk
from grapevine_tpu_torch.analysis.allowlist import ENGINE_ALLOWLIST
from _torch_threads import one_torch_thread  # noqa: F401


@functools.lru_cache(maxsize=None)
def _reports():
    """One capture per program of the smoke combo, shared by this file."""
    ecfg = co.small_engine(*co.SMOKE_COMBO)
    name = co.combo_name(co.SMOKE_COMBO)
    return {
        "round_fast": co.audit_engine_round(ecfg, ENGINE_ALLOWLIST, name, fast_ok=True,
                                            device="cpu"),
        "round_slow": co.audit_engine_round(ecfg, ENGINE_ALLOWLIST, name, fast_ok=False,
                                            device="cpu"),
        "flush": co.audit_engine_flush(ecfg, ENGINE_ALLOWLIST, name, device="cpu"),
        "sweep": co.audit_expiry_sweep(ecfg, ENGINE_ALLOWLIST, name, device="cpu"),
    }


@pytest.mark.parametrize("program", ["round_fast", "round_slow", "flush", "sweep"])
def test_smoke_programs_are_violation_free(program):
    rep = _reports()[program]
    assert co.SMOKE_COMBO[4] > 1  # the fetch-only round and its flush
    assert rep.ok, rep.summary()
    assert rep.n_eqns > 300 and sum(rep.allowed.values()) > 3


def test_round_audit_is_not_vacuous():
    for branch in ("round_fast", "round_slow"):
        rep = _reports()[branch]
        assert rep.n_eqns > 1000 and sum(rep.allowed.values()) > 20, rep.summary()


def test_every_sink_has_a_site_inside_the_package():
    """Sites are read off the Python stack when a node is made; every
    node of a sink op must carry one inside ``grapevine_tpu_torch``, or
    the allowlist keys would not mean what they say."""
    from grapevine_tpu_torch.analysis.oblint import KERNEL_ADDRESS_OPERANDS

    sinks = ("aten.index.", "aten.index_put.", "aten.gather.", "aten.scatter",
             "aten.index_add.", "aten.index_copy.", "aten.index_select.")
    for rep in _reports().values():
        seen = 0
        for node in fx_walk.walk_nodes(rep.capture.gm):
            names = fx_walk.node_ops(node)
            if any(n.startswith(sinks) or n.rsplit(".", 1)[0] in KERNEL_ADDRESS_OPERANDS
                   for n in names):
                site = fx_walk.site_of(node)
                assert site.split(":")[0].endswith(".py") and "/" in site, (names, site)
                assert not site.startswith("analysis/"), (names, site)
                seen += 1
        assert seen > 0, rep.name
