"""The range witness (``rangelint.witness``): a real capture of an engine
round, replayed by an interpreter that reads every integer node's
minimum and maximum under its lane, stays inside the intervals the
analyzer certified, and the replay equals the eager round on every word.
The card runs the same check at the production point (``chip_smoke.py``
phase 20c); here it runs on the CPU at a toy size, through the kernels'
plain versions."""

from __future__ import annotations

import pytest
import torch

from grapevine_tpu_torch.analysis import check_oblivious as co
from grapevine_tpu_torch.analysis import fx_walk, rangelint
from grapevine_tpu_torch.analysis.allowlist import RANGE_ALLOWLIST
from grapevine_tpu_torch.config import GrapevineConfig
from grapevine_tpu_torch.engine import round_step
from grapevine_tpu_torch.engine.state import EngineConfig, init_engine
from _torch_threads import one_torch_thread  # noqa: F401


def _round(impl: str):
    ecfg = EngineConfig.from_config(GrapevineConfig(
        max_messages=2**10, max_recipients=2**6, batch_size=16, bucket_cipher_impl=impl))
    state = init_engine(ecfg, 3, device="cpu")
    batch = co.census_variants(ecfg, "cpu")["mixed"]
    draws = co.engine_draws(ecfg, state, "cpu")

    def fn(st, ba, dr):
        return round_step.engine_round_step(ecfg, st, ba, draws=dr, fast_ok=True)

    cap = fx_walk.capture(fn, state, batch, draws, names=("state", "batch", "draws"),
                          tracing_mode="real")
    flat = [t for v, n in zip((state, batch, draws), ("state", "batch", "draws"))
            for t in fx_walk.flatten(v, n)[1]]
    rep = rangelint.audit_ranges(cap, round_step.RANGELINT_BOUNDS(ecfg), RANGE_ALLOWLIST)
    return ecfg, fn, (state, batch, draws), flat, rep


@pytest.mark.parametrize("impl", ["pallas_fused_tiled", "pallas"])
def test_observed_values_lie_inside_the_certified_intervals(impl):
    ecfg, fn, args, flat, rep = _round(impl)
    assert rep.ok, rep.summary()
    w = rangelint.witness(rep, *flat)
    assert w["violations"] == [] and w["checked"] > 500 and w["margin"] >= 0
    eager = fx_walk.flatten(fn(*args), "out")[1]
    assert len(eager) == len(w["out"])
    assert all(torch.equal(a, b) for a, b in zip(w["out"], eager))


def test_the_witness_catches_a_wrong_certificate():
    """Teeth: narrow one certified interval below what the round computes
    and the witness reports that node."""
    _, _, _, flat, rep = _round("pallas_fused_tiled")
    node = next(n for n, iv in rep.intervals.items()
                if n.op == "call_function" and iv.hi - iv.lo > 4 and not iv.tag
                and fx_walk.op_name(n.target) == "aten.arange.default")
    iv = rep.intervals[node]
    rep.intervals[node] = iv._replace(hi=iv.lo)
    w = rangelint.witness(rep, *flat)
    assert [v[0] for v in w["violations"]] == [node.name]
