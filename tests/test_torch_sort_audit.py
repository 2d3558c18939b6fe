"""The radix zero-sort audit (``analysis/check_sort_radix.py``) against the
reference's (``tests/test_sort_radix.py:149-207``): the radix ORAM round
captures no sort and the xla one some, and the engine round's radix
residue sits at the reference's wide-key sites, as many sorts as the
reference counts there."""

from __future__ import annotations

import functools
from collections import Counter

import jax
import jax.numpy as jnp

from grapevine_tpu_torch.analysis import check_sort_radix as csr
from grapevine_tpu_torch.analysis.fx_walk import sort_census
from _torch_jax_cache import shared_jax_compile_cache  # noqa: F401


def reference_sort_sites(sort_impl: str, b: int = 32) -> Counter:
    """The reference engine round's ``sort`` equations by site, at the
    reference audit's configuration."""
    from grapevine_tpu.analysis.jaxpr_walk import site_of, walk_eqns
    from grapevine_tpu.config import GrapevineConfig
    from grapevine_tpu.engine.round_step import engine_round_step
    from grapevine_tpu.engine.state import (ID_WORDS, KEY_WORDS, PAYLOAD_WORDS, EngineConfig,
                                            init_engine)

    ecfg = EngineConfig.from_config(GrapevineConfig(
        max_messages=1 << 10, max_recipients=1 << 6, mailbox_cap=4, batch_size=b,
        bucket_cipher_rounds=0, stash_size=128, vphases_impl="scan", sort_impl=sort_impl))
    state = jax.eval_shape(lambda: init_engine(ecfg, 0))
    u32 = jnp.uint32

    def s(*shape):
        return jax.ShapeDtypeStruct(shape, u32)

    batch = {"req_type": s(b), "auth": s(b, KEY_WORDS), "msg_id": s(b, ID_WORDS),
             "recipient": s(b, KEY_WORDS), "payload": s(b, PAYLOAD_WORDS), "now": s(),
             "now_hi": s()}
    jx = jax.make_jaxpr(functools.partial(engine_round_step, ecfg))(state, batch)
    return Counter(site_of(e) for e in walk_eqns(jx) if e.primitive.name == "sort")


def test_radix_oram_round_captures_zero_sorts():
    out = csr.check_oram_round(device="cpu")
    assert out["radix"] == 0 and out["xla"] > 0


def test_engine_round_residue_is_the_references_wide_key_sites():
    port = csr.check_engine_round(device="cpu")
    ref_radix, ref_xla = reference_sort_sites("radix"), reference_sort_sites("xla")
    assert sum(ref_radix.values()) < sum(ref_xla.values())
    # every residual port site maps to a site of the reference's residue
    assert {csr.RADIX_RESIDUE[s][0] for s in port["radix"]} <= set(ref_radix)
    # counted as the reference counts them, the residue is the reference's
    assert port["radix_as_reference"] == sum(ref_radix.values()) <= csr.REFERENCE_RESIDUE_BOUND
    for site, n in port["radix"].items():
        ref_site, unit, _ = csr.RADIX_RESIDUE[site]
        if unit == "node":
            assert n == ref_radix[ref_site], site
    assert port["radix_nodes"] < port["xla_nodes"]


def test_an_unmapped_sort_fails_the_audit(monkeypatch):
    """A bounded-key sort left in the radix round (the eviction's leaf sort
    kept as a comparison sort) is refused."""
    from grapevine_tpu_torch.engine.state import EngineConfig
    from grapevine_tpu_torch.oram import round as round_mod

    orig = round_mod._assign_evictions

    def keeps_xla(cfg, valid, wleaf, bucket_map, n_targets, nslots, slot_of, sort_impl):
        return orig(cfg, valid, wleaf, bucket_map, n_targets, nslots, slot_of, "xla")

    monkeypatch.setattr(round_mod, "_assign_evictions", keeps_xla)
    radix = csr.capture_engine_round(EngineConfig.from_config(
        csr.engine_round_config("radix")), "cpu")
    xla = csr.capture_engine_round(EngineConfig.from_config(csr.engine_round_config("xla")),
                                   "cpu")
    assert sort_census(radix.gm)["oram/round.py:_assign_evictions"] > 0
    try:
        csr.engine_sort_residue(radix.gm, xla.gm)
    except AssertionError as exc:
        assert "oram/round.py:_assign_evictions" in str(exc)
    else:
        raise AssertionError("the audit passed a bounded-key sort")


def test_main_passes_on_the_cpu(capsys):
    assert csr.main(["--device", "cpu"]) == 0
    assert "[check_sort_radix] PASS" in capsys.readouterr().out
