"""CI gate: the radix sort knob sheds every bounded-key sort (port of the
reference's sort audit, ``tests/test_sort_radix.py:149-207``).

On captured graphs (:func:`.fx_walk.sort_census`, sort-family nodes by
site):

1. a ``sort_impl="radix"`` ``oram_round`` (scan dedup, eviction under the
   knob) captures ZERO sort nodes;
2. positive control: the ``"xla"`` round captures more than zero, so the
   counter sees the ops (1) asserts away;
3. a whole ``engine_round_step`` captures strictly fewer sorts under radix
   than under xla, and every residual sort site is one of the reference's
   wide-key sites (:data:`RADIX_RESIDUE`): the 256-bit recipient grouping
   and the u64 ``seq`` entry order, which no counting pass of a bounded
   key can replace;
4. the residue counted in the reference's sort ops stays within the
   reference's bound (:data:`REFERENCE_RESIDUE_BOUND`).

The port's counts differ from the reference's by construction, and are
matched site by site: ``oblivious/segmented.py:multiword_group_sort`` is
one multi-operand sort in the reference and ``ceil(words / 2)`` stable
passes here (a chain of passes is one reference sort), and
``oblivious/primitives.py:lex_argsort`` is two single-key argsorts a call
in both. The flush's public dedup sort (``oram/round.py:oram_flush``)
is not in an E=1 round.

    python -m grapevine_tpu_torch.analysis.check_sort_radix [--device cpu]
"""

from __future__ import annotations

import sys

from ..device import resolve_device
from .fx_walk import SORT_OPS, capture, fake_inputs, node_ops, site_of, sort_census, walk_nodes

#: port site of a residual sort -> (the reference's site, how its nodes
#: count as the reference's sort ops: "run" = a chain of passes, each
#: sorting keys permuted by the one before, is one; "node" = one each;
#: why the key is wide)
RADIX_RESIDUE = {
    "oblivious/segmented.py:multiword_group_sort": (
        "oblivious/segmented.py:multiword_group_sort", "run",
        "the 256-bit recipient grouping (one multi-operand sort in the reference)"),
    "oblivious/primitives.py:lex_argsort": (
        "oblivious/primitives.py:lex_argsort", "node",
        "the u64 seq entry order (two single-key argsorts a call in both)"),
}
#: the reference's bound on a radix engine round's sort ops
REFERENCE_RESIDUE_BOUND = 5


def oram_round_cfg():
    """The reference audit's ORAM geometry (height 6, 128 blocks of 4 words)."""
    from ..oram.path_oram import OramConfig

    return OramConfig(height=6, value_words=4, n_blocks=128)


def engine_round_config(sort_impl: str, b: int = 32):
    """The reference audit's engine configuration (``vphases_impl="scan"``)."""
    from ..config import GrapevineConfig

    return GrapevineConfig(max_messages=1 << 10, max_recipients=1 << 6, mailbox_cap=4,
                           batch_size=b, bucket_cipher_rounds=0, stash_size=128,
                           vphases_impl="scan", sort_impl=sort_impl)


def capture_oram_round(cfg, b: int, sort_impl: str, device=None):
    """A fake capture of one ``oram_round`` with scan dedup and a
    pass-through callback, eviction under ``sort_impl``."""
    import torch

    from ..oram.round import oram_round
    from .check_oblivious import oram_state

    dev = resolve_device(device)
    recursive = cfg.posmap is not None

    def build():
        return oram_state(cfg, dev), *(torch.zeros(b, dtype=torch.int32, device=dev)
                                       for _ in range(5))

    def run(st, idxs, nl, dl, pm_nl, pm_dl):
        return oram_round(cfg, st, idxs, nl, dl, lambda v, p: (v[:, 0], v, p), sort_impl,
                          *((pm_nl, pm_dl) if recursive else (None, None)), occ_impl="scan")

    return capture(run, *fake_inputs(build), name=f"oram_round/{sort_impl}")


def capture_engine_round(ecfg, device=None):
    """A fresh fake capture of one ``engine_round_step`` (the fast
    admission branch; not the cost model's kept one, so the program as it
    stands now is what is counted)."""
    from .costmodel import trace_engine_round

    return trace_engine_round.__wrapped__(ecfg, device)


def reference_sorts(gm) -> int:
    """The residue of a radix capture counted as the reference's sort ops
    (:data:`RADIX_RESIDUE`); an unmapped site counts node for node."""
    n, prev = 0, None
    for node in walk_nodes(gm):
        if not any(nm.startswith(SORT_OPS) for nm in node_ops(node)):
            continue
        site = site_of(node)
        chained = prev is not None and site_of(prev) == site and _feeds(prev, node)
        if RADIX_RESIDUE.get(site, (None, "node"))[1] == "node" or not chained:
            n += 1
        prev = node
    return n


def _feeds(src, dst, depth: int = 8) -> bool:
    """Is ``src`` among ``dst``'s operands' producers within ``depth`` hops?
    (A pass of a chain sorts keys permuted by the previous pass's result.)"""
    frontier = {dst}
    for _ in range(depth):
        frontier = {a for n in frontier for a in n.all_input_nodes}
        if src in frontier:
            return True
    return False


def check_oram_round(b: int = 64, device=None) -> dict:
    """Claims 1-2: ``{"radix": sorts, "xla": sorts}`` of the reference's
    ORAM round; raises AssertionError on a violation."""
    cfg = oram_round_cfg()
    out = {impl: sum(sort_census(capture_oram_round(cfg, b, impl, device).gm).values())
           for impl in ("radix", "xla")}
    assert out["radix"] == 0, (
        f"the radix oram_round captures {out['radix']} sort nodes — a bounded-key sort "
        "escaped the knob")
    assert out["xla"] > 0, (
        "positive control failed: the xla oram_round captures no sort node — the "
        "counter does not see the ops the radix claim asserts away")
    return out


def check_engine_round(b: int = 32, device=None) -> dict:
    """Claims 3-4 on the reference's engine configuration: returns the
    sites and counts under both knobs; raises AssertionError on a
    violation."""
    from ..engine.state import EngineConfig

    caps = {impl: capture_engine_round(EngineConfig.from_config(engine_round_config(impl, b)),
                                       device)
            for impl in ("xla", "radix")}
    return engine_sort_residue(caps["radix"].gm, caps["xla"].gm)


def engine_sort_residue(radix_gm, xla_gm) -> dict:
    """Claims 3-4 over two captured engine rounds (radix, xla)."""
    radix, xla = sort_census(radix_gm), sort_census(xla_gm)
    n_radix, n_xla = sum(radix.values()), sum(xla.values())
    assert n_radix < n_xla, (
        f"the radix engine round captures {n_radix} sort nodes, the xla one {n_xla}")
    unmapped = sorted(set(radix) - set(RADIX_RESIDUE))
    assert not unmapped, (
        f"radix engine round sorts at {unmapped}: not a wide-key site of the reference's "
        "residue — a bounded-key sort escaped the knob")
    as_ref = reference_sorts(radix_gm)
    assert as_ref <= REFERENCE_RESIDUE_BOUND, (
        f"the radix residue is {as_ref} of the reference's sort ops, past its bound "
        f"{REFERENCE_RESIDUE_BOUND}: {dict(radix)}")
    return {"radix": dict(radix), "xla": dict(xla), "radix_nodes": n_radix,
            "xla_nodes": n_xla, "radix_as_reference": as_ref,
            "mapping": {s: RADIX_RESIDUE[s][0] for s in radix}}


def check_radix_zero_sort(device=None) -> dict:
    """Every claim; returns ``{"oram_round": ..., "engine_round": ...}``."""
    return {"oram_round": check_oram_round(device=device),
            "engine_round": check_engine_round(device=device)}


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="default: the card; 'cpu' for the plain path")
    args = ap.parse_args(argv)
    out = check_radix_zero_sort(args.device)
    print(f"[check_sort_radix] oram_round: OK {out['oram_round']}")
    print(f"[check_sort_radix] engine_round: OK {out['engine_round']}")
    print("[check_sort_radix] PASS: the radix round captures no sort; the engine round's "
          "residue is the reference's wide-key sites")
    return 0


if __name__ == "__main__":
    sys.exit(main())
