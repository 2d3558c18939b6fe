"""CI gate: the position-map lookup's access schedule is index-blind (port
of ``tools/check_posmap_oblivious.py``).

The recursive position map's claim (``oram/posmap.py``) is that resolving
a batch of B positions makes a FIXED schedule of memory accesses — the
same gathers and scatters in the same program — whatever indices are
asked (duplicates, all the same, all dummy, anything):

1. capture ``lookup_remap_round`` once per adversarial index set (all
   distinct, all identical, all dummy, mixed duplicates) in real mode
   with the indices closed over as constants. A Python branch on their
   values — a shortcut for dummy batches, a loop over unique indices —
   then reads a traced value and stops the capture, or records a
   different graph, which a capture of the indices as an input of the
   graph can never show;
2. assert the op census (every node, recursively into subgraphs) is
   IDENTICAL across the index sets, with a fixed positive number of
   gathers and scatters;
3. assert no control node anywhere (:data:`.fx_walk.CONTROL_OPS`: a host
   read of a value, ``cond``/``while_loop``);
4. positive control: the flat map's census has fewer accesses than the
   recursive one's (one gather + one scatter against the internal ORAM
   round), so the census sees the schedule rather than passing vacuously.

The access counts (``accesses``, ``gathers``, ``scatters``) are the
reference tool's at the same geometry; ``census_size`` counts aten nodes
and differs from the reference's primitive count.

    python -m grapevine_tpu_torch.analysis.check_posmap_oblivious [--device cpu]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..device import resolve_device
from .fx_walk import access_counts, capture, census, control_counts


def index_sets(cfg, b: int, seed: int = 7) -> dict:
    """Adversarially different query batches (u32 values, numpy)."""
    rng = np.random.default_rng(seed)
    return {
        "distinct": np.arange(b, dtype=np.uint32) % np.uint32(cfg.blocks),
        "all_same": np.zeros(b, np.uint32),
        "all_dummy": np.full(b, cfg.dummy_index, np.uint32),
        "mixed_dups": rng.integers(0, cfg.blocks + 1, b).astype(np.uint32),
    }


def as_lanes(idxs: np.ndarray, device) -> torch.Tensor:
    """u32 values as the port's int32 lanes on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(idxs, np.uint32).view(np.int32)).to(device)


def capture_lookup(cfg, idxs: np.ndarray, occ_impl: str = "dense", sort_impl: str = "xla",
                   device=None, pm_state=None):
    """A real-mode capture of one whole-batch lookup+remap with ``idxs``
    closed over as a constant (the map state, the leaf draws traced)."""
    from ..oram import posmap as posmap_mod
    from ..oram.round import occurrence
    from .check_oblivious import oram_state

    dev = resolve_device(device)
    b = len(idxs)
    cidxs = as_lanes(idxs, dev)
    recursive = cfg.posmap is not None
    if pm_state is None:
        pm_state = oram_state(cfg, dev).posmap

    def run(pm, nl, dl, pm_nl, pm_dl):
        fo, lo, _ = occurrence(cfg, cidxs, occ_impl, sort_impl)
        return posmap_mod.lookup_remap_round(
            cfg, pm, cidxs, nl, dl, fo, lo,
            pm_nl if recursive else None, pm_dl if recursive else None,
            sort_impl=sort_impl, occ_impl=occ_impl)

    leaves = [torch.zeros(b, dtype=torch.int32, device=dev) for _ in range(4)]
    return capture(run, pm_state, *leaves,
                   names=("pm_state", "new_leaves", "dummy_leaves", "pm_new_leaves",
                          "pm_dummy_leaves"),
                   tracing_mode="real", name="lookup_remap_round")


def require_graph(cap, what: str) -> None:
    """A capture that stopped on a read of a traced value (a branch on the
    queried indices, a host read) is data-dependent control."""
    assert cap.gm is not None, (
        f"{what} contains data-dependent control: it reads a traced value at "
        f"{cap.dependence[0]} ({cap.dependence[1]})")


def schedule_census(cfg, b: int, occ_impl: str = "dense", sort_impl: str = "xla",
                    device=None, name: str = "posmap", pm_state=None) -> dict:
    """Claims 1-3 for one geometry: the census of every index set equal,
    accesses > 0, no control node. Returns the reference's summary plus
    ``nodes`` and ``capture_s``; raises AssertionError on a violation."""
    censuses, seconds, nodes = {}, [], 0
    for iname, idxs in index_sets(cfg, b).items():
        cap = capture_lookup(cfg, idxs, occ_impl, sort_impl, device, pm_state)
        require_graph(cap, f"{name} posmap lookup ({iname})")
        censuses[iname] = census(cap.gm)
        seconds.append(cap.seconds)
        nodes = sum(1 for n in cap.gm.graph.nodes if n.op == "call_function")
    base_name, base = next(iter(censuses.items()))
    for iname, c in censuses.items():
        assert c == base, (
            f"{name} posmap lookup captures a DIFFERENT program for index set "
            f"{iname!r} vs {base_name!r}: {dict((c - base) + (base - c))} — the "
            "access schedule depends on the queried indices")
    acc = access_counts(base)
    assert acc["accesses"] > 0, f"{name}: census saw no access ops"
    ctl = control_counts(base)
    assert not ctl, (
        f"{name} posmap lookup contains data-dependent control ({ctl}) — a "
        "run-time predicate could skip accesses under a fixed graph")
    return {**acc, "census_size": sum(base.values()), "nodes": nodes,
            "capture_s": seconds}


def posmap_configs(height: int = 4, value_words: int = 4, n_blocks: int = 32):
    """The reference tool's flat and recursive geometries."""
    from ..oram.path_oram import OramConfig
    from ..oram.posmap import derive_posmap_spec

    flat = OramConfig(height=height, value_words=value_words, n_blocks=n_blocks)
    rec = OramConfig(height=height, value_words=value_words, n_blocks=n_blocks,
                     posmap=derive_posmap_spec(n_blocks))
    return flat, rec


def positive_control(out: dict) -> None:
    """The recursive schedule's accesses must exceed the flat one's."""
    assert out["recursive"]["accesses"] > out["flat"]["accesses"], (
        "positive control failed: the recursive lookup's access census "
        f"({out['recursive']}) does not exceed the flat one's ({out['flat']}) — "
        "the census is not seeing the internal ORAM")


def check_posmap_access_schedule(b: int = 16, occ_impl: str = "dense", sort_impl: str = "xla",
                                 verbose: bool = False, device=None) -> dict:
    """Run the audit; returns ``{"flat": ..., "recursive": ...}`` with the
    reference's keys (``accesses``, ``gathers``, ``scatters``,
    ``census_size``), raises AssertionError on any violation."""
    out = {}
    for name, cfg in zip(("flat", "recursive"), posmap_configs()):
        s = schedule_census(cfg, b, occ_impl, sort_impl, device, name)
        out[name] = {k: s[k] for k in ("accesses", "gathers", "scatters", "census_size")}
        if verbose:
            print(f"{name}: {out[name]}")
    positive_control(out)
    return out


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--device", default=None, help="default: the card; 'cpu' for the plain path")
    args = ap.parse_args(argv)
    for occ, srt in (("dense", "xla"), ("scan", "xla"), ("scan", "radix")):
        out = check_posmap_access_schedule(b=args.batch, occ_impl=occ, sort_impl=srt,
                                           verbose=True, device=args.device)
        print(f"[check_posmap_oblivious] occ={occ} sort={srt}: OK {out}")
    print("[check_posmap_oblivious] PASS: position-map access schedule "
          "is a constant of the geometry")
    return 0


if __name__ == "__main__":
    sys.exit(main())
