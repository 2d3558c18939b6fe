"""Gate: geometry-scale overflow certification of the port's round
(counterpart of ``tools/check_ranges.py``).

Rangelint (:mod:`.rangelint`) interval-checks the captured graph of the
engine round (both admission branches), the expiry sweep and the
standalone ``oram_round``/``lookup_remap_round`` programs, plus the
flush programs (``engine_flush_step``, ``oram_flush`` on one device and
on a 2-shard virtual mesh) on every E > 1 combination. Input ranges are
the ``RANGELINT_BOUNDS`` anchors; findings outside the reviewed
:data:`.allowlist.RANGE_ALLOWLIST` fail the run, and so does an entry
that no swept capture reaches.

Sweep: :data:`DEFAULT_COMBOS` over (vphases, sort, posmap, k,
evict_every), each with the bucket cipher of
:data:`.check_oblivious.DEFAULT_CIPHER_IMPLS`, so every kernel's address
operands are audited, at ``--geometry`` (log2 records; default 30, the
largest certified tree). The states are built under a fake tensor mode:
nothing of a 2^30 tree is allocated. The sweep walks each tree in one
chunk (:func:`one_chunk_sweep`). ``--full`` sweeps the 2x2x2x2x2
cross-product; ``--smoke`` one toy combination (E=2): its engine round,
flush and sharded flush, with no reachability check.

Design point: 2^36 records must be refused by the construction guard
(``oram/path_oram.py:OramConfig``, height <= 29 / blocks <= 2^30), with
the guard's own message; a beyond-bound geometry that constructs fails.

Teeth: every seeded range mutant (:mod:`.mutants`) must fail for its own
finding kind under the production allowlist, on every run.

Run: ``python -m grapevine_tpu_torch.analysis.check_ranges
[--smoke|--full] [--geometry N] [--device D]`` — on the card unless
``--device cpu`` is given (no card: it raises).
"""

from __future__ import annotations

import contextlib
import sys

import torch

from ..device import resolve_device
from .fx_walk import fake_inputs
from .check_oblivious import (
    DEFAULT_CIPHER_IMPLS,
    DEFAULT_COMBOS,
    SMOKE_COMBO,
    oram_state,
    combo_name,
)

#: default certification geometry (log2 records): the largest per-tree
#: capacity the u32 lanes certify — several allowlist entries only fire
#: once the lanes are tight
DEFAULT_GEOMETRY = 30
#: the design point that must be refused at construction
DESIGN_POINT = 36
MAX_CERTIFIED_GEOMETRY = 30
#: the toy geometry of ``--smoke``
SMOKE_GEOMETRY = 5


def engine_config(log2_msgs: int, vp: str, srt: str, pmi: str, k: int, ee: int = 1,
                  batch: int = 4, cipher_impl: str = "jnp"):
    """The reference's audit engine (``tools/check_ranges.py:_engine``) at
    one knob combination and bucket cipher."""
    from ..config import GrapevineConfig
    from ..engine.state import EngineConfig

    return EngineConfig.from_config(GrapevineConfig(
        max_messages=1 << log2_msgs, max_recipients=max(16, 1 << min(log2_msgs, 20)),
        batch_size=batch, vphases_impl=vp, sort_impl=srt, posmap_impl=pmi,
        tree_top_cache_levels=k, evict_every=ee, bucket_cipher_impl=cipher_impl,
    ))


@contextlib.contextmanager
def one_chunk_sweep():
    """Walk each tree in ONE chunk (and the leaf plane in one pass) while
    capturing the sweep. The chunk loop is unrolled Python: at 2^30
    records it would be ~2^18 iterations. Every value a chunk pass
    computes lies in the one-chunk pass's interval (its bucket ids are a
    slice of the tree's), and the carried counts after all passes equal
    the one-chunk sums, so the one-chunk capture certifies every chunking."""
    from ..engine import expiry

    saved = expiry._chunk_rows, expiry._LEAF_ROWS
    expiry._chunk_rows = lambda cfg: cfg.n_buckets_padded
    expiry._LEAF_ROWS = 1 << 62
    try:
        yield
    finally:
        expiry._chunk_rows, expiry._LEAF_ROWS = saved


def _scalar(device):
    return torch.zeros((), dtype=torch.int32, device=resolve_device(device))


def audit_engine_round(ecfg, allowlist, name: str, fast_ok: bool = True, device=None,
                       inputs=None):
    """Interval-audit one full engine round at one admission branch;
    ``inputs`` = (state, batch, draws) to audit given tensors (a fake
    state otherwise)."""
    from ..engine import round_step
    from ..engine.state import init_engine
    from .check_oblivious import batch_spec, engine_draws
    from .rangelint import analyze_ranges

    def build():
        st = init_engine(ecfg, 0, device=device)
        return st, batch_spec(ecfg, device), engine_draws(ecfg, st, device)

    st, ba, dr = inputs if inputs is not None else fake_inputs(build)
    return analyze_ranges(
        lambda s, b, d: round_step.engine_round_step(ecfg, s, b, draws=d, fast_ok=fast_ok),
        {"state": st, "batch": ba, "draws": dr}, bounds=round_step.RANGELINT_BOUNDS(ecfg),
        allowlist=allowlist, name=f"engine_round/{name}/{'fast' if fast_ok else 'slow'}")


def audit_engine_flush(ecfg, allowlist, name: str, device=None, state=None):
    """Interval-audit the delayed-eviction flush (E > 1) against the
    round's state anchors."""
    from ..engine import round_step
    from ..engine.state import init_engine
    from .rangelint import analyze_ranges

    st = state if state is not None else fake_inputs(lambda: init_engine(ecfg, 0, device))
    return analyze_ranges(lambda s: round_step.engine_flush_step(ecfg, s), {"state": st},
                          bounds=round_step.RANGELINT_BOUNDS(ecfg), allowlist=allowlist,
                          name=f"engine_flush/{name}")


def audit_expiry_sweep(ecfg, allowlist, name: str, device=None, state=None,
                       one_chunk: bool = True):
    """Interval-audit the expiry sweep; ``one_chunk`` walks each tree in
    one chunk (:func:`one_chunk_sweep`), else in the engine's chunks."""
    from ..engine import expiry
    from ..engine.state import init_engine
    from .rangelint import analyze_ranges

    def build():
        return (init_engine(ecfg, 0, device) if state is None else state,
                _scalar(device), _scalar(device), _scalar(device))

    st, now, per, nh = fake_inputs(build) if state is None else build()
    with one_chunk_sweep() if one_chunk else contextlib.nullcontext():
        return analyze_ranges(
            lambda s, n, p, h: expiry.expiry_sweep(ecfg, s, n, p, h),
            {"state": st, "now": now, "period": per, "now_hi": nh},
            bounds=expiry.RANGELINT_BOUNDS(ecfg), allowlist=allowlist,
            name=f"expiry_sweep/{name}")


def oram_config(log2_blocks: int, recursive: bool, k: int, ee: int = 1, b: int = 4,
                cipher_impl: str = "jnp"):
    """The reference's standalone audit tree (``tools/check_ranges.py:_oram_cfg``)."""
    from ..oram.path_oram import OramConfig
    from ..oram.posmap import derive_posmap_spec

    blocks = 1 << log2_blocks
    pm = (derive_posmap_spec(blocks, top_cache_levels=k, evict_window=ee, evict_fetch_count=b)
          if recursive else None)
    return OramConfig(
        height=max(1, log2_blocks - 1), value_words=4, n_blocks=blocks, cipher_rounds=8,
        posmap=pm, top_cache_levels=k, evict_window=ee, evict_fetch_count=b if ee > 1 else 0,
        evict_buffer_slots=min(blocks, 64) if ee > 1 else 0, cipher_impl=cipher_impl,
    )


def _tree_bounds(cfg) -> dict:
    from ..oram import posmap as pmod
    from ..oram.path_oram import RANGELINT_BOUNDS as tree_bounds

    b = {**tree_bounds(cfg, prefix="state"), **pmod.RANGELINT_BOUNDS(cfg, prefix="state.posmap")}
    # the posmap anchor's pm_state labels do not apply: the map rides
    # inside state.posmap, covered by the tree anchor
    return {k: v for k, v in b.items() if not k.startswith("pm_state")}


def audit_oram_round(allowlist, log2_blocks: int, occ_impl: str, sort_impl: str,
                     recursive: bool, k: int, ee: int = 1, device=None,
                     cipher_impl: str = "jnp"):
    """Interval-audit ``oram_round`` standalone (``ee > 1``: the fetch-only
    round)."""
    from ..oram import round as oround
    from .rangelint import analyze_ranges

    cfg = oram_config(log2_blocks, recursive, k, ee=ee, cipher_impl=cipher_impl)
    b = 4

    def apply_batch(vals0, present0):
        return vals0[:, 0], vals0, present0  # pass-through: certify the machinery

    def run(state, idxs, new_leaves, dummy_leaves, pm_new_leaves, pm_dummy_leaves):
        return oround.oram_round(
            cfg, state, idxs, new_leaves, dummy_leaves, apply_batch, sort_impl,
            *((pm_new_leaves, pm_dummy_leaves) if recursive else ()), occ_impl=occ_impl)

    def build():
        lv = [torch.zeros(b, dtype=torch.int32, device=resolve_device(device))
              for _ in range(5)]
        return {"state": oram_state(cfg, device), "idxs": lv[0], "new_leaves": lv[1],
                "dummy_leaves": lv[2], "pm_new_leaves": lv[3], "pm_dummy_leaves": lv[4]}

    return analyze_ranges(
        run, fake_inputs(build), bounds=_tree_bounds(cfg), allowlist=allowlist,
        name=f"oram_round/2^{log2_blocks}_{occ_impl}_{sort_impl}_"
             f"{'rec' if recursive else 'flat'}_k{k}_e{ee}")


def audit_oram_flush(allowlist, log2_blocks: int, sort_impl: str, recursive: bool, k: int,
                     ee: int, shards: int = 1, device=None, cipher_impl: str = "jnp"):
    """Interval-audit ``oram_flush`` standalone; ``shards > 1`` over a
    virtual mesh of that many shards of ``device`` (the owner-masked
    sharded flush: its per-shard rebase arithmetic is new)."""
    from ..oram import round as oround
    from .rangelint import analyze_ranges

    cfg = oram_config(log2_blocks, recursive, k, ee=ee, cipher_impl=cipher_impl)
    mesh = None
    dev = resolve_device(device)

    def build():
        state = oram_state(cfg, device)
        if shards > 1:
            from ..parallel.mesh import _shard_oram

            state = _shard_oram(state, mesh)
        return state

    if shards > 1:
        from ..parallel.mesh import make_mesh

        mesh = make_mesh([dev] * shards)
    tag = f"2^{log2_blocks}_{sort_impl}_{'rec' if recursive else 'flat'}_k{k}_e{ee}"
    return analyze_ranges(
        lambda st: oround.oram_flush(cfg, st, sort_impl, mesh), {"state": fake_inputs(build)},
        bounds=_tree_bounds(cfg), allowlist=allowlist,
        name=f"sharded_oram_flush/{tag}_s{shards}" if shards > 1 else f"oram_flush/{tag}")


def audit_lookup_remap(allowlist, log2_blocks: int, occ_impl: str, sort_impl: str,
                       recursive: bool, device=None):
    from ..oram import posmap as pmod
    from .rangelint import analyze_ranges

    cfg = oram_config(log2_blocks, recursive, 0)
    b = 4

    def run(pm_state, idxs, new_leaves, dummy_leaves, first_occ, last_occ,
            pm_new_leaves, pm_dummy_leaves):
        return pmod.lookup_remap_round(
            cfg, pm_state, idxs, new_leaves, dummy_leaves, first_occ, last_occ,
            pm_new_leaves=pm_new_leaves if recursive else None,
            pm_dummy_leaves=pm_dummy_leaves if recursive else None,
            sort_impl=sort_impl, occ_impl=occ_impl)

    def build():
        dev = resolve_device(device)
        lv = [torch.zeros(b, dtype=torch.int32, device=dev) for _ in range(5)]
        fl = [torch.zeros(b, dtype=torch.bool, device=dev) for _ in range(2)]
        return {"pm_state": oram_state(cfg, device).posmap, "idxs": lv[0],
                "new_leaves": lv[1], "dummy_leaves": lv[2], "first_occ": fl[0],
                "last_occ": fl[1], "pm_new_leaves": lv[3], "pm_dummy_leaves": lv[4]}

    return analyze_ranges(
        run, fake_inputs(build), bounds=pmod.RANGELINT_BOUNDS(cfg), allowlist=allowlist,
        name=f"lookup_remap/2^{log2_blocks}_{occ_impl}_{sort_impl}_"
             f"{'rec' if recursive else 'flat'}")


def combo_reports(combo, geometry: int, allowlist, device=None, cipher_impl: str = "jnp",
                  with_subrounds: bool = True):
    """Every audit of one knob combination at one geometry, as reports."""
    vp, srt, pmi, k, ee = combo
    rec = pmi == "recursive"
    name = f"2^{geometry}_{combo_name(combo)}_{cipher_impl}"
    ecfg = engine_config(geometry, vp, srt, pmi, k, ee, cipher_impl=cipher_impl)
    reps = [audit_engine_round(ecfg, allowlist, name, fast_ok=f, device=device)
            for f in (True, False)]
    reps.append(audit_expiry_sweep(ecfg, allowlist, name, device=device))
    if ee > 1:
        reps.append(audit_engine_flush(ecfg, allowlist, name, device=device))
    if with_subrounds:
        reps.append(audit_oram_round(allowlist, geometry, vp, srt, rec, k, ee, device=device,
                                     cipher_impl=cipher_impl))
        reps.append(audit_lookup_remap(allowlist, geometry, vp, srt, rec, device=device))
        if ee > 1:
            reps.append(audit_oram_flush(allowlist, geometry, srt, rec, k, ee, device=device,
                                         cipher_impl=cipher_impl))
            reps.append(audit_oram_flush(allowlist, geometry, srt, rec, k, ee, shards=2,
                                         device=device, cipher_impl="pallas"))
    return reps


def _combo_outcome(combo, geometry, cipher_impl, allowlist, device, with_subrounds, verbose):
    problems, hits, lines = [], {}, []
    for rep in combo_reports(combo, geometry, allowlist, device, cipher_impl, with_subrounds):
        for k, n in rep.allowed.items():
            hits[k] = hits.get(k, 0) + n
        if verbose or rep.findings:
            print(rep.summary(), flush=True)
        problems.extend(f"{rep.name}: {f}" for f in rep.findings)
        lines.append(dict(name=rep.name, nodes=rep.n_eqns, findings=len(rep.findings),
                          capture_s=rep.capture.seconds if rep.capture else 0.0,
                          audit_s=rep.audit_s, kernels=rep.kernels,
                          # device memory the audits allocated in this process
                          card_bytes=(torch.cuda.max_memory_allocated()
                                      if torch.cuda.is_initialized() else 0)))
    return problems, hits, lines


def run_audit(combos, geometry: int, allowlist=None, verbose: bool = False,
              cipher_impls=None, device=None, with_subrounds: bool = True, jobs: int = 1):
    """Sweep the interval audit; returns (problems, allowlist hits, one
    line per audited program). ``jobs > 1`` audits the combinations in
    that many processes."""
    from .allowlist import RANGE_ALLOWLIST

    allowlist = RANGE_ALLOWLIST if allowlist is None else allowlist
    cipher_impls = cipher_impls or ("jnp",) * len(combos)
    dev = None if device is None else str(device)
    work = [(c, geometry, ci, allowlist, dev, with_subrounds, verbose)
            for c, ci in zip(combos, cipher_impls)]
    if jobs > 1:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        with ProcessPoolExecutor(jobs, mp_context=multiprocessing.get_context("spawn")) as ex:
            outcomes = list(ex.map(_combo_outcome, *zip(*work)))
    else:
        outcomes = [_combo_outcome(*w) for w in work]
    problems, hits, lines = [], {}, []
    for probs, h, ls in outcomes:
        problems += probs
        lines += ls
        for k, n in h.items():
            hits[k] = hits.get(k, 0) + n
    return problems, hits, lines


def check_allowlist_reachability(hits: dict, allowlist=None) -> list:
    """Every reviewed range entry must fire somewhere in the sweep."""
    from .allowlist import RANGE_ALLOWLIST

    allowlist = RANGE_ALLOWLIST if allowlist is None else allowlist
    return [f"dead range-allowlist entry {e.key!r} ({e.reason!r}): never reached in any "
            "swept knob combination — delete it or sweep the combo that exercises it"
            for e in allowlist if e.key not in hits]


def certify_design_point(log2_records: int) -> tuple:
    """A beyond-bound geometry must REFUSE at construction; returns
    (problems, the guard's refusal text)."""
    try:
        engine_config(log2_records, "dense", "xla", "flat", 0)
    except ValueError as exc:
        return [], str(exc)
    return [f"2^{log2_records} records constructed WITHOUT a certified-geometry refusal — "
            "the construction guard (oram/path_oram.py OramConfig) must refuse beyond the "
            "certified bound"], ""


def run_range_mutant_controls(allowlist, log=None) -> list:
    """Every seeded range mutant must FAIL under the production allowlist."""
    from .mutants import control_failures, run_range_mutants

    log = log or (lambda line: print(f"[check_ranges] {line}"))
    return control_failures(run_range_mutants(allowlist), "range mutant", log)


def main(argv=None) -> int:
    import argparse
    import itertools

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="one toy combination (E=2): engine round, flush and sharded flush, "
                         "range mutants and the design-point refusal; no reachability check")
    ap.add_argument("--full", action="store_true", help="the 2x2x2x2x2 knob cross-product")
    ap.add_argument("--geometry", type=int, default=DEFAULT_GEOMETRY, metavar="LOG2",
                    help=f"records capacity to certify (log2; default {DEFAULT_GEOMETRY}; "
                         f"{DESIGN_POINT} = the design point, certified by its refusal and "
                         "the largest certified shard)")
    ap.add_argument("--device", default=None,
                    help="device of the audited tensors (default: the CUDA card)")
    ap.add_argument("--jobs", type=int, default=1, help="processes for the combo sweep")
    ap.add_argument("--skip-mutants", action="store_true")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    from .allowlist import RANGE_ALLOWLIST

    problems: list = []
    if args.smoke:
        vp, srt, pmi, k, ee = SMOKE_COMBO
        rec = pmi == "recursive"
        ecfg = engine_config(SMOKE_GEOMETRY, *SMOKE_COMBO)
        reps = [audit_engine_round(ecfg, RANGE_ALLOWLIST, "smoke", device=device),
                audit_engine_flush(ecfg, RANGE_ALLOWLIST, "smoke", device=device),
                audit_oram_flush(RANGE_ALLOWLIST, SMOKE_GEOMETRY, srt, rec, k, ee, shards=2,
                                 device=device, cipher_impl="pallas")]
        for rep in reps:
            print(rep.summary())
            problems.extend(f"{rep.name}: {f}" for f in rep.findings)
        dp, refusal = certify_design_point(DESIGN_POINT)
        problems.extend(dp)
        if refusal:
            print(f"[check_ranges] 2^{DESIGN_POINT} design point: REFUSED at construction "
                  f"(certified) — {refusal}")
    else:
        geometry = args.geometry
        if geometry > MAX_CERTIFIED_GEOMETRY:
            dp, refusal = certify_design_point(geometry)
            problems.extend(dp)
            if refusal:
                print(f"[check_ranges] 2^{geometry} records: REFUSED at construction "
                      f"(certified) — {refusal}\n[check_ranges] certifying the composition "
                      f"shard instead: 2^{geometry} = 2^{geometry - MAX_CERTIFIED_GEOMETRY} "
                      f"recipient-space shards x 2^{MAX_CERTIFIED_GEOMETRY} records")
            geometry = MAX_CERTIFIED_GEOMETRY
        combos = (tuple(itertools.product(("dense", "scan"), ("xla", "radix"),
                                          ("flat", "recursive"), (0, 2), (1, 2)))
                  if args.full else DEFAULT_COMBOS)
        swept, hits, _ = run_audit(
            combos, geometry, verbose=args.verbose, device=device, jobs=args.jobs,
            cipher_impls=[DEFAULT_CIPHER_IMPLS[i % len(DEFAULT_CIPHER_IMPLS)]
                          for i in range(len(combos))])
        problems.extend(swept)
        problems.extend(check_allowlist_reachability(hits))
    if not args.skip_mutants:
        problems.extend(run_range_mutant_controls(RANGE_ALLOWLIST))

    if problems:
        print(f"[check_ranges] FAIL: {len(problems)} problem(s)")
        for p in problems:
            print(f"  - {p}")
        return 1
    scope = ("smoke combo" if args.smoke
             else f"full knob matrix @ 2^{args.geometry}" if args.full
             else f"shipped knob matrix @ 2^{args.geometry}")
    reach = "" if args.smoke else "; every range-allowlist entry reachable"
    teeth = "" if args.skip_mutants else "; all range mutants caught"
    print(f"[check_ranges] PASS ({scope}): no wraparound, truncating cast or out-of-range "
          f"index outside the reviewed mod-2^32 allowlist{reach}{teeth}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
