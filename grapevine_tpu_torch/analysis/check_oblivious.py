"""Gate: taint-based obliviousness audit of the port's engine round, plus
the host-path lint (counterpart of ``tools/check_oblivious.py``).

The secret engine inputs (recipient keys, msg ids, positions, stash,
cache and buffer contents, cipher keys, payloads, the round's draws —
the ``OBLINT_SECRETS`` anchors) are tainted at capture time, and the
captured graph of the engine round, the expiry sweep, the engine flush
and the library sub-rounds (``oram_round``, ``oram_flush`` on one
device and on a 2-shard mesh, ``lookup_remap_round``) is walked proving
no gather/scatter index, no cond/while predicate, no slice start, no
kernel address and no host read is secret-derived — modulo the reviewed
allowlist (:mod:`.allowlist`), every entry of which must be reached in
the swept knob combinations (dead entries fail the run).

The engine round is captured once per admission branch (``fast_ok``
True and False): the port's form of the reference walking both
branches of its ``cond``. Every draw (``draws``, and ``draws.pm`` under
a recursive map) is an input.

Sweep: :data:`DEFAULT_COMBOS` over (vphases_impl, sort_impl,
posmap_impl, tree_top_cache_levels, evict_every), each with the bucket
cipher of :data:`DEFAULT_CIPHER_IMPLS`; ``--full`` the 2x2x2x2x2
cross-product, cycling through the ciphers; ``--smoke`` one combo's
engine round (both branches).
Every run also requires each seeded mutant (:mod:`.mutants`) to FAIL,
and runs locklint and importlint over the port.

Run: ``python -m grapevine_tpu_torch.analysis.check_oblivious
[--smoke|--full] [--jobs N] [--device D]`` — on the card unless
``--device cpu`` is given (no card: it raises). Every builder below takes
``device`` the same way: None is the card.
"""

from __future__ import annotations

import os
import sys

import torch

from ..device import resolve_device

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the reference's shipped knob combinations (vphases, sort, posmap, k,
#: evict_every), chosen there so every allowlist entry is reachable
DEFAULT_COMBOS = (
    ("dense", "xla", "flat", 0, 1),
    ("scan", "xla", "recursive", 2, 2),
    ("scan", "radix", "flat", 2, 4),
    ("dense", "radix", "recursive", 0, 2),
)
#: the bucket cipher each default combo runs (the port's addition: the
#: reference's kernels sit inside its jaxpr whatever the knob; the port's
#: are graph nodes only under a ``pallas*`` impl): B4+B6 in a per-round
#: write-back, B3 in a fetch round and B5 in a flush, B2, and the plain
#: keystream, so every kernel's address operands are audited
DEFAULT_CIPHER_IMPLS = ("pallas_fused_tiled", "pallas_fused", "pallas", "jnp")
#: the tier-1 budget: one combo, at E=2 so the fetch-only round has an
#: always-on taint census
SMOKE_COMBO = ("dense", "xla", "flat", 0, 2)


def combo_name(combo) -> str:
    vp, srt, pmi, k, ee = combo
    return f"{vp}_{srt}_{pmi}_k{k}_e{ee}"


def small_engine(vp: str, srt: str, pmi: str, k: int, ee: int = 1, **kw):
    """The reference's toy engine geometry (2^5 messages, 16 recipients,
    B=4) at one knob combination; ``kw`` adds config knobs (e.g.
    ``bucket_cipher_impl``)."""
    from ..config import GrapevineConfig
    from ..engine.state import EngineConfig

    cfg = GrapevineConfig(
        max_messages=32, max_recipients=16, batch_size=4, vphases_impl=vp,
        sort_impl=srt, posmap_impl=pmi, tree_top_cache_levels=k, evict_every=ee, **kw,
    )
    return EngineConfig.from_config(cfg)


def batch_spec(ecfg, device=None) -> dict:
    """Zero batch columns of one round (shapes are what a fake capture
    needs)."""
    from ..engine.state import ID_WORDS, KEY_WORDS, PAYLOAD_WORDS

    b = ecfg.batch_size
    device = resolve_device(device)

    def z(*sh):
        return torch.zeros(sh, dtype=torch.int32, device=device)

    return {"req_type": z(b), "auth": z(b, KEY_WORDS), "msg_id": z(b, ID_WORDS),
            "recipient": z(b, KEY_WORDS), "payload": z(b, PAYLOAD_WORDS),
            "now": z(), "now_hi": z()}


def engine_draws(ecfg, state, device=None):
    """One round's draws as inputs (``draws.pm`` under a recursive map)."""
    from ..engine.round_step import pm_draws, round_draws

    b = ecfg.batch_size
    device = resolve_device(device)
    d = round_draws(ecfg, state.rng, b, device)
    if ecfg.posmap_impl == "recursive":
        d = d._replace(pm=pm_draws(ecfg, state.pm_rng, b, device))
    return d


def audit_engine_round(ecfg, allowlist, name: str, fast_ok: bool = True,
                       device=None, state=None):
    """Taint-audit one full engine round at one admission branch."""
    from ..engine import round_step
    from ..engine.state import init_engine
    from .oblint import analyze

    state = state if state is not None else init_engine(ecfg, 0, device=device)
    return analyze(
        lambda st, ba, dr: round_step.engine_round_step(ecfg, st, ba, draws=dr,
                                                        fast_ok=fast_ok),
        {"state": state, "batch": batch_spec(ecfg, device),
         "draws": engine_draws(ecfg, state, device)},
        secrets=round_step.OBLINT_SECRETS, allowlist=allowlist,
        name=f"engine_round/{name}/{'fast' if fast_ok else 'slow'}",
    )


def audit_expiry_sweep(ecfg, allowlist, name: str, device=None, state=None):
    from ..engine import expiry
    from ..engine.state import init_engine
    from .oblint import analyze

    device = resolve_device(device)
    state = state if state is not None else init_engine(ecfg, 0, device=device)

    def scalar():
        return torch.zeros((), dtype=torch.int32, device=device)

    return analyze(
        lambda st, now, per, nh: expiry.expiry_sweep(ecfg, st, now, per, nh),
        {"state": state, "now": scalar(), "period": scalar(), "now_hi": scalar()},
        secrets=expiry.OBLINT_SECRETS, allowlist=allowlist, name=f"expiry_sweep/{name}",
    )


def audit_engine_flush(ecfg, allowlist, name: str, device=None, state=None):
    """Taint-audit the delayed-eviction flush program (E > 1): its
    bucket targets must derive only from the public window ledger."""
    from ..engine import round_step
    from ..engine.state import init_engine
    from .oblint import analyze

    state = state if state is not None else init_engine(ecfg, 0, device=device)
    return analyze(
        lambda st: round_step.engine_flush_step(ecfg, st),
        {"state": state}, secrets=round_step.FLUSH_OBLINT_SECRETS,
        allowlist=allowlist, name=f"engine_flush/{name}",
    )


def small_oram_cfg(recursive: bool, k: int, ee: int = 1, b: int = 4,
                   cipher_impl: str = "jnp"):
    """The reference's toy ORAM (height 4, 16 blocks of 4 words)."""
    from ..oram.path_oram import OramConfig
    from ..oram.posmap import derive_posmap_spec

    pm = (derive_posmap_spec(16, top_cache_levels=k, evict_window=ee, evict_fetch_count=b)
          if recursive else None)
    return OramConfig(
        height=4, value_words=4, n_blocks=16, cipher_rounds=8, posmap=pm,
        top_cache_levels=k, evict_window=ee, evict_fetch_count=b if ee > 1 else 0,
        evict_buffer_slots=16 if ee > 1 else 0, cipher_impl=cipher_impl,
    )


def oram_state(cfg, device):
    """A fresh state of ``cfg``'s tree (seeds 0 and 1) on ``device``."""
    from ..oram.path_oram import init_oram

    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    side = torch.Generator(device=device)
    side.manual_seed(1)
    return init_oram(cfg, gen, device, side=side if cfg.posmap is not None else None)


def _leaves(n: int, device):
    return torch.zeros(n, dtype=torch.int32, device=resolve_device(device))


def audit_oram_round(allowlist, occ_impl: str, sort_impl: str, recursive: bool, k: int,
                     ee: int = 1, device=None):
    """Taint-audit ``oram_round`` standalone (``ee > 1``: the fetch-only
    round)."""
    from ..oram import round as oround
    from .oblint import analyze

    cfg = small_oram_cfg(recursive, k, ee=ee)
    b = 4

    def apply_batch(vals0, present0):
        return vals0.sum(dim=1), vals0, present0

    def run(state, idxs, new_leaves, dummy_leaves, pm_new_leaves, pm_dummy_leaves):
        return oround.oram_round(
            cfg, state, idxs, new_leaves, dummy_leaves, apply_batch, sort_impl,
            *((pm_new_leaves, pm_dummy_leaves) if recursive else ()), occ_impl=occ_impl,
        )

    return analyze(
        run,
        {"state": oram_state(cfg, device), "idxs": _leaves(b, device),
         "new_leaves": _leaves(b, device), "dummy_leaves": _leaves(b, device),
         "pm_new_leaves": _leaves(b, device), "pm_dummy_leaves": _leaves(b, device)},
        secrets=oround.OBLINT_SECRETS, allowlist=allowlist,
        name=f"oram_round/{occ_impl}_{sort_impl}_{'rec' if recursive else 'flat'}_k{k}_e{ee}",
    )


def audit_oram_flush(allowlist, sort_impl: str, recursive: bool, k: int, ee: int = 2,
                     shards: int = 1, device=None, cipher_impl: str = "jnp"):
    """Taint-audit ``oram_flush`` standalone against the round's anchors;
    ``shards > 1`` runs it over a virtual mesh of that many shards (the
    owner-masked sharded flush: every shard's targets must derive only
    from the public ledger and its own mesh coordinate; under a
    ``pallas*`` impl its rows are ciphered by B2)."""
    from ..oram import round as oround
    from .oblint import analyze

    cfg = small_oram_cfg(recursive, k, ee=ee, cipher_impl=cipher_impl)
    state, mesh = oram_state(cfg, device), None
    if shards > 1:
        from ..parallel.mesh import _shard_oram, make_mesh

        mesh = make_mesh([resolve_device(device)] * shards)
        state = _shard_oram(state, mesh)
    tag = f"{sort_impl}_{'rec' if recursive else 'flat'}_k{k}_e{ee}"
    return analyze(
        lambda st: oround.oram_flush(cfg, st, sort_impl, mesh),
        {"state": state}, secrets=oround.OBLINT_SECRETS, allowlist=allowlist,
        name=(f"sharded_oram_flush/{tag}_s{shards}" if shards > 1 else f"oram_flush/{tag}"),
    )


def audit_lookup_remap(allowlist, occ_impl: str, sort_impl: str, recursive: bool,
                       device=None):
    """Taint-audit ``lookup_remap_round`` against its own anchors."""
    from ..oram import posmap as pmod
    from ..oram.path_oram import OramConfig
    from ..oram.posmap import derive_posmap_spec
    from .oblint import analyze

    pm = derive_posmap_spec(16) if recursive else None
    cfg = OramConfig(height=4, value_words=4, n_blocks=16, posmap=pm)
    b = 4

    def run(pm_state, idxs, new_leaves, dummy_leaves, first_occ, last_occ,
            pm_new_leaves, pm_dummy_leaves):
        return pmod.lookup_remap_round(
            cfg, pm_state, idxs, new_leaves, dummy_leaves, first_occ, last_occ,
            pm_new_leaves=pm_new_leaves if recursive else None,
            pm_dummy_leaves=pm_dummy_leaves if recursive else None,
            sort_impl=sort_impl, occ_impl=occ_impl,
        )

    def flags():
        return torch.zeros(b, dtype=torch.bool, device=resolve_device(device))

    return analyze(
        run,
        {"pm_state": oram_state(cfg, device).posmap, "idxs": _leaves(b, device),
         "new_leaves": _leaves(b, device), "dummy_leaves": _leaves(b, device),
         "first_occ": flags(), "last_occ": flags(), "pm_new_leaves": _leaves(b, device),
         "pm_dummy_leaves": _leaves(b, device)},
        secrets=pmod.OBLINT_SECRETS, allowlist=allowlist,
        name=f"lookup_remap/{occ_impl}_{sort_impl}_{'rec' if recursive else 'flat'}",
    )


def census_variants(ecfg, device=None) -> dict:
    """Adversarially different concrete batches: the engine round must
    capture to the identical program whatever the ops are (the
    reference's variants: all padding, all creates, every op on one
    recipient and one id, a mix)."""
    import numpy as np

    from ..engine.state import ID_WORDS, KEY_WORDS, PAYLOAD_WORDS

    b = ecfg.batch_size

    def batch(rt, fill):
        rng = np.random.default_rng(fill + 1)

        def col(w):
            return (rng.integers(1, 2**31, (b, w)).astype(np.int32) if fill
                    else np.zeros((b, w), np.int32))

        return {"req_type": np.full((b,), rt, np.int32), "auth": col(KEY_WORDS),
                "msg_id": col(ID_WORDS), "recipient": col(KEY_WORDS),
                "payload": col(PAYLOAD_WORDS), "now": np.int32(1000), "now_hi": np.int32(0)}

    dup = batch(1, fill=3)
    dup["recipient"][:] = dup["recipient"][0]  # every op on one recipient
    dup["msg_id"][:] = dup["msg_id"][0]
    out = {
        "all_padding": batch(0, fill=0),
        "all_create": batch(1, fill=1),
        "all_read_dup_ids": dup,
        "mixed": {**batch(2, fill=2), "req_type": (np.arange(b) % 5).astype(np.int32)},
    }
    device = resolve_device(device)
    return {v: {k: torch.as_tensor(x).to(device) for k, x in bt.items()}
            for v, bt in out.items()}


def census_equal_engine(ecfg, name: str, device=None):
    """Capture the engine round (real mode: the round runs) at each
    concrete batch from one state and one set of draws, and require one
    program."""
    from ..engine import round_step
    from ..engine.state import init_engine
    from .oblint import census_equal

    state = init_engine(ecfg, 0, device=device)
    draws = engine_draws(ecfg, state, device)
    return census_equal({
        v: (lambda st, ba, dr: round_step.engine_round_step(ecfg, st, ba, draws=dr,
                                                            fast_ok=True),
            (state, bt, draws))
        for v, bt in census_variants(ecfg, device).items()
    }, name=f"engine_round/{name}")


def run_mutant_controls(allowlist, log=None) -> list:
    """Every seeded mutant must FAIL under the production allowlist."""
    from .mutants import control_failures, run_mutants

    log = log or (lambda line: print(f"[check_oblivious] {line}"))
    return control_failures(run_mutants(allowlist), "mutant", log)


def run_locklint() -> list:
    from .locklint import lint_repo

    vs = lint_repo(PKG)
    for v in vs:
        print(f"[check_oblivious] locklint VIOLATION {v}")
    return [str(v) for v in vs]


def run_importlint() -> list:
    from .importlint import check_tree

    out = []
    for rel, findings in sorted(check_tree(PKG).items()):
        for lineno, _name, msg in findings:
            out.append(f"importlint {rel}:{lineno}: {msg}")
            print(f"[check_oblivious] {out[-1]}")
    return out


def combo_reports(combo, allowlist, device=None, cipher_impl: str = "jnp"):
    """Every audit of one knob combination, as reports."""
    vp, srt, pmi, k, ee = combo
    name = f"{combo_name(combo)}_{cipher_impl}"
    rec = pmi == "recursive"
    ecfg = small_engine(vp, srt, pmi, k, ee, bucket_cipher_impl=cipher_impl)
    reps = [audit_engine_round(ecfg, allowlist, name, fast_ok=f, device=device)
            for f in (True, False)]
    reps.append(audit_expiry_sweep(ecfg, allowlist, name, device=device))
    if ee > 1:
        reps.append(audit_engine_flush(ecfg, allowlist, name, device=device))
    reps.append(audit_oram_round(allowlist, vp, srt, rec, k, ee, device=device))
    reps.append(audit_lookup_remap(allowlist, vp, srt, rec, device=device))
    if ee > 1:
        reps.append(audit_oram_flush(allowlist, srt, rec, k, ee, device=device))
        reps.append(audit_oram_flush(allowlist, srt, rec, k, ee, shards=2, device=device,
                                     cipher_impl="pallas"))
    return reps


def _combo_outcome(combo, cipher_impl, allowlist, verbose, device):
    problems, hits = [], {}
    for rep in combo_reports(combo, allowlist, device=device, cipher_impl=cipher_impl):
        for k, n in rep.allowed.items():
            hits[k] = hits.get(k, 0) + n
        if verbose or rep.violations:
            print(rep.summary(), flush=True)
        problems.extend(f"{rep.name}: {v}" for v in rep.violations)
    return problems, hits


def run_audit(combos, allowlist=None, with_census="first", verbose: bool = False,
              cipher_impls=None, jobs: int = 1, device=None):
    """Sweep the taint audit; returns (problems, allowlist_hits).

    ``cipher_impls`` pairs a bucket cipher with each combo (default: the
    plain keystream; :data:`DEFAULT_CIPHER_IMPLS` for the default sweep).
    ``with_census``: "first" = program equality on the lead combo,
    "all" = on every combo, False = skip. ``jobs > 1`` audits the combos
    in that many processes."""
    from .allowlist import ENGINE_ALLOWLIST

    allowlist = ENGINE_ALLOWLIST if allowlist is None else allowlist
    cipher_impls = cipher_impls or ("jnp",) * len(combos)
    dev = None if device is None else str(device)
    work = [(c, ci, allowlist, verbose, dev) for c, ci in zip(combos, cipher_impls)]
    if jobs > 1:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        with ProcessPoolExecutor(jobs, mp_context=multiprocessing.get_context("spawn")) as ex:
            outcomes = list(ex.map(_combo_outcome, *zip(*work)))
    else:
        outcomes = [_combo_outcome(*w) for w in work]
    problems: list = []
    hits: dict = {}
    for probs, h in outcomes:
        problems += probs
        for k, n in h.items():
            hits[k] = hits.get(k, 0) + n
    if with_census:
        for combo in (combos if with_census == "all" else combos[:1]):
            problems.extend(str(v) for v in census_equal_engine(
                small_engine(*combo), combo_name(combo), device=device))
    return problems, hits


def check_allowlist_reachability(hits: dict, allowlist=None) -> list:
    """Every reviewed entry must fire somewhere in the sweep."""
    from .allowlist import ENGINE_ALLOWLIST

    allowlist = ENGINE_ALLOWLIST if allowlist is None else allowlist
    return [
        f"dead allowlist entry {e.key!r} ({e.reason!r}): never reached in any swept "
        "knob combination — delete it or sweep the combo that exercises it"
        for e in allowlist if e.key not in hits
    ]


def main(argv=None) -> int:
    import argparse
    import itertools

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="one combo's engine round (both admission branches) + mutants "
                         "+ locklint + importlint; no census, no reachability check")
    ap.add_argument("--full", action="store_true",
                    help="the full knob cross-product, census equality on every combo")
    ap.add_argument("--jobs", type=int, default=1, help="processes for the combo sweep")
    ap.add_argument("--device", default=None,
                    help="device of the audited tensors (default: the CUDA card)")
    ap.add_argument("--skip-mutants", action="store_true")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    from .allowlist import ENGINE_ALLOWLIST

    problems: list = []
    if args.smoke:
        ecfg = small_engine(*SMOKE_COMBO)
        for fast_ok in (True, False):
            rep = audit_engine_round(ecfg, ENGINE_ALLOWLIST, combo_name(SMOKE_COMBO),
                                     fast_ok=fast_ok, device=device)
            print(rep.summary())
            problems.extend(f"{rep.name}: {v}" for v in rep.violations)
    else:
        combos = (tuple(itertools.product(("dense", "scan"), ("xla", "radix"),
                                          ("flat", "recursive"), (0, 2), (1, 2)))
                  if args.full else DEFAULT_COMBOS)
        swept, hits = run_audit(
            combos, with_census="all" if args.full else "first", verbose=args.verbose,
            jobs=args.jobs, device=device,
            cipher_impls=[DEFAULT_CIPHER_IMPLS[i % len(DEFAULT_CIPHER_IMPLS)]
                          for i in range(len(combos))])
        problems.extend(swept)
        problems.extend(check_allowlist_reachability(hits))
    if not args.skip_mutants:
        problems.extend(run_mutant_controls(ENGINE_ALLOWLIST))
    problems.extend(run_locklint())
    problems.extend(run_importlint())

    if problems:
        print(f"[check_oblivious] FAIL: {len(problems)} problem(s)")
        for p in problems:
            print(f"  - {p}")
        return 1
    scope = ("smoke combo" if args.smoke
             else "full knob matrix" if args.full else "shipped knob matrix")
    reach = "" if args.smoke else "; every allowlist entry reachable"
    teeth = "" if args.skip_mutants else "; all mutants caught"
    print(f"[check_oblivious] PASS ({scope}): no secret-derived access decision outside "
          f"the reviewed allowlist{reach}{teeth}; lock discipline and imports hold")
    return 0


if __name__ == "__main__":
    sys.exit(main())
