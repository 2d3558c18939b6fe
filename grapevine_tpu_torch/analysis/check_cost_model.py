"""Gate: the cost model's two-derivation identity and its mutant teeth
(counterpart of ``tools/check_cost_model.py``).

1. **Ledger = census** (``--smoke``): the analytic rows
   (:mod:`.costmodel`, a pure function of geometry × knobs) must equal
   the rows the captured graph moves, per operand shape class, over the
   shipped matrix: cache-k × posmap × evict_every for
   ``oram_round``/``oram_flush``, the engine round at E=1 and E=2, the
   engine flush, the expiry sweep's chunk passes, and the owner-masked
   flush on a 2-shard virtual mesh. Captures are fake: nothing runs.
2. **Teeth**: every seeded undercount mutant must raise
   :class:`.costmodel.CostModelMismatch` of its own kind.
3. **Grading** (``--grade``) waits: it replays the banked A/B trajectory,
   whose measured winners are TPU runs, and the port states no TPU
   number. It waits for the port's own A/B lines on the card; until then
   ``--grade`` exits 2 and says why.

Run: ``python -m grapevine_tpu_torch.analysis.check_cost_model [--smoke]
[--device D] [--skip-mutants] [-v]`` — on the card unless ``--device cpu``
is given (no card: it raises).
"""

from __future__ import annotations

import sys

from . import costmodel as cm

#: why ``--grade`` does not run yet
GRADE_WAITS = ("--grade waits for the port's own banked A/B lines on the card: the "
               "banked trajectory's measured winners are TPU runs, and the port states no "
               "TPU number")


def run_identity_matrix(device=None, verbose: bool = False) -> list:
    """Cross-validate analytic against traced rows over the shipped
    matrix; returns problem strings (empty = pass)."""
    problems = []

    def run(label, fn, *a, **kw):
        try:
            fn(*a, device=device, **kw)
            if verbose:
                print(f"[check_cost_model]   ok {label}")
        except cm.CostModelMismatch as m:
            problems.append(f"{label}: {m}")

    for name, cfg, b in cm.audit_oram_configs():
        run(f"round/{name}", cm.cross_validate_round, cfg, b)
        if cfg.delayed_eviction:
            run(f"flush/{name}", cm.cross_validate_flush, cfg)
    for name, ecfg in cm.audit_engine_configs():
        run(f"{name}/round", cm.cross_validate_engine_round, ecfg)
        if ecfg.evict_every > 1:
            run(f"{name}/flush", cm.cross_validate_engine_flush, ecfg)
        run(f"{name}/sweep", cm.cross_validate_sweep, ecfg)
    for name, cfg, shards in cm.audit_sharded_flush_configs():
        run(f"{name}/s{shards}", cm.cross_validate_sharded_flush, cfg, shards)
    return problems


def run_cost_mutant_controls(device=None, log=None) -> list:
    from .mutants import control_failures

    log = log or (lambda line: print(f"[check_cost_model] {line}"))
    return control_failures(cm.run_cost_mutants(device), "cost-model mutant", log)


def main(argv=None) -> int:
    import argparse

    from ..device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="the identity matrix and the mutants (the default)")
    ap.add_argument("--grade", action="store_true", help="grade against banked A/B lines")
    ap.add_argument("--device", default=None,
                    help="device of the captured tensors (default: the CUDA card)")
    ap.add_argument("--skip-mutants", action="store_true")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)
    if args.grade:
        print(f"[check_cost_model] {GRADE_WAITS}")
        return 2
    device = resolve_device(args.device)
    print("[check_cost_model] cross-validating the ledger against the captured census "
          "(shipped knob matrix, fake captures)")
    problems = run_identity_matrix(device, args.verbose)
    if not args.skip_mutants:
        problems.extend(run_cost_mutant_controls(device))
    if problems:
        print(f"[check_cost_model] FAIL: {len(problems)} problem(s)")
        for p in problems:
            print(f"  - {p}")
        return 1
    teeth = "" if args.skip_mutants else "; all undercount mutants caught"
    print(f"[check_cost_model] PASS (smoke): ledger == census bit-exactly per shape "
          f"class{teeth}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
