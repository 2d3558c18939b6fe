"""Static analysis of the engine's round (port of ``grapevine_tpu/analysis``,
the part ported so far).

- :mod:`oblint` — taint-propagation analyzer over a captured FX graph
  (:mod:`fx_walk`) proving that no gather/scatter index, cond/while
  predicate, slice start, kernel address or host read in a captured
  engine round is secret-derived, modulo the reviewed allowlist
  (:mod:`allowlist`) of oblivious-by-construction sites; :mod:`mutants`
  are its seeded positive controls, :mod:`check_oblivious` the gate
  over the knob matrix.
- :mod:`locklint` — AST lock-discipline lint for the pipelined host path;
  :mod:`importlint` — the stdlib import lint.
- :mod:`costmodel` — the analytic round-cost ledger.

The range analyzer, the cost model's traced half and the census gates
built on them are ROADMAP.md queue A item 17's second half.
"""

import importlib

#: export -> submodule; loaded on first use, so importing the package (or
#: its torch-free cost model) does not import torch
_EXPORTS = {
    "capture": "fx_walk", "census": "fx_walk", "plane_rows": "fx_walk",
    "site_of": "fx_walk", "walk_nodes": "fx_walk",
    "AllowEntry": "oblint", "OblintReport": "oblint", "Violation": "oblint",
    "analyze": "oblint", "census_equal": "oblint",
}
__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f".{_EXPORTS[name]}", __name__), name)
