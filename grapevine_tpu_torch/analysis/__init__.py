"""Static analysis of the engine's round (port of ``grapevine_tpu/analysis``).

- :mod:`oblint` — taint-propagation analyzer over a captured FX graph
  (:mod:`fx_walk`) proving that no gather/scatter index, cond/while
  predicate, slice start, kernel address or host read in a captured
  engine round is secret-derived, modulo the reviewed allowlist
  (:mod:`allowlist`) of oblivious-by-construction sites; :mod:`mutants`
  are its seeded positive controls, :mod:`check_oblivious` the gate
  over the knob matrix.
- :mod:`rangelint` — interval-domain overflow certification of the same
  graph (u32 lanes on int32 storage): overflow, truncating conversions,
  out-of-range indices including the kernels' address operands, from the
  ``RANGELINT_BOUNDS`` anchors, modulo ``allowlist.RANGE_ALLOWLIST``; its
  range mutants and :mod:`check_ranges`, the gate at 2^30 records a tree;
  ``rangelint.witness`` holds a real capture's values against the
  certified intervals.
- :mod:`costmodel` — the round-cost ledger, analytic and traced, held
  equal per shape class (``cross_validate_*``), with its undercount
  mutants and :mod:`check_cost_model`, the gate.
- :mod:`locklint` — AST lock-discipline lint for the pipelined host path;
  :mod:`importlint` — the stdlib import lint.

- The census gates, on the same captures: :mod:`check_posmap_oblivious`
  (the position map's lookup captures one program whatever indices are
  asked) and :mod:`check_tree_cache_oblivious` (the cached round reads
  only the bottom ``path_len − k`` levels of each tree plane, a
  delayed-eviction flush writes exactly its window, the sharded flush
  owner-partitions it); :mod:`check_sort_radix`, the radix knob's
  zero-sort audit (``fx_walk.sort_census``); :mod:`check_telemetry_policy`,
  the static scan of the instrumentation call sites and the registry
  audits.

``check_cost_model --grade`` waits for the benchmark (ROADMAP.md queue A,
item 17e).
"""

import importlib

#: export -> submodule; loaded on first use, so importing the package (or
#: its torch-free cost model) does not import torch
_EXPORTS = {
    "capture": "fx_walk", "census": "fx_walk", "plane_rows": "fx_walk",
    "site_of": "fx_walk", "walk_nodes": "fx_walk", "sort_census": "fx_walk",
    "check_posmap_access_schedule": "check_posmap_oblivious",
    "check_tree_cache_schedule": "check_tree_cache_oblivious",
    "check_k0_recursive_census": "check_tree_cache_oblivious",
    "check_evict_round_accounting": "check_tree_cache_oblivious",
    "check_sharded_evict_accounting": "check_tree_cache_oblivious",
    "check_radix_zero_sort": "check_sort_radix",
    "scan_call_sites": "check_telemetry_policy",
    "audit_live_registry": "check_telemetry_policy",
    "AllowEntry": "oblint", "OblintReport": "oblint", "Violation": "oblint",
    "analyze": "oblint", "census_equal": "oblint",
    "RangeFinding": "rangelint", "RangeReport": "rangelint",
    "analyze_ranges": "rangelint", "audit_ranges": "rangelint", "witness": "rangelint",
    "CostModelMismatch": "costmodel", "cross_validate_round": "costmodel",
    "cross_validate_flush": "costmodel", "cross_validate_sharded_flush": "costmodel",
    "cross_validate_engine_round": "costmodel", "cross_validate_engine_flush": "costmodel",
    "cross_validate_sweep": "costmodel",
}
__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f".{_EXPORTS[name]}", __name__), name)
