"""CI gate: the tree-top-cached round is index-blind AND cuts the path
traffic on the device trees to the bottom ``path_len − k`` levels (port of
``tools/check_tree_cache_oblivious.py``).

Claims, on captured graphs (:mod:`.fx_walk`):

1. **Index-independence.** ``oram_round`` is captured in real mode with
   the batch indices closed over as constants, once per adversarial
   index set (all distinct, all identical, all dummy, mixed duplicates):
   the op census is IDENTICAL across them and holds no control node.
2. **Row accounting.** Every gather/scatter whose operand holds one of the
   input's tree planes (``tree_idx`` / ``tree_leaf`` as ``[n, Z]`` bucket
   rows, ``tree_val`` ``[n, Z·V]``, ``nonces`` ``[n, 2]``; a kernel node
   moves ``flat_b``'s rows of each) moves exactly ``B·(path_len−k)`` rows,
   and the cache planes move ``B·k`` (present at k>0, absent at k=0).
   Only operands derived from the state's planes count
   (``plane_rows(..., sources=...)``), so a private array of a plane's
   shape is never tree traffic.
3. **Delayed eviction.** A fetch round (``evict_window`` > 1) is read-only
   on the tree planes; one ``oram_flush`` scatters exactly
   ``flush_target_slots`` rows a plane and gathers none.
4. **Sharding.** On a mesh (``parallel/mesh.py``: one controller, a
   device may repeat) each shard's gathers and scatters carry the full
   uniform shape; at run time every bucket the one-device flush writes is
   written by exactly its owner shard. The seeded unmasked-scatter mutant
   (the owner mask dropped, targets wrapped into each shard) must fail
   that check.

Each ``check_*`` has the reference tool's name, arguments (plus
``device``) and returned dict.

    python -m grapevine_tpu_torch.analysis.check_tree_cache_oblivious [--device cpu]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..device import resolve_device
from .check_posmap_oblivious import as_lanes, require_graph
from .fx_walk import (
    capture,
    census,
    control_counts,
    fake_inputs,
    kernel_nodes,
    plane_rows,
)

#: the OramState leaves that are the device tree planes and the cache planes
TREE_PLANES = ("tree_idx", "tree_val", "nonces", "tree_leaf")
CACHE_PLANES = ("cache_idx", "cache_val", "cache_leaf")


def index_sets(cfg, b: int) -> dict:
    rng = np.random.default_rng(11)
    return {
        "distinct": (np.arange(b) % cfg.blocks).astype(np.uint32),
        "all_same": np.zeros(b, np.uint32),
        "all_dummy": np.full(b, cfg.dummy_index, np.uint32),
        "mixed_dups": rng.integers(0, cfg.blocks + 1, b).astype(np.uint32),
    }


def _apply_sum(vals0, present0):
    return vals0.sum(dim=1), vals0, present0


def capture_round(cfg, idxs: np.ndarray, device=None, state=None, mesh=None):
    """A real-mode capture of one whole ``oram_round`` (the fetch-only round
    under delayed eviction) with ``idxs`` closed over as a constant. The
    round runs: the trees of ``state`` are written in place."""
    from ..oram import round as round_mod
    from .check_oblivious import oram_state

    dev = resolve_device(device)
    b = len(idxs)
    cidxs = as_lanes(idxs, dev)
    recursive = cfg.posmap is not None
    if state is None:
        state = sharded_state(oram_state(cfg, dev), mesh)

    def run(st, nl, dl, pm_nl, pm_dl):
        return round_mod.oram_round(
            cfg, st, cidxs, nl, dl, _apply_sum, "xla",
            pm_nl if recursive else None, pm_dl if recursive else None, mesh=mesh)

    leaves = [torch.zeros(b, dtype=torch.int32, device=dev) for _ in range(4)]
    return capture(run, state, *leaves,
                   names=("state", "new_leaves", "dummy_leaves", "pm_new_leaves",
                          "pm_dummy_leaves"),
                   tracing_mode="real", name="oram_round")


def capture_flush(cfg, device=None, state=None, mesh=None, tracing_mode: str = "fake"):
    """A capture of one ``oram_flush`` (fake by default: no index set)."""
    from ..oram import round as round_mod
    from .check_oblivious import oram_state

    dev = resolve_device(device)
    if state is None:
        state = (fake_inputs if tracing_mode == "fake" else (lambda f: f()))(
            lambda: sharded_state(oram_state(cfg, dev), mesh))
    return capture(lambda st: round_mod.oram_flush(cfg, st, "xla", mesh), state,
                   names=("state",), tracing_mode=tracing_mode, name="oram_flush")


def sharded_state(state, mesh):
    if mesh is None:
        return state
    from ..parallel.mesh import _shard_oram

    return _shard_oram(state, mesh)


def tree_planes(cfg, shards: int = 0) -> dict:
    """This geometry's tree planes (and cache planes at k>0) as
    ``plane_rows`` declarations: name -> (shape, divisor). With ``shards``
    the tree planes are one shard's: its heap range and its scratch row
    (``path_oram.ShardedPlane``); the cache planes stay whole."""
    z, v = cfg.bucket_slots, cfg.value_words
    n = cfg.n_buckets_padded
    if shards:
        n = n // shards + 1
    cb = cfg.cache_buckets
    planes = {"tree_idx": ((n, z), 1), "tree_val": ((n, z * v), 1), "nonces": ((n, 2), 1)}
    if cfg.posmap is not None:
        planes["tree_leaf"] = ((n, z), 1)
    if cb:
        planes["cache_idx"] = ((cb * z,), z)
        planes["cache_val"] = ((cb, z * v), 1)
        if cfg.posmap is not None:
            planes["cache_leaf"] = ((cb * z,), z)
    return planes


def _tree_names(cfg) -> list:
    return ["tree_idx", "tree_val", "nonces"] + (["tree_leaf"] if cfg.posmap is not None else [])


def state_sources(cap, root: str = "state") -> list:
    """The capture's placeholders holding one of ``root``'s own tree or
    cache planes (a shard's label ends ``.shards.<i>``); the internal
    map's planes (``state.posmap.inner.*``) are not among them."""
    phs = [n for n in cap.gm.graph.nodes if n.op == "placeholder"]
    out = []
    for lb, node in zip(cap.labels, phs):
        parts = lb.split(".")
        if len(parts) == 4 and parts[2] == "shards":
            parts = parts[:2]
        if len(parts) == 2 and parts[0] == root and parts[1] in TREE_PLANES + CACHE_PLANES:
            out.append(node)
    return out


def capture_rows(cap, planes: dict, root: str = "state") -> dict:
    """Rows moved per declared plane, counting only ``root``'s planes."""
    return plane_rows(cap.gm, planes, state_sources(cap, root))


def _nodes(cap) -> int:
    return sum(1 for n in cap.gm.graph.nodes if n.op == "call_function")


def _is_gather(op: str) -> bool:
    return "gather" in op or op.startswith(("aten.index.", "aten.index_select"))


def index_blind(cfg, b: int, what: str, device=None, state=None, mesh=None) -> tuple:
    """Claim 1 for one geometry: returns ``(mixed_dups capture, info)``,
    ``info`` holding the census size, nodes and capture seconds; raises
    AssertionError when the censuses differ or a control node appears."""
    censuses, seconds, caps = {}, [], {}
    for iname, idxs in index_sets(cfg, b).items():
        cap = capture_round(cfg, idxs, device, state, mesh)
        require_graph(cap, f"{what} ({iname})")
        censuses[iname] = census(cap.gm, shapes=True)
        seconds.append(cap.seconds)
        caps[iname] = cap
    base_name, base = next(iter(censuses.items()))
    for iname, c in censuses.items():
        assert c == base, (
            f"{what}: the round captures a DIFFERENT program for index set "
            f"{iname!r} vs {base_name!r}: {dict((c - base) + (base - c))} — the "
            "access schedule depends on the queried indices")
    ctl = control_counts(census(caps[base_name].gm))
    assert not ctl, f"{what}: data-dependent control in the round ({ctl})"
    mixed = caps["mixed_dups"]
    return mixed, dict(census_size=sum(base.values()), nodes=_nodes(mixed),
                       capture_s=seconds)


def round_accounting(cfg, b: int, device=None, state=None, what: str = "round") -> dict:
    """Claims 1-2 for one E=1 geometry (any ``k``, flat or recursive):
    every tree plane moves ``B·(path_len−k)`` rows an op, the cache planes
    ``B·k`` (absent at k=0). Returns ``rows`` (the reference's per-plane
    sets), ``info`` and the kernel nodes; raises on a violation."""
    from .fx_walk import kernel_nodes

    k = cfg.top_cache_levels
    plen = cfg.path_len
    want = b * (plen - k)
    tag = f"{what} k={k}"
    mixed, info = index_blind(cfg, b, tag, device, state)
    rows = capture_rows(mixed, tree_planes(cfg))
    for pname in _tree_names(cfg):
        moved = rows[pname]
        assert moved, f"{tag}: no accesses seen on {pname}"
        bad = [r for _, r in moved if r != want]
        assert not bad, (
            f"{tag}: {pname} moves {sorted(set(bad))} bucket rows per round — every "
            f"tree access must move exactly B·(path_len−k) = {b}·({plen}−{k}) = {want}")
    for pname in CACHE_PLANES:
        if pname not in rows:
            continue
        assert rows[pname], (
            f"{tag}: the cache plane {pname} is never accessed — the cached levels "
            "are not served from the cache")
        assert all(r == b * k for _, r in rows[pname]), (
            f"{tag}: {pname} moves {rows[pname]} — want B·k = {b * k} rows")
    assert k or not any(p in rows for p in CACHE_PLANES), (
        f"{tag}: k=0 must declare no cache planes")
    return dict(rows={p: sorted({r for _, r in rs}) for p, rs in rows.items() if rs},
                info=info, kernel_nodes=dict(kernel_nodes(mixed.gm)), want=want)


def check_tree_cache_schedule(b: int = 8, height: int = 5, verbose: bool = False,
                              recursive: bool = False, device=None) -> dict:
    """Both claims over k ∈ {0, 2}; raises AssertionError on any violation,
    returns the per-k row accounting."""
    from ..oram.path_oram import OramConfig
    from ..oram.posmap import derive_posmap_spec

    out = {}
    for k in (0, 2):
        pm = derive_posmap_spec(1 << height, top_cache_levels=k) if recursive else None
        cfg = OramConfig(height=height, value_words=8, n_blocks=1 << height,
                         cipher_rounds=8, top_cache_levels=k, posmap=pm)
        out[f"k{k}"] = round_accounting(cfg, b, device)["rows"]
        if verbose:
            print(f"k={k} ({'recursive' if recursive else 'flat'}): {out[f'k{k}']}")
    # positive control across k: the counter must SEE the cut
    full, cut = out["k0"]["tree_val"][0], out["k2"]["tree_val"][0]
    assert full == b * (height + 1) and cut == b * (height - 1), (
        f"positive control failed: k=0 moves {full} rows, k=2 moves {cut} — "
        f"expected {b * (height + 1)} vs {b * (height - 1)}")
    return out


def check_k0_recursive_census(b: int = 4, height: int = 5, device=None) -> dict:
    """The ``k=0``, recursive-map cell: claim 1 plus the full-path rows on
    every tree plane, the leaf plane included; returns the per-plane rows."""
    from ..oram.path_oram import OramConfig
    from ..oram.posmap import derive_posmap_spec

    cfg = OramConfig(height=height, value_words=8, n_blocks=1 << height, cipher_rounds=8,
                     top_cache_levels=0,
                     posmap=derive_posmap_spec(1 << height, top_cache_levels=0))
    return round_accounting(cfg, b, device)["rows"]


def evict_cfg(b: int, height: int, k: int, window: int, recursive: bool = False):
    from ..oram.path_oram import OramConfig
    from ..oram.posmap import derive_posmap_spec

    pm = (derive_posmap_spec(1 << height, top_cache_levels=k, evict_window=window,
                             evict_fetch_count=b) if recursive else None)
    return OramConfig(height=height, value_words=8, n_blocks=1 << height, cipher_rounds=8,
                      top_cache_levels=k, posmap=pm, evict_window=window,
                      evict_fetch_count=b, evict_buffer_slots=4 * b * window)


def fetch_accounting(rows: dict, cfg, want: int, what: str) -> dict:
    """A fetch round's rows: gathers of ``want`` rows on every tree plane,
    no scatter on any tree or cache plane."""
    acct = {}
    for pname in _tree_names(cfg):
        moved = rows[pname]
        gathers = [r for op, r in moved if _is_gather(op)]
        scatters = [(op, r) for op, r in moved if not _is_gather(op)]
        assert not scatters, (
            f"{what}: the fetch round SCATTERS to {pname} ({scatters}) — the "
            "steady-state round must be read-only on the device tree")
        if pname != "nonces" or cfg.encrypted:
            assert gathers and all(r == want for r in gathers), (
                f"{what}: {pname} fetch gathers move {sorted(set(gathers))} rows — "
                f"want exactly B·(path_len−k) = {want}")
        acct[pname] = sorted(set(gathers))
    for pname in CACHE_PLANES:
        assert all(_is_gather(op) for op, _ in rows.get(pname, [])), (
            f"{what}: the fetch round writes the cache plane {pname} — cached "
            "levels flush with everything else")
    return acct


def flush_accounting(rows: dict, cfg, want: int, what: str) -> dict:
    """A flush's rows: scatters of ``want`` rows on every tree plane (and
    on the cache planes at k>0), no gather."""
    acct = {}
    for pname in _tree_names(cfg):
        moved = rows[pname]
        gathers = [r for op, r in moved if _is_gather(op)]
        scatters = [r for op, r in moved if not _is_gather(op)]
        assert not gathers, (
            f"{what}: the flush GATHERS from {pname} — the window's live rows "
            "were already pulled into the buffer at fetch time")
        if pname != "nonces" or cfg.encrypted:
            assert scatters and all(r == want for r in scatters), (
                f"{what}: {pname} flush scatters move {sorted(set(scatters))} rows — "
                f"want exactly flush_target_slots = {want}")
        acct[pname] = sorted(set(scatters))
    for pname in ("cache_idx", "cache_val"):
        if pname in rows:
            sc = [r for op, r in rows[pname] if not _is_gather(op)]
            assert sc and set(sc) == {want}, (
                f"{what}: cache plane {pname} flush moves {rows[pname]} — want {want}")
    return acct


def evict_accounting(cfg, b: int, device=None, state=None, flush_state=None,
                     what: str = "evict") -> dict:
    """Claims 1 and 3 for one delayed-eviction geometry. ``flush_state``
    (default: a fake state) feeds the flush capture. Returns the
    reference's dict plus ``info``."""
    from ..oram.round import flush_target_slots

    k = cfg.top_cache_levels
    want_fetch = b * (cfg.path_len - k)
    want_flush = flush_target_slots(cfg)
    mixed, info = index_blind(cfg, b, f"{what} E={cfg.evict_window}", device, state)
    fetch = fetch_accounting(capture_rows(mixed, tree_planes(cfg)), cfg, want_fetch,
                             f"{what} E={cfg.evict_window}")
    fl = capture_flush(cfg, device, flush_state,
                       tracing_mode="fake" if flush_state is None else "real")
    flush = flush_accounting(capture_rows(fl, tree_planes(cfg)), cfg, want_flush,
                             f"{what} E={cfg.evict_window}")
    info["flush_nodes"] = _nodes(fl)
    info["flush_capture_s"] = fl.seconds
    return {"fetch": fetch, "flush": flush, "want_fetch_rows": want_fetch,
            "want_flush_rows": want_flush, "info": info}


def check_evict_round_accounting(b: int = 8, height: int = 7, k: int = 2, window: int = 2,
                                 verbose: bool = False, recursive: bool = False,
                                 device=None) -> dict:
    """The delayed-eviction schedule's row accounting: fetch rounds are
    index-blind and read-only on the trees (``B·(path_len−k)`` gathered
    rows a plane), one flush writes exactly ``flush_target_slots`` rows a
    plane and reads none. Returns the per-program accounting."""
    from ..oram.round import flush_target_slots

    cfg = evict_cfg(b, height, k, window, recursive)
    assert flush_target_slots(cfg) < cfg.n_buckets_padded, (
        "audit geometry must keep the flush target set unsaturated "
        f"(t={flush_target_slots(cfg)} vs n_buckets_padded={cfg.n_buckets_padded})")
    # the saturation clamp (the amortization bound) is arithmetic
    sat = evict_cfg(b, 3, 0, 8, False)
    assert flush_target_slots(sat) == sat.n_buckets_padded
    out = evict_accounting(cfg, b, device)
    out.pop("info")
    if verbose:
        print(f"E={window} k={k} ({'recursive' if recursive else 'flat'}): {out}")
    return out


def _unmasked_scatter_mutant(orig):
    """The seeded defect the sharded audit exists to catch: a sharded
    ``_path_scatter_`` that keeps the dedup owner mask but DROPS the shard
    mask — every shard writes every owned target into its own plane at a
    wrapped index, so the union across the mesh is no longer the one-device
    flush."""

    def mutant(tree, path_b, new_vals, owner, mesh=None):
        if mesh is None:
            return orig(tree, path_b, new_vals, owner, mesh)
        for i, shard in enumerate(tree.shards):
            loc = torch.remainder(path_b - i * tree.n_local, tree.n_local)  # wraps
            shard[torch.where(owner, loc, tree.n_local).long()] = new_vals
        return tree

    return mutant


def clone_state(value):
    """A copy of a state pytree, every tensor leaf cloned."""
    from .fx_walk import flatten

    _, ts, rebuild = flatten(value, "")
    return rebuild([t.clone() for t in ts])


def owner_partition(cfg, b: int, mesh, device=None, state=None,
                    _unmasked_scatter: bool = False, seed: int = 5) -> dict:
    """Claim 4 at run time: a window of fetch rounds and a flush, sharded
    on ``mesh`` and on one device from the same state. Every bucket row
    the one-device flush writes is written by exactly its owner shard, the
    per-shard counts sum to the one-device count and the joined planes are
    equal. Returns the per-shard written rows."""
    from ..oram import round as round_mod
    from ..oram.path_oram import ShardedPlane
    from ..oram.posmap import inner_oram_config
    from .check_oblivious import oram_state

    dev = resolve_device(device)
    st_1 = oram_state(cfg, dev) if state is None else state
    st_s = sharded_state(clone_state(st_1), mesh)
    recursive = cfg.posmap is not None
    il = inner_oram_config(cfg.posmap).leaves if recursive else cfg.leaves
    rng = np.random.default_rng(seed)
    for _ in range(cfg.evict_window):
        idxs = as_lanes(rng.integers(0, cfg.blocks + 1, b).astype(np.uint32), dev)
        draws = [as_lanes(rng.integers(0, hi, b).astype(np.uint32), dev)
                 for hi in (cfg.leaves, cfg.leaves, il, il)]
        pm = draws[2:] if recursive else [None, None]
        st_s, _, tr_s = round_mod.oram_round(cfg, st_s, idxs, draws[0], draws[1], _apply_sum,
                                             "xla", *pm, mesh=mesh)
        st_1, _, tr_1 = round_mod.oram_round(cfg, st_1, idxs, draws[0], draws[1], _apply_sum,
                                             "xla", *pm)
        assert torch.equal(tr_s, tr_1), "the sharded round's transcript differs"
    pre = st_1.nonces.clone()
    orig = round_mod._path_scatter_
    if _unmasked_scatter:
        round_mod._path_scatter_ = _unmasked_scatter_mutant(orig)
    try:
        post_s = round_mod.oram_flush(cfg, st_s, "xla", mesh)
    finally:
        round_mod._path_scatter_ = orig
    post_1 = round_mod.oram_flush(cfg, st_1, "xla")

    # every flush rewrites its targets' nonces, so changed nonce rows are
    # the written buckets; the junk bucket (the last row, which no heap id
    # addresses) is scratch: a fused kernel's plain version writes it
    junk = cfg.n_buckets_padded - 1
    oracle = set(torch.nonzero((post_1.nonces != pre).any(dim=1)).flatten().tolist()) - {junk}
    n_local = post_s.nonces.n_local
    per_shard, union = [], set()
    for s, local in enumerate(post_s.nonces.local()):
        lo = s * n_local
        ch = {int(r) + lo for r in
              torch.nonzero((local.to(dev) != pre[lo:lo + n_local]).any(dim=1)).flatten()} - {junk}
        per_shard.append(len(ch))
        union |= ch
    assert sum(per_shard) == len(oracle) and union == oracle, (
        f"shards={mesh.size} E={cfg.evict_window}: owner partition violated — per-shard "
        f"written rows {per_shard} (sum {sum(per_shard)}) vs the one-device flush's "
        f"{len(oracle)} written rows; every written bucket must be written by exactly "
        "its heap-range owner and the union must be the one-device write set")
    z = cfg.bucket_slots
    for name in _tree_names(cfg):
        a, b1 = getattr(post_s, name), getattr(post_1, name)
        a = a.join(dev) if isinstance(a, ShardedPlane) else a
        rows = (z if name in ("tree_idx", "tree_leaf") else 1)
        # the junk bucket (the last row) is scratch on one device
        assert torch.equal(a[:-rows], b1[:-rows]), (
            f"shards={mesh.size} E={cfg.evict_window}: the sharded flush diverges from "
            f"one device on {name}")
    return {"per_shard_written": per_shard, "oracle_written": len(oracle)}


def sharded_accounting(cfg, b: int, mesh, device=None, state=None,
                       what: str = "sharded") -> dict:
    """Claim 4 on the captured graphs: each shard's fetch gathers carry
    ``B·(path_len−k)`` rows (non-owned lanes masked, never absent) and no
    scatter; each shard's flush scatters carry all ``t`` rows and no
    gather."""
    from ..oram.round import flush_target_slots

    shards = mesh.size
    want_fetch = b * (cfg.path_len - cfg.top_cache_levels)
    want_flush = flush_target_slots(cfg)
    assert cfg.n_buckets_padded % shards == 0
    lplanes = tree_planes(cfg, shards)
    tag = f"{what} shards={shards} E={cfg.evict_window}"
    if state is not None:
        state = sharded_state(state, mesh)
    mixed, info = index_blind(cfg, b, tag, device, state, mesh)
    fetch = fetch_accounting(capture_rows(mixed, lplanes), cfg, want_fetch, tag)
    fl = capture_flush(cfg, device, mesh=mesh)
    frows = capture_rows(fl, lplanes)
    flush = flush_accounting(frows, cfg, want_flush, tag)
    for pname in _tree_names(cfg):
        assert len(frows[pname]) % shards == 0, (
            f"{tag}: {pname} flush scatters {frows[pname]} are not one set a shard")
    info["flush_nodes"] = _nodes(fl)
    return {"fetch": fetch, "flush": flush, "want_fetch_rows": want_fetch,
            "want_flush_rows": want_flush, "shards": shards, "info": info}


def check_sharded_evict_accounting(b: int = 6, height: int = 7, k: int = 2, window: int = 2,
                                   shards: int = 2, verbose: bool = False,
                                   recursive: bool = False, runtime: bool = True,
                                   _unmasked_scatter: bool = False, device=None) -> dict:
    """The delayed-eviction accounting of the sharded program on a virtual
    mesh of ``shards`` shards of ``device``: trace claims, then (with
    ``runtime``) the owner partition. ``_unmasked_scatter=True`` seeds the
    control defect, which the runtime check must FAIL on."""
    from ..parallel.mesh import make_mesh

    dev = resolve_device(device)
    mesh = make_mesh([dev] * shards)
    cfg = evict_cfg(b, height, k, window, recursive)
    out = sharded_accounting(cfg, b, mesh, dev)
    out.pop("info")
    if runtime:
        out.update(owner_partition(cfg, b, mesh, dev, _unmasked_scatter=_unmasked_scatter))
    if verbose:
        print(f"sharded E={window} k={k} shards={shards} "
              f"({'recursive' if recursive else 'flat'}"
              f"{'' if runtime else ', trace only'}): {out}")
    return out


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--height", type=int, default=5)
    ap.add_argument("--device", default=None, help="default: the card; 'cpu' for the plain path")
    args = ap.parse_args(argv)
    dev = args.device
    for recursive in (False, True):
        out = check_tree_cache_schedule(b=args.batch, height=args.height, verbose=True,
                                        recursive=recursive, device=dev)
        print(f"[check_tree_cache_oblivious] recursive={recursive}: OK {out}")
    out = check_k0_recursive_census(b=4, height=5, device=dev)
    print(f"[check_tree_cache_oblivious] k0-recursive cell: OK {out}")
    for recursive in (False, True):
        check_evict_round_accounting(verbose=True, recursive=recursive, device=dev)
        print("[check_tree_cache_oblivious] evict schedule "
              f"(recursive={recursive}): OK")
    for recursive in (False, True):
        check_sharded_evict_accounting(verbose=True, recursive=recursive, device=dev)
        print("[check_tree_cache_oblivious] sharded evict schedule "
              f"(recursive={recursive}): OK")
    try:
        check_sharded_evict_accounting(_unmasked_scatter=True, device=dev)
    except AssertionError as exc:
        print("[check_tree_cache_oblivious] seeded unmasked-scatter "
              f"mutant: FAIL (expected) ({str(exc)[:72]}...)")
    else:
        print("[check_tree_cache_oblivious] FAIL: seeded unmasked-scatter mutant "
              "passed the sharded partition audit")
        return 1
    print("[check_tree_cache_oblivious] PASS: cached round is index-blind and the "
          "tree traffic is exactly B·(path_len−k) rows per plane; delayed-eviction "
          "fetch rounds are read-only on the trees, each flush writes exactly the "
          "E-round window, and the sharded flush owner-partitions that window")
    return 0


if __name__ == "__main__":
    sys.exit(main())
