"""Engine state carried across packages, as flat numpy leaves.

Leaf names are dotted paths over the reference's ``EngineState`` pytree
(``"rec.tree_idx"``, ``"mb.epoch"``, ``"free_top"``, ...); values are
numpy ``uint32`` arrays with the reference's shapes, the delayed-eviction
planes (``ebuf_*``, ``fetch_tag``) and a recursive map's internal tree
(``"rec.posmap.inner.tree_idx"``, ..., ``"rec.posmap.dummy_entry"``) and
leaf planes included. The random streams (``rng``, a recursive map's
``pm_rng``) are not leaves: a JAX PRNG key and a ``torch.Generator``
have no common form, so a state taken across gets fresh generators.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..oram.path_oram import oram_from_leaves, oram_leaf_shapes, oram_leaves
from ..u32 import from_numpy, to_numpy as _t2n
from .state import EngineConfig, EngineState, side_generator

_ENGINE_LEAVES = ("freelist", "free_top", "recipients", "seq", "hash_key", "id_key")


def from_jax_state(ecfg: EngineConfig, leaves: dict, seed: int = 0,
                   device=None) -> EngineState:
    """Build the port's ``EngineState`` on ``device`` (``None`` → the CUDA
    card; raises without one) from flat numpy leaves (as :func:`to_numpy`
    names them); the generator is seeded with ``seed``. Every array is
    copied, so the source buffers are never written."""
    dev = resolve_device(device)

    def tree(prefix, cfg):
        return oram_from_leaves(
            cfg, lambda f: from_numpy(leaves[f"{prefix}.{f}"], dev))

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    st = EngineState(
        rec=tree("rec", ecfg.rec), mb=tree("mb", ecfg.mb),
        **{k: from_numpy(leaves[k], dev) for k in _ENGINE_LEAVES},
        rng=gen,
        pm_rng=side_generator(gen) if ecfg.posmap_impl == "recursive" else None,
    )
    for name, cfg, o in (("rec", ecfg.rec, st.rec), ("mb", ecfg.mb, st.mb)):
        have = oram_leaves(o)
        for f, shape in oram_leaf_shapes(cfg).items():
            got = tuple(have[f].shape)
            if got != shape:
                raise ValueError(f"{name}.{f} shape {got} does not match the "
                                 f"geometry {shape}")
    return st


def to_numpy(state: EngineState) -> dict:
    """Flat numpy u32 leaves of ``state`` (no ``rng``); a tree plane
    sharded over a mesh gives its logical plane (``u32.to_numpy``)."""
    out = {}
    for name in ("rec", "mb"):
        for f, t in oram_leaves(getattr(state, name)).items():
            out[f"{name}.{f}"] = _t2n(t)
    for k in _ENGINE_LEAVES:
        out[k] = _t2n(getattr(state, k))
    return out


def first_difference(a: dict, b: dict, mask_junk: bool = True):
    """First leaf name where two flat states differ, or None.

    With ``mask_junk`` the padded junk bucket (the last row of each
    tree's ``tree_idx``/``tree_val``/``nonces``) is excluded: the fused
    scatters' plain versions (and the reference's kernels) redirect
    non-owner rows there while the card's kernels leave it alone, so its
    bytes are unspecified (the reference's
    ``testing/compare.py:states_equal_excluding_junk``). A recursive map's
    ``tree_leaf`` junk row is excluded too: the sweep re-keys it under
    that bucket's nonce row."""
    if a.keys() != b.keys():
        return "<leaf names>"
    for key in a:
        x, y = np.asarray(a[key]), np.asarray(b[key])
        if x.shape != y.shape:
            return key
        if mask_junk:
            if key.endswith(("tree_val", "nonces")):
                x, y = x[:-1], y[:-1]
            elif key.endswith(("tree_idx", "tree_leaf")):
                z = x.size // np.asarray(a[key.rsplit("_", 1)[0] + "_val"]).shape[0]
                x, y = x[:x.size - z], y[:y.size - z]
        if not np.array_equal(x, y):
            return key
    return None
