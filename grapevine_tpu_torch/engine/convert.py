"""Engine state carried across packages, as flat numpy leaves.

Leaf names are dotted paths over the reference's ``EngineState`` pytree
(``"rec.tree_idx"``, ``"mb.epoch"``, ``"free_top"``, ...); values are
numpy ``uint32`` arrays with the reference's shapes, the delayed-eviction
planes (``ebuf_*``, ``fetch_tag``) included. The random stream
(``rng``) is not a leaf: a JAX PRNG key and a ``torch.Generator`` have
no common form, so a state taken across gets a fresh generator.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..oram.path_oram import OramState, oram_leaf_shapes
from ..u32 import from_numpy, to_numpy as _t2n
from .state import EngineConfig, EngineState

_ENGINE_LEAVES = ("freelist", "free_top", "recipients", "seq", "hash_key", "id_key")


def from_jax_state(ecfg: EngineConfig, leaves: dict, seed: int = 0,
                   device=None) -> EngineState:
    """Build the port's ``EngineState`` on ``device`` (``None`` → the CUDA
    card; raises without one) from flat numpy leaves (as :func:`to_numpy`
    names them); the generator is seeded with ``seed``. Every array is
    copied, so the source buffers are never written."""
    dev = resolve_device(device)

    def tree(prefix):
        return OramState(**{
            f: from_numpy(leaves[f"{prefix}.{f}"], dev) for f in OramState._fields
        })

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    st = EngineState(
        rec=tree("rec"), mb=tree("mb"),
        **{k: from_numpy(leaves[k], dev) for k in _ENGINE_LEAVES},
        rng=gen,
    )
    for name, cfg, o in (("rec", ecfg.rec, st.rec), ("mb", ecfg.mb, st.mb)):
        for f, shape in oram_leaf_shapes(cfg).items():
            got = tuple(getattr(o, f).shape)
            if got != shape:
                raise ValueError(f"{name}.{f} shape {got} does not match the "
                                 f"geometry {shape}")
    return st


def to_numpy(state: EngineState) -> dict:
    """Flat numpy u32 leaves of ``state`` (no ``rng``)."""
    out = {}
    for name in ("rec", "mb"):
        o = getattr(state, name)
        for f in OramState._fields:
            out[f"{name}.{f}"] = _t2n(getattr(o, f))
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
    ``testing/compare.py:states_equal_excluding_junk``)."""
    if a.keys() != b.keys():
        return "<leaf names>"
    for key in a:
        x, y = np.asarray(a[key]), np.asarray(b[key])
        if x.shape != y.shape:
            return key
        if mask_junk:
            if key.endswith(("tree_val", "nonces")):
                x, y = x[:-1], y[:-1]
            elif key.endswith("tree_idx"):
                z = x.size // np.asarray(a[key[:-3] + "val"]).shape[0]
                x, y = x[:-z], y[:-z]
        if not np.array_equal(x, y):
            return key
    return None
