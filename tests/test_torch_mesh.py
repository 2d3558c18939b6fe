"""The port's device mesh (``grapevine_tpu_torch/parallel/mesh.py``):

- its state specs equal the JAX package's ``engine_state_specs`` leaf
  for leaf (the port's extra ``pm_rng`` replicated, as ``rng``);
- shard → unshard is the identity on every leaf, each shard holding its
  contiguous heap range plus one scratch bucket row that the logical
  views leave out, and a 2-shard state reshards to 4;
- the sharded gather and scatter equal the one-device ones on random
  planes, the scatter writing only owned rows and never the junk bucket;
- the refusals of ``tests/test_parallel.py:141-163``: power of two,
  ``commit='op'``, too few devices on CUDA, "padded buckets" for a mesh
  of 6, and "evict_every=1 has no flush"; and no mesh without CUDA unless
  the devices are named.
"""

import jax
import numpy as np
import pytest
import torch

from grapevine_tpu.config import GrapevineConfig as JConfig
from grapevine_tpu.engine.state import EngineConfig as JEcfg
from grapevine_tpu.parallel import engine_state_specs as jspecs
from grapevine_tpu.parallel import make_mesh as jmake_mesh
from grapevine_tpu.parallel import make_sharded_step as jmake_step
from grapevine_tpu_torch.config import GrapevineConfig
from grapevine_tpu_torch.engine.convert import first_difference, to_numpy
from grapevine_tpu_torch.engine.state import EngineConfig, init_engine
from grapevine_tpu_torch.oram.path_oram import (
    ShardedPlane,
    _path_gather,
    _path_scatter_,
    oram_leaves,
)
from grapevine_tpu_torch.parallel import (
    REPLICATED,
    SHARDED,
    engine_state_specs,
    init_sharded_engine,
    make_mesh,
    make_sharded_flush,
    make_sharded_step,
    shard_engine_state,
    unshard_engine_state,
)
from _torch_jax_cache import shared_jax_compile_cache  # noqa: F401

KW = dict(max_messages=64, max_recipients=8, mailbox_cap=4, batch_size=4, stash_size=64)


def test_specs_match_the_reference_leaf_for_leaf():
    js, ts = jspecs(), engine_state_specs()
    for f in js._fields:
        jx, tx = getattr(js, f), getattr(ts, f)
        if f in ("rec", "mb"):
            assert jx._fields == tx._fields
            for g in jx._fields:
                assert tuple(getattr(jx, g)) == getattr(tx, g), f"{f}.{g}"
        else:
            assert tuple(jx) == tx, f
    assert set(ts._fields) - set(js._fields) == {"pm_rng"} and ts.pm_rng == REPLICATED
    sharded = {g for g in ts.rec._fields if getattr(ts.rec, g) == SHARDED}
    assert sharded == {"tree_idx", "tree_val", "tree_leaf", "nonces"}


def _random_state(ecfg, seed):
    """A state whose every u32 leaf is random words from numpy (so a
    misplaced row shows)."""
    st = init_engine(ecfg, 0, "cpu")
    rng = np.random.default_rng(seed)

    def fill(t):
        if t.numel():
            t.copy_(torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, t.shape,
                                                  dtype=np.int64).astype(np.int32)))

    for o in (st.rec, st.mb):
        for t in oram_leaves(o).values():
            fill(t)
    for k in ("freelist", "seq", "hash_key", "id_key"):
        fill(getattr(st, k))
    return st


@pytest.mark.parametrize("kw", [dict(KW), dict(KW, posmap_impl="recursive", evict_every=2)])
def test_shard_unshard_is_the_identity(kw):
    ecfg = EngineConfig.from_config(GrapevineConfig(**kw))
    st = _random_state(ecfg, 11)
    want = to_numpy(st)
    for n in (2, 4):
        mesh = make_mesh(["cpu"] * n)
        sst = shard_engine_state(st, mesh)
        assert first_difference(to_numpy(sst), want, mask_junk=False) is None
        for cfg, o, so in ((ecfg.rec, st.rec, sst.rec), (ecfg.mb, st.mb, sst.mb)):
            n_local = cfg.n_buckets_padded // n
            z = cfg.bucket_slots
            for f in ("tree_idx", "tree_val", "nonces") + (
                    ("tree_leaf",) if ecfg.posmap_impl == "recursive" else ()):
                plane = getattr(so, f)
                assert isinstance(plane, ShardedPlane) and plane.n_local == n_local
                k = z if f in ("tree_idx", "tree_leaf") else 1
                full = getattr(o, f)
                for i, s in enumerate(plane.shards):
                    # the heap range, then one scratch bucket row
                    assert s.shape[0] == (n_local + 1) * k
                    assert torch.equal(s[:n_local * k], full[i * n_local * k:(i + 1) * n_local * k])
                assert plane.join("cpu").shape == full.shape
            if ecfg.posmap_impl != "recursive":
                assert isinstance(so.tree_leaf, torch.Tensor) and so.tree_leaf.numel() == 0
        back = unshard_engine_state(sst)
        assert isinstance(back.rec.tree_val, torch.Tensor)
        assert first_difference(to_numpy(back), want, mask_junk=False) is None
        # a state already on the mesh comes back as it is; another count reshards
        assert shard_engine_state(sst, mesh).rec.tree_val is sst.rec.tree_val
        other = shard_engine_state(sst, make_mesh(["cpu"] * (6 - n)))
        assert len(other.rec.tree_val.shards) == 6 - n
        assert first_difference(to_numpy(other), want, mask_junk=False) is None


def test_init_sharded_engine_equals_init_engine():
    ecfg = EngineConfig.from_config(GrapevineConfig(**KW, posmap_impl="recursive"))
    one = init_engine(ecfg, 5, "cpu")
    for n in (2, 4):
        sst = init_sharded_engine(ecfg, make_mesh(["cpu"] * n), 5)
        assert len(sst.mb.tree_idx.shards) == n
        assert first_difference(to_numpy(sst), to_numpy(one), mask_junk=False) is None
        assert torch.equal(sst.rng.get_state(), one.rng.get_state())


@pytest.mark.parametrize("n", [2, 4, 8])
def test_sharded_gather_and_scatter_equal_one_device(n):
    rng = np.random.default_rng(n)
    rows, width, r = 32, 5, 40  # 32 padded buckets; row 31 is the junk bucket
    tree = torch.from_numpy(rng.integers(-9, 9, (rows, width)).astype(np.int32))
    path_b = torch.from_numpy(rng.integers(0, rows - 1, r).astype(np.int32))
    mesh = make_mesh(["cpu"] * n)
    n_local = rows // n
    plane = ShardedPlane([torch.cat([tree[i * n_local:(i + 1) * n_local],
                                     torch.full((1, width), 77, dtype=torch.int32)])
                          for i in range(n)], n_local)
    assert torch.equal(_path_gather(plane, path_b, mesh), _path_gather(tree, path_b))
    # owned rows: one owner per distinct bucket (its first slot); some masked off
    first = torch.from_numpy(np.unique(path_b.numpy(), return_index=True)[1])
    owner = torch.zeros(r, dtype=torch.bool)
    owner[first] = True
    owner[::7] = False
    vals = torch.from_numpy(rng.integers(100, 200, (r, width)).astype(np.int32))
    want = _path_scatter_(tree.clone(), path_b, vals, owner)
    _path_scatter_(plane, path_b, vals, owner, mesh)
    assert torch.equal(plane.join("cpu"), want)
    assert torch.equal(plane.join("cpu")[-1], tree[-1])  # the junk bucket untouched


def test_sharded_refusals_match_the_reference(monkeypatch):
    from grapevine_tpu_torch.engine.batcher import GrapevineEngine

    with pytest.raises(ValueError, match="power-of-two"):
        GrapevineConfig(shards=3)
    with pytest.raises(ValueError, match="commit='op'"):
        GrapevineConfig(shards=2, commit="op")
    ekw = dict(KW, bucket_cipher_rounds=8, evict_every=2)
    ecfg = EngineConfig.from_config(GrapevineConfig(**ekw))
    with pytest.raises(ValueError, match="evict_every=1 has no flush"):
        make_sharded_flush(EngineConfig.from_config(GrapevineConfig(**KW)),
                           make_mesh(["cpu"] * 2))
    # a mesh that does not divide the padded bucket counts names the tree,
    # with the reference's text
    with pytest.raises(ValueError, match="padded buckets") as jexc:
        jmake_step(JEcfg.from_config(JConfig(**ekw)), jmake_mesh(jax.devices()[:6]))
    for build in (make_sharded_step, make_sharded_flush):
        with pytest.raises(ValueError, match="padded buckets") as exc:
            build(ecfg, make_mesh(["cpu"] * 6))
        assert str(exc.value) == str(jexc.value)
    # no CUDA: no mesh unless its devices are named, and no CPU fallback
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        GrapevineEngine(GrapevineConfig(**KW, shards=2))
    # too few cards: the facade refuses before it allocates anything
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="only 1 CUDA device"):
        GrapevineEngine(GrapevineConfig(**KW, shards=2))
    with pytest.raises(ValueError, match="mesh_devices needs shards > 1"):
        GrapevineEngine(GrapevineConfig(**KW), device="cpu", mesh_devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="2 mesh devices were given"):
        GrapevineEngine(GrapevineConfig(**KW, shards=4), device="cpu",
                        mesh_devices=["cpu"] * 2)
