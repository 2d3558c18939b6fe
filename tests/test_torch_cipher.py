"""At-rest cipher and the fused gather/scatter functions of the port
(grapevine_tpu_torch/oblivious/{bucket_cipher,gather_kernels}.py) held
against the JAX package: the keystream against
``grapevine_tpu/oblivious/bucket_cipher.py`` and the plain gather/scatter
versions against the Pallas kernels in interpret mode. Integer
functions: tolerance 0 (the scatter's junk bucket masked).

The JAX side is imported inside the tests that use it, so the CUDA test
also runs where JAX is absent (on the card, without this directory's
conftest: ``python -m pytest --noconftest tests/test_torch_cipher.py -k
cuda``)."""

import numpy as np
import pytest
import torch

from grapevine_tpu_torch.oblivious import bucket_cipher as tbc
from grapevine_tpu_torch.oblivious import gather_kernels as gk
from grapevine_tpu_torch.u32 import from_numpy, to_numpy

#: (z, z*v, tree buckets): a small bucket and a records-width row
#: (z=4, v=256 → 1028 row words, 65 ChaCha blocks)
GEOMETRIES = [(4, 24, 64), (4, 1024, 16)]


def _u32(rng, shape, high=2**32):
    return rng.integers(0, high, shape, dtype=np.uint64).astype(np.uint32)


def _t(x):
    return from_numpy(x, "cpu")


def _jax():
    """(jax.numpy, reference bucket_cipher, reference pallas_gather)."""
    import jax.numpy as jnp

    from grapevine_tpu.oblivious import bucket_cipher, pallas_gather

    return jnp, bucket_cipher, pallas_gather


@pytest.mark.parametrize("rounds", [8, 20])
@pytest.mark.parametrize("n_words", [28, 1028])
def test_row_keystream_matches_jax(rounds, n_words):
    jnp, jbc, _ = _jax()
    rng = np.random.default_rng(rounds + n_words)
    r = 13
    key = _u32(rng, (8,))
    bucket = _u32(rng, (r,))
    epoch = _u32(rng, (r, 2), high=3)  # includes (0, 0): identity rows
    epoch[0] = 0
    epoch[1] = (0xFFFFFFFF, 0xFFFFFFFF)
    want = np.asarray(jbc.row_keystream(
        jnp.asarray(key), jnp.asarray(bucket), jnp.asarray(epoch), n_words, rounds
    ))
    got = to_numpy(tbc.row_keystream(_t(key), _t(bucket), _t(epoch), n_words, rounds))
    np.testing.assert_array_equal(got, want)
    assert not got[0].any()  # epoch 0 ⇒ identity keystream


def test_epoch_next_matches_jax():
    jnp, jbc, _ = _jax()
    for e in ([1, 0], [0xFFFFFFFF, 0], [0xFFFFFFFF, 7], [5, 0xFFFFFFFF]):
        e = np.array(e, np.uint32)
        want = np.asarray(jbc.epoch_next(jnp.asarray(e)))
        np.testing.assert_array_equal(to_numpy(tbc.epoch_next(_t(e))), want)


def _gather_inputs(seed, z, zv, n, r=11):
    rng = np.random.default_rng(seed)
    return dict(
        key=_u32(rng, (8,)),
        tree_idx=_u32(rng, (n * z,)),
        tree_val=_u32(rng, (n, zv)),
        nonces=_u32(rng, (n, 2), high=3),  # some rows never written
        flat_b=rng.integers(0, n - 1, (r,)).astype(np.uint32),  # dups too
    )


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("z,zv,n", GEOMETRIES)
def test_plain_gather_matches_jax_interpret(seed, z, zv, n):
    jnp, _, jpg = _jax()
    x = _gather_inputs(seed, z, zv, n)
    wi, wv = jpg.gather_decrypt_rows_tiled(
        *(jnp.asarray(x[k]) for k in ("key", "tree_idx", "tree_val", "nonces",
                                       "flat_b")),
        z=z, rounds=8, interpret=True,
    )
    before = dict(gk.LAUNCHES)
    gi, gv = gk.gather_decrypt_rows_tiled(
        *(_t(x[k]) for k in ("key", "tree_idx", "tree_val", "nonces", "flat_b")),
        z=z, rounds=8,
    )
    assert gk.LAUNCHES == before  # CPU tensors take the plain version
    np.testing.assert_array_equal(to_numpy(gi), np.asarray(wi))
    np.testing.assert_array_equal(to_numpy(gv), np.asarray(wv))


def test_plain_gather_rounds0_is_plain_gather():
    z, zv, n = 4, 24, 64
    x = _gather_inputs(3, z, zv, n)
    gi, gv = gk.gather_decrypt_rows_tiled(
        *(_t(x[k]) for k in ("key", "tree_idx", "tree_val", "nonces", "flat_b")),
        z=z, rounds=0,
    )
    np.testing.assert_array_equal(to_numpy(gi), x["tree_idx"].reshape(n, z)[x["flat_b"]])
    np.testing.assert_array_equal(to_numpy(gv), x["tree_val"][x["flat_b"]])


def _scatter_inputs(seed, z, zv, n, r=13):
    rng = np.random.default_rng(100 + seed)
    x = _gather_inputs(seed, z, zv, n, r)
    # distinct owned targets plus duplicate non-owner copies
    owned = rng.choice(n - 1, size=r - 4, replace=False).astype(np.uint32)
    x["flat_b"] = np.concatenate([owned, owned[:4]])
    x["owner"] = np.arange(r) < r - 4
    x["epoch"] = np.array([7, 1], np.uint32)
    x["new_pidx"] = _u32(rng, (r, z))
    x["new_pval"] = _u32(rng, (r, zv))
    return x


_SC = ("key", "tree_idx", "tree_val", "nonces", "flat_b", "owner", "epoch",
       "new_pidx", "new_pval")

#: owner shares of the scatter cases: none, about one row in 16, all
OWNER_SHARES = [0.0, 1 / 16, 1.0]


def _owner_share_inputs(seed, z, zv, n, share, r):
    """Scatter inputs with ``round(share * r)`` owner rows (at least one
    when ``share`` > 0) at distinct real buckets. Non-owner rows aim at
    owned buckets, the junk bucket ``n - 1`` or the flush's pad id ``n``
    (past the trees), so a non-owner write to a real row would show."""
    rng = np.random.default_rng(300 + seed)
    x = _gather_inputs(seed, z, zv, n, r)
    n_own = 0 if share == 0 else max(1, round(share * r))
    owner = np.zeros(r, bool)
    owner[rng.choice(r, size=n_own, replace=False)] = True
    flat_b = rng.choice(np.array([n - 1, n], np.uint32), size=r)
    flat_b[owner] = rng.choice(n - 1, size=n_own, replace=False)
    if n_own:
        dup = ~owner & (rng.random(r) < 0.5)
        flat_b[dup] = rng.choice(flat_b[owner], size=int(dup.sum()))
    x.update(flat_b=flat_b.astype(np.uint32), owner=owner,
             epoch=np.array([9, 2], np.uint32), new_pidx=_u32(rng, (r, z)),
             new_pval=_u32(rng, (r, zv)))
    return x


@pytest.mark.parametrize("seed,share", [
    pytest.param(0, None, id="0"), pytest.param(1, None, id="1"),
    *(pytest.param(2, s, id=f"share{s:g}") for s in OWNER_SHARES),
])
@pytest.mark.parametrize("z,zv,n", GEOMETRIES)
def test_plain_scatter_matches_jax_interpret(seed, share, z, zv, n):
    jnp, _, jpg = _jax()
    x = (_scatter_inputs(seed, z, zv, n) if share is None
         else _owner_share_inputs(seed, z, zv, n, share, r=13))
    wi, wv, wn = jpg.scatter_encrypt_rows_tiled(
        *(jnp.asarray(x[k]) for k in _SC), z=z, rounds=8, interpret=True
    )
    ti, tv, tn = (_t(x[k]) for k in ("tree_idx", "tree_val", "nonces"))
    args = [_t(x[k]) for k in _SC]
    args[1:4] = ti, tv, tn
    out = gk.scatter_encrypt_rows_tiled(*args, z=z, rounds=8)
    assert out[0] is ti and out[1] is tv and out[2] is tn  # in place
    # the junk bucket (last row) takes racing non-owner writes: masked
    np.testing.assert_array_equal(to_numpy(ti)[:-z], np.asarray(wi)[:-z])
    np.testing.assert_array_equal(to_numpy(tv)[:-1], np.asarray(wv)[:-1])
    np.testing.assert_array_equal(to_numpy(tn)[:-1], np.asarray(wn)[:-1])
    # no non-owner plaintext reaches a real row, in the reference or the
    # port: every real row no owner targets kept its bytes and its nonce
    untouched = np.setdiff1d(np.arange(n - 1), x["flat_b"][x["owner"]])
    for got_idx, got_val, got_non in ((to_numpy(ti), to_numpy(tv), to_numpy(tn)),
                                      (np.asarray(wi), np.asarray(wv), np.asarray(wn))):
        np.testing.assert_array_equal(got_val[untouched], x["tree_val"][untouched])
        np.testing.assert_array_equal(got_idx.reshape(n, z)[untouched],
                                      x["tree_idx"].reshape(n, z)[untouched])
        np.testing.assert_array_equal(got_non[untouched], x["nonces"][untouched])


def test_wrappers_refuse_bad_inputs():
    x = _gather_inputs(0, 4, 24, 64)
    t = {k: _t(v) for k, v in x.items()}
    with pytest.raises(TypeError):
        gk.gather_decrypt_rows_tiled(t["key"], t["tree_idx"], t["tree_val"],
                                     t["nonces"], t["flat_b"].long(), z=4)
    with pytest.raises(ValueError):
        gk.gather_decrypt_rows_tiled(t["key"], t["tree_idx"], t["tree_val"],
                                     t["nonces"], t["flat_b"], z=4, rounds=7)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels have no CPU mode "
                    "(run on the card via chip_smoke.py or this test)")
    return torch.device("cuda")


@pytest.mark.parametrize("z,zv,n", GEOMETRIES + [(4, 6080, 32)])
def test_cuda_kernels_match_plain_versions(cuda_device, z, zv, n):
    x = _gather_inputs(5, z, zv, n, r=300)
    c = {k: from_numpy(v, cuda_device) for k, v in x.items()}
    g_args = [c[k] for k in ("key", "tree_idx", "tree_val", "nonces", "flat_b")]
    for rounds in (0, 8, 20):
        before = gk.LAUNCHES["gather_decrypt_rows_tiled"]
        ki, kv = gk.gather_decrypt_rows_tiled(*g_args, z=z, rounds=rounds)
        torch.cuda.synchronize()
        assert gk.LAUNCHES["gather_decrypt_rows_tiled"] == before + 1
        pi, pv = gk.gather_decrypt_rows_plain(*g_args, z=z, rounds=rounds)
        assert torch.equal(ki, pi) and torch.equal(kv, pv), rounds

    s = _scatter_inputs(6, z, zv, n, r=n // 2)
    ck = {k: from_numpy(v, cuda_device) for k, v in s.items()}
    cp = {k: v.clone() for k, v in ck.items()}
    gk.scatter_encrypt_rows_tiled(*(ck[k] for k in _SC), z=z, rounds=8)
    gk.scatter_encrypt_rows_plain(*(cp[k] for k in _SC), z=z, rounds=8)
    torch.cuda.synchronize()
    assert torch.equal(ck["tree_idx"][:-z], cp["tree_idx"][:-z])
    assert torch.equal(ck["tree_val"][:-1], cp["tree_val"][:-1])
    assert torch.equal(ck["nonces"][:-1], cp["nonces"][:-1])


def check_cuda_scatter(fn, x, z, rounds=8):
    """``fn`` (a scatter wrapper) on the card against its plain version:
    every real row equal (the junk bucket masked), one launch counted,
    the junk bucket and its nonce bit-identical before and after the
    kernel, and with no owner no byte of any tree changed."""
    dev = torch.device("cuda")
    k = {name: from_numpy(v, dev) for name, v in x.items()}
    p = {name: t.clone() for name, t in k.items()}
    before = [k[name].clone() for name in ("tree_idx", "tree_val", "nonces")]
    launches = gk.LAUNCHES[fn.__name__]
    fn(*(k[name] for name in _SC), z=z, rounds=rounds)
    torch.cuda.synchronize()
    assert gk.LAUNCHES[fn.__name__] == launches + 1
    gk.scatter_encrypt_rows_plain(*(p[name] for name in _SC), z=z, rounds=rounds)
    assert torch.equal(k["tree_idx"][:-z], p["tree_idx"][:-z])
    assert torch.equal(k["tree_val"][:-1], p["tree_val"][:-1])
    assert torch.equal(k["nonces"][:-1], p["nonces"][:-1])
    assert torch.equal(k["tree_idx"][-z:], before[0][-z:])
    assert torch.equal(k["tree_val"][-1], before[1][-1])
    assert torch.equal(k["nonces"][-1], before[2][-1])
    if not x["owner"].any():
        for got, was in zip((k["tree_idx"], k["tree_val"], k["nonces"]), before):
            assert torch.equal(got, was)


#: (z, z*v, tree buckets) of the card's scatter cases: two word-path rows
#: (planes that are not 16-byte multiples), a records-width and a
#: mailbox-width bulk-copy row; R = n - 3 rows, never a multiple of 8
SCATTER_GEOMETRIES = [(3, 30, 64), (4, 22, 64), (4, 1024, 16), (4, 6080, 32)]

#: (z, z*v, tree buckets, R): enough owned rows that every persistent CTA
#: takes several steps round its buffer ring, on both layout paths
RING_GEOMETRIES = [(4, 28, 2**17, 100_003), (3, 30, 2**17, 100_003),
                   (4, 6080, 4096, 3001)]


@pytest.mark.parametrize("share", OWNER_SHARES)
@pytest.mark.parametrize("z,zv,n", SCATTER_GEOMETRIES)
def test_cuda_scatter_tiled_owner_shares(cuda_device, z, zv, n, share):
    check_cuda_scatter(gk.scatter_encrypt_rows_tiled,
                       _owner_share_inputs(7, z, zv, n, share, r=n - 3), z)


@pytest.mark.parametrize("z,zv,n,r", RING_GEOMETRIES)
def test_cuda_scatter_tiled_ring(cuda_device, z, zv, n, r):
    check_cuda_scatter(gk.scatter_encrypt_rows_tiled,
                       _owner_share_inputs(8, z, zv, n, 0.6, r=r), z)


@pytest.mark.parametrize("fn", [gk.scatter_encrypt_rows, gk.scatter_encrypt_rows_tiled])
def test_cuda_scatter_refuses_row_wider_than_its_ring(cuda_device, fn):
    """A row whose ring of buffers does not fit an SM's shared memory
    (3 x 80 KB) is refused with an error and writes nothing; a fitting
    width launches after it, and before it, as before."""
    check_cuda_scatter(fn, _owner_share_inputs(9, 4, 6080, 32, 0.5, r=29), 4)
    x = _owner_share_inputs(9, 4, 20_000, 8, 0.5, r=5)
    k = {name: from_numpy(v, cuda_device) for name, v in x.items()}
    before = [k[name].clone() for name in ("tree_idx", "tree_val", "nonces")]
    with pytest.raises(RuntimeError, match="launch failed"):
        fn(*(k[name] for name in _SC), z=4, rounds=8)
    torch.cuda.synchronize()
    for got, was in zip((k["tree_idx"], k["tree_val"], k["nonces"]), before):
        assert torch.equal(got, was)
    check_cuda_scatter(fn, _owner_share_inputs(10, 4, 1024, 16, 0.5, r=13), 4)
