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


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("z,zv,n", GEOMETRIES)
def test_plain_scatter_matches_jax_interpret(seed, z, zv, n):
    jnp, _, jpg = _jax()
    x = _scatter_inputs(seed, z, zv, n)
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
    # rows no owner targets kept their bytes
    untouched = np.setdiff1d(np.arange(n - 1), x["flat_b"][x["owner"]])
    np.testing.assert_array_equal(to_numpy(tv)[untouched], x["tree_val"][untouched])


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
