"""The port's one-row fused kernels and standalone row cipher held against
the JAX package: the plain versions of ``cipher_rows_pallas`` (B2),
``gather_decrypt_rows`` (B3) and ``scatter_encrypt_rows`` (B5) against
the Pallas kernels of ``grapevine_tpu/oblivious/pallas_cipher.py`` and
``pallas_gather.py`` in interpret mode, at 2 geometries × 2 seeds ×
ChaCha rounds 8 and 20, with never-written (epoch (0, 0)) rows among the
inputs. Integer functions: tolerance 0 (the scatter's junk bucket
masked). The CUDA cases hold each kernel against its plain version on
the card: B2 and B3, launches of the row ring (``csrc/row_ring.cuh``),
on the word-path and bulk-copy geometries at never-written shares 0,
1/8 and 1, ring cases with R no multiple of the rows a step, heavy
duplicates in ``flat_b``, a misaligned plane and a row too wide for the
ring.

The JAX side is imported inside the tests that use it, so the CUDA test
also runs where JAX is absent (``python -m pytest --noconftest
tests/test_torch_cipher_kernels.py -k cuda``)."""

import numpy as np
import pytest
import torch

from grapevine_tpu_torch.oblivious import cipher_kernels as ck
from grapevine_tpu_torch.oblivious import gather_kernels as gk
from grapevine_tpu_torch.oram import path_oram
from grapevine_tpu_torch.u32 import from_numpy, to_numpy
from test_torch_cipher import (
    _SC,
    OWNER_SHARES,
    RING_GEOMETRIES,
    SCATTER_GEOMETRIES,
    _gather_inputs,
    _jax,
    _owner_share_inputs,
    _scatter_inputs,
    _t,
    _u32,
    check_cuda_scatter,
    cuda_device,  # noqa: F401  (fixture)
)

_G = ("key", "tree_idx", "tree_val", "nonces", "flat_b")

#: (z, z*v, tree buckets): a 100-word row (7 ChaCha blocks) and a
#: records-width row (1028 words, 65 blocks). Narrower rows are left out
#: on purpose: the reference's interpret-mode compile of a 2-block row
#: at 20 rounds runs for many minutes on the CPU.
GEOMETRIES = [(4, 96, 64), (4, 1024, 16)]


def _cipher_inputs(seed, z, zv, r=21):
    rng = np.random.default_rng(200 + seed)
    epoch = _u32(rng, (r, 2))
    epoch[rng.random(r) < 0.3] = 0  # never-written rows pass through
    epoch[1] = (0xFFFFFFFF, 0xFFFFFFFF)
    return dict(key=_u32(rng, (8,)), bucket=_u32(rng, (r,), high=1 << 20),
                epoch=epoch, pidx=_u32(rng, (r, z)), pval=_u32(rng, (r, zv)))


_CI = ("key", "bucket", "epoch", "pidx", "pval")


@pytest.mark.parametrize("rounds", [8, 20])
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("z,zv,n", GEOMETRIES)
def test_cipher_rows_plain_matches_jax_interpret(z, zv, n, seed, rounds):
    from grapevine_tpu.oblivious.pallas_cipher import cipher_rows_pallas as jcr

    jnp, _, _ = _jax()
    x = _cipher_inputs(seed, z, zv)
    wi, wv = jcr(*(jnp.asarray(x[k]) for k in _CI), rounds=rounds, interpret=True)
    args = [_t(x[k]) for k in _CI]
    before = dict(ck.LAUNCHES)
    gi, gv = ck.cipher_rows_pallas(*args, rounds=rounds)
    assert ck.LAUNCHES == before  # CPU tensors take the plain version
    np.testing.assert_array_equal(to_numpy(gi), np.asarray(wi))
    np.testing.assert_array_equal(to_numpy(gv), np.asarray(wv))
    zero = ~x["epoch"].any(axis=1)
    assert zero.any()
    np.testing.assert_array_equal(to_numpy(gv)[zero], x["pval"][zero])
    for k, a in zip(_CI, args):  # fresh outputs: the inputs are not written
        np.testing.assert_array_equal(to_numpy(a), x[k], k)


@pytest.mark.parametrize("rounds", [8, 20])
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("z,zv,n", GEOMETRIES)
def test_gather_rows_plain_matches_jax_interpret(z, zv, n, seed, rounds):
    jnp, _, jpg = _jax()
    x = _gather_inputs(10 + seed, z, zv, n)
    x["nonces"][x["flat_b"][0]] = 0  # at least one never-written row
    wi, wv = jpg.gather_decrypt_rows(*(jnp.asarray(x[k]) for k in _G), z=z,
                                     rounds=rounds, interpret=True)
    before = dict(gk.LAUNCHES)
    gi, gv = gk.gather_decrypt_rows(*(_t(x[k]) for k in _G), z=z, rounds=rounds)
    assert gk.LAUNCHES == before
    np.testing.assert_array_equal(to_numpy(gi), np.asarray(wi))
    np.testing.assert_array_equal(to_numpy(gv), np.asarray(wv))


@pytest.mark.parametrize("rounds", [8, 20])
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("z,zv,n", GEOMETRIES)
def test_scatter_rows_plain_matches_jax_interpret(z, zv, n, seed, rounds):
    jnp, _, jpg = _jax()
    x = _scatter_inputs(10 + seed, z, zv, n)
    wi, wv, wn = jpg.scatter_encrypt_rows(*(jnp.asarray(x[k]) for k in _SC),
                                          z=z, rounds=rounds, interpret=True)
    args = [_t(x[k]) for k in _SC]
    before = dict(gk.LAUNCHES)
    out = gk.scatter_encrypt_rows(*args, z=z, rounds=rounds)
    assert gk.LAUNCHES == before
    assert all(o is a for o, a in zip(out, args[1:4]))  # in place
    ti, tv, tn = (to_numpy(a) for a in args[1:4])
    # the junk bucket (last row) takes racing non-owner writes: masked
    np.testing.assert_array_equal(ti[:-z], np.asarray(wi)[:-z])
    np.testing.assert_array_equal(tv[:-1], np.asarray(wv)[:-1])
    np.testing.assert_array_equal(tn[:-1], np.asarray(wn)[:-1])


def test_cipher_rows_refuses_bad_inputs():
    x = {k: _t(v) for k, v in _cipher_inputs(0, 4, 24).items()}
    with pytest.raises(TypeError):
        ck.cipher_rows_pallas(x["key"], x["bucket"].long(), x["epoch"],
                              x["pidx"], x["pval"])
    with pytest.raises(ValueError, match="rounds"):
        ck.cipher_rows_pallas(*(x[k] for k in _CI), rounds=9)
    with pytest.raises(ValueError, match="shape"):
        ck.cipher_rows_pallas(x["key"], x["bucket"][1:], x["epoch"], x["pidx"],
                              x["pval"])
    with pytest.raises(ValueError, match="contiguous"):
        ck.cipher_rows_pallas(x["key"], x["bucket"], x["epoch"], x["pidx"],
                              x["pval"].t().contiguous().t())


@pytest.mark.parametrize("z,zv,n", GEOMETRIES + [(4, 6080, 32)])
def test_cuda_one_row_kernels_match_plain_versions(cuda_device, z, zv, n):
    x = _cipher_inputs(5, z, zv, r=301)
    c = {k: from_numpy(v, cuda_device) for k, v in x.items()}
    for rounds in (8, 20):
        before = ck.LAUNCHES["cipher_rows_pallas"]
        ki, kv = ck.cipher_rows_pallas(*(c[k] for k in _CI), rounds=rounds)
        torch.cuda.synchronize()
        assert ck.LAUNCHES["cipher_rows_pallas"] == before + 1
        pi, pv = ck.cipher_rows_pallas_plain(*(c[k] for k in _CI), rounds=rounds)
        assert torch.equal(ki, pi) and torch.equal(kv, pv), rounds

    x = _gather_inputs(5, z, zv, n, r=300)
    c = {k: from_numpy(v, cuda_device) for k, v in x.items()}
    for rounds in (0, 8, 20):
        before = gk.LAUNCHES["gather_decrypt_rows"]
        ki, kv = gk.gather_decrypt_rows(*(c[k] for k in _G), z=z, rounds=rounds)
        torch.cuda.synchronize()
        assert gk.LAUNCHES["gather_decrypt_rows"] == before + 1
        pi, pv = gk.gather_decrypt_rows_plain(*(c[k] for k in _G), z=z,
                                              rounds=rounds)
        assert torch.equal(ki, pi) and torch.equal(kv, pv), rounds

    s = _scatter_inputs(6, z, zv, n, r=n // 2)
    sk = {k: from_numpy(v, cuda_device) for k, v in s.items()}
    sp = {k: v.clone() for k, v in sk.items()}
    gk.scatter_encrypt_rows(*(sk[k] for k in _SC), z=z, rounds=8)
    gk.scatter_encrypt_rows_plain(*(sp[k] for k in _SC), z=z, rounds=8)
    torch.cuda.synchronize()
    assert torch.equal(sk["tree_idx"][:-z], sp["tree_idx"][:-z])
    assert torch.equal(sk["tree_val"][:-1], sp["tree_val"][:-1])
    assert torch.equal(sk["nonces"][:-1], sp["nonces"][:-1])


@pytest.mark.parametrize("share", OWNER_SHARES)
@pytest.mark.parametrize("z,zv,n", SCATTER_GEOMETRIES)
def test_cuda_scatter_rows_owner_shares(cuda_device, z, zv, n, share):
    check_cuda_scatter(gk.scatter_encrypt_rows,
                       _owner_share_inputs(7, z, zv, n, share, r=n - 3), z)


@pytest.mark.parametrize("z,zv,n,r", RING_GEOMETRIES)
def test_cuda_scatter_rows_ring(cuda_device, z, zv, n, r):
    check_cuda_scatter(gk.scatter_encrypt_rows,
                       _owner_share_inputs(8, z, zv, n, 0.6, r=r), z)


#: shares of never-written rows (epoch (0, 0), the identity keystream) in
#: the card's B2/B3 cases: none, one in eight, all
EPOCH_SHARES = [0.0, 1 / 8, 1.0]


def _epochs(rng, rows, share):
    """u32[rows, 2] epochs, ``round(share * rows)`` of them (0, 0) and
    every other one nonzero."""
    e = _u32(rng, (rows, 2))
    e[:, 0] |= 1
    e[rng.choice(rows, size=round(share * rows), replace=False)] = 0
    return e


def _share_gather_inputs(seed, z, zv, n, share, r):
    """Gather inputs whose tree rows are never written at ``share``."""
    rng = np.random.default_rng(400 + seed)
    x = _gather_inputs(seed, z, zv, n, r)
    x["nonces"] = _epochs(rng, n, share)
    x["flat_b"] = rng.integers(0, n, (r,)).astype(np.uint32)
    return x


def _share_cipher_inputs(seed, z, zv, share, r):
    rng = np.random.default_rng(500 + seed)
    return dict(key=_u32(rng, (8,)), bucket=_u32(rng, (r,), high=1 << 20),
                epoch=_epochs(rng, r, share), pidx=_u32(rng, (r, z)),
                pval=_u32(rng, (r, zv)))


def check_cuda_gather(x, z, rounds=8):
    """B3 on the card against its plain version, one launch counted, its
    inputs untouched."""
    c = _cuda(x)
    before = {k: v.clone() for k, v in c.items()}
    launches = gk.LAUNCHES["gather_decrypt_rows"]
    ki, kv = gk.gather_decrypt_rows(*(c[k] for k in _G), z=z, rounds=rounds)
    torch.cuda.synchronize()
    assert gk.LAUNCHES["gather_decrypt_rows"] == launches + 1
    pi, pv = gk.gather_decrypt_rows_plain(*(c[k] for k in _G), z=z, rounds=rounds)
    assert torch.equal(ki, pi) and torch.equal(kv, pv)
    for k, v in c.items():
        assert torch.equal(v, before[k]), k


def check_cuda_cipher(c, rounds=8):
    """B2 on the card (``c``: its inputs as CUDA tensors) against its
    plain version, one launch counted, its inputs untouched."""
    before = {k: v.clone() for k, v in c.items()}
    launches = ck.LAUNCHES["cipher_rows_pallas"]
    ki, kv = ck.cipher_rows_pallas(*(c[k] for k in _CI), rounds=rounds)
    torch.cuda.synchronize()
    assert ck.LAUNCHES["cipher_rows_pallas"] == launches + 1
    pi, pv = ck.cipher_rows_pallas_plain(*(c[k] for k in _CI), rounds=rounds)
    assert torch.equal(ki, pi) and torch.equal(kv, pv)
    for k, v in c.items():
        assert torch.equal(v, before[k]), k


def _cuda(x):
    return {k: from_numpy(v, torch.device("cuda")) for k, v in x.items()}


@pytest.mark.parametrize("share", EPOCH_SHARES)
@pytest.mark.parametrize("z,zv,n", SCATTER_GEOMETRIES)
def test_cuda_gather_rows_epoch_shares(cuda_device, z, zv, n, share):
    check_cuda_gather(_share_gather_inputs(11, z, zv, n, share, r=3 * n + 5), z)


@pytest.mark.parametrize("share", EPOCH_SHARES)
@pytest.mark.parametrize("z,zv,n", SCATTER_GEOMETRIES)
def test_cuda_cipher_rows_epoch_shares(cuda_device, z, zv, n, share):
    check_cuda_cipher(_cuda(_share_cipher_inputs(12, z, zv, share, r=3 * n + 5)))


@pytest.mark.parametrize("z,zv,n,r", RING_GEOMETRIES)
def test_cuda_gather_rows_ring(cuda_device, z, zv, n, r):
    check_cuda_gather(_share_gather_inputs(13, z, zv, n, 1 / 8, r=r), z)


@pytest.mark.parametrize("z,zv,n,r", RING_GEOMETRIES)
def test_cuda_cipher_rows_ring(cuda_device, z, zv, n, r):
    check_cuda_cipher(_cuda(_share_cipher_inputs(14, z, zv, 1 / 8, r=r)))


@pytest.mark.parametrize("rounds", [0, 8])
@pytest.mark.parametrize("dups", ["one_bucket", "paths"])
@pytest.mark.parametrize("z,zv,n", [(3, 30, 64), (4, 1024, 2048), (4, 6080, 32)])
def test_cuda_gather_rows_duplicates(cuda_device, z, zv, n, dups, rounds):
    """Heavy duplicates in ``flat_b``: every row the same bucket, or the
    root-to-leaf paths of random leaves (the root in every path), as a
    round fetches them; ``rounds=0`` is a plain gather."""
    x = _share_gather_inputs(15, z, zv, n, 1 / 8, r=701)
    if dups == "one_bucket":
        x["flat_b"][:] = n // 3
    else:
        cfg = path_oram.OramConfig(height=n.bit_length() - 2, value_words=1)
        rng = np.random.default_rng(16)
        leaves = torch.from_numpy(rng.integers(0, 2**cfg.height, 64).astype(np.int32))
        x["flat_b"] = path_oram.path_bucket_indices(cfg, leaves).reshape(-1).numpy(
        ).astype(np.uint32)
        assert x["flat_b"].max() < n
    check_cuda_gather(x, z, rounds=rounds)


@pytest.mark.parametrize("z,zv", [(4, 1024), (4, 6080)])
def test_cuda_cipher_rows_misaligned_plane(cuda_device, z, zv):
    """A ``pval`` that is a contiguous view 4 bytes past a 16-byte
    boundary takes the ring's word path, with the same result."""
    c = _cuda(_share_cipher_inputs(17, z, zv, 1 / 8, r=301))
    base = torch.empty(301 * zv + 1, dtype=torch.int32, device=cuda_device)
    c["pval"] = base[1:].view(301, zv).copy_(c["pval"])
    assert c["pval"].is_contiguous() and c["pval"].data_ptr() % 16 == 4
    check_cuda_cipher(c)


def test_cuda_gather_and_cipher_refuse_row_wider_than_the_ring(cuda_device):
    """A row whose ring of buffers does not fit an SM's shared memory
    (3 x 80 KB) is refused with an error, its inputs untouched; a fitting
    width launches before and after it."""
    z, zv = 4, 20_000
    g = _cuda(_share_gather_inputs(18, z, zv, 8, 1 / 8, r=5))
    c = _cuda(_share_cipher_inputs(18, z, zv, 1 / 8, r=5))
    check_cuda_gather(_share_gather_inputs(19, 4, 6080, 32, 1 / 8, r=29), 4)
    check_cuda_cipher(_cuda(_share_cipher_inputs(19, 4, 6080, 1 / 8, r=29)))
    for fn, inputs, keys, args in ((gk.gather_decrypt_rows, g, _G, dict(z=z)),
                                   (ck.cipher_rows_pallas, c, _CI, {})):
        before = {k: v.clone() for k, v in inputs.items()}
        with pytest.raises(RuntimeError, match="launch failed"):
            fn(*(inputs[k] for k in keys), rounds=8, **args)
        torch.cuda.synchronize()
        for k, v in inputs.items():
            assert torch.equal(v, before[k]), k
    check_cuda_gather(_share_gather_inputs(20, 4, 1024, 16, 1 / 8, r=13), 4)
    check_cuda_cipher(_cuda(_share_cipher_inputs(20, 4, 1024, 1 / 8, r=13)))


def test_ring_launch_config_refuses_other_kernels():
    """Only row-ring launches have a ring plan; the name is checked before
    the library is built."""
    with pytest.raises(ValueError, match="row-ring"):
        gk.ring_launch_config("gather_decrypt_rows_tiled", 8, 4, 1024)
