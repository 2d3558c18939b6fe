"""Fused keystream + XOR over bucket rows (counterpart of
``grapevine_tpu/oblivious/pallas_cipher.py``).

:func:`cipher_rows_pallas` XORs R contiguous bucket rows with their
keystream (encrypt ≡ decrypt) into fresh outputs, as the reference does;
its inputs are never written. Rows whose epoch is (0, 0) pass through
unchanged. The kernel is hand-written for Hopper
(``csrc/cipher_kernels.cu``: the row ring of ``csrc/row_ring.cuh``, up
to 8 rows a step, persistent CTAs streaming rows through shared memory
with TMA bulk copies; ChaCha core in ``csrc/chacha.cuh``) and lives in
the one library ``gather_kernels.build_library`` builds;
:func:`cipher_rows_pallas_plain` is its plain PyTorch version. The
wrapper takes the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises. Each launch adds one to
:data:`LAUNCHES`.

This is ``bucket_cipher_impl="pallas"``'s cipher, and the cipher of
every ``pallas*`` impl wherever the round ciphers rows outside the
fused gather/scatter (``oram/path_oram.py:cipher_rows``).
"""

from __future__ import annotations

import torch

from .bucket_cipher import row_keystream
from .gather_kernels import check_tensor, device_kind, load_library

#: kernel launches since the last :func:`reset_launches`
LAUNCHES = {"cipher_rows_pallas": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def cipher_rows_pallas_plain(key, bucket, epoch, pidx, pval, rounds: int = 8):
    """``row_keystream``, then XOR → (pidx', pval')."""
    z = pidx.shape[1]
    ks = row_keystream(key, bucket, epoch, z + pval.shape[1], rounds)
    return pidx ^ ks[:, :z], pval ^ ks[:, z:]


def cipher_rows_pallas(key, bucket, epoch, pidx, pval, rounds: int = 8, out=None):
    """(pidx' int32[R, z], pval' int32[R, W-z]) = rows ^ keystream.

    ``key`` int32[8]; ``bucket`` int32[R] heap ids; ``epoch`` int32[R, 2]
    (lo, hi) per-row nonces, (0, 0) = identity; ``pidx`` int32[R, z] and
    ``pval`` int32[R, W-z] the row's slot-index and value words.
    ``out=(out_idx, out_val)``, contiguous tensors of those shapes that
    overlap neither input, receives the rows instead of fresh outputs
    (the expiry sweep decrypts into one scratch chunk and re-encrypts
    straight back into the tree rows)."""
    r, z = pidx.shape
    zv = pval.shape[1]
    for name, t, shape in (("key", key, (8,)), ("bucket", bucket, (r,)),
                           ("epoch", epoch, (r, 2)), ("pidx", pidx, None),
                           ("pval", pval, (r, zv))):
        check_tensor(name, t, torch.int32, shape)
    if out is not None:
        check_tensor("out_idx", out[0], torch.int32, (r, z))
        check_tensor("out_val", out[1], torch.int32, (r, zv))
    if rounds < 0 or rounds % 2:
        raise ValueError(f"rounds must be a non-negative even count, got {rounds}")
    if device_kind(key, bucket, epoch, pidx, pval, *(out or ())) == "cpu":
        ci, cv = cipher_rows_pallas_plain(key, bucket, epoch, pidx, pval, rounds)
        if out is None:
            return ci, cv
        out[0].copy_(ci)
        out[1].copy_(cv)
        return out
    out_idx, out_val = out if out is not None else (torch.empty_like(pidx),
                                                    torch.empty_like(pval))
    err = load_library().gv_cipher_rows(
        key.data_ptr(), bucket.data_ptr(), epoch.data_ptr(), pidx.data_ptr(),
        pval.data_ptr(), out_idx.data_ptr(), out_val.data_ptr(), r, z, zv,
        rounds, torch.cuda.current_stream(pval.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"cipher_rows_pallas launch failed: cudaError {err}")
    LAUNCHES["cipher_rows_pallas"] += 1
    return out_idx, out_val
