"""At-rest bucket cipher, plain PyTorch path (port of
``grapevine_tpu/oblivious/bucket_cipher.py``).

Every bucket row in device memory is XORed with a ChaCha keystream keyed
by a device-resident secret, the bucket's heap index and a per-write
64-bit epoch nonce: state ``[σ | key(8) | ctr=block | bucket | epoch_lo |
epoch_hi]`` with the RFC 7539 feed-forward. Rows are enciphered in the
reference's j-major word order (word ``m`` of a row is state word
``m // nb`` of block ``m % nb``), and epoch 0 marks a never-written
bucket whose keystream is the identity.

This is the reference the CUDA kernels (``oblivious/gather_kernels.py``,
``csrc/chacha.cuh``) are held against; the engine's ``"jnp"`` cipher
path runs it on either device.
"""

from __future__ import annotations

import torch

from ..u32 import c32, rotl

#: "expand 32-byte k"
_SIGMA = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)


def _qr(s, a, b, c, d):
    s[a] = s[a] + s[b]
    s[d] = rotl(s[d] ^ s[a], 16)
    s[c] = s[c] + s[d]
    s[b] = rotl(s[b] ^ s[c], 12)
    s[a] = s[a] + s[b]
    s[d] = rotl(s[d] ^ s[a], 8)
    s[c] = s[c] + s[d]
    s[b] = rotl(s[b] ^ s[c], 7)


def chacha_blocks(key, counter, n1, n2, n3=None, rounds: int = 8):
    """ChaCha block function over broadcast lanes → int32[..., 16].

    ``key`` int32[8]; ``counter``/``n1``/``n2``/``n3`` int32 tensors that
    broadcast to ``counter.shape`` (u32 bits)."""
    shape = counter.shape
    zero = torch.zeros_like(counter)
    init = [torch.full(shape, c32(c), dtype=torch.int32, device=counter.device)
            for c in _SIGMA]
    init += [key[i].expand(shape) for i in range(8)]
    init += [counter, n1.expand(shape), n2.expand(shape),
             zero if n3 is None else n3.expand(shape)]
    s = list(init)
    for _ in range(rounds // 2):
        _qr(s, 0, 4, 8, 12)
        _qr(s, 1, 5, 9, 13)
        _qr(s, 2, 6, 10, 14)
        _qr(s, 3, 7, 11, 15)
        _qr(s, 0, 5, 10, 15)
        _qr(s, 1, 6, 11, 12)
        _qr(s, 2, 7, 8, 13)
        _qr(s, 3, 4, 9, 14)
    return torch.stack([a + b for a, b in zip(s, init)], dim=-1)


def row_keystream(key, bucket, epoch, n_words: int, rounds: int = 8):
    """Keystream rows int32[R, n_words]; zero rows where epoch == 0.

    ``bucket`` int32[R] heap ids, ``epoch`` int32[R, 2] (lo, hi)."""
    r = bucket.shape[0]
    n_blocks = (n_words + 15) // 16
    ctr = torch.arange(n_blocks, dtype=torch.int32, device=bucket.device)
    ks = chacha_blocks(
        key, ctr[None, :].expand(r, n_blocks), bucket[:, None],
        epoch[:, None, 0], epoch[:, None, 1], rounds,
    )  # [r, n_blocks, 16]
    # j-major stream order: every block's word 0, then word 1, ...
    ks = ks.transpose(1, 2).reshape(r, n_blocks * 16)[:, :n_words]
    written = (epoch[:, 0] != 0) | (epoch[:, 1] != 0)
    return torch.where(written[:, None], ks, 0)


def epoch_next(epoch):
    """Advance an int32[2] (lo, hi) u32 epoch counter with carry."""
    lo = epoch[0] + 1
    hi = epoch[1] + (lo == 0).to(torch.int32)
    return torch.stack([lo, hi])
