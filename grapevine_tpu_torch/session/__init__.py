"""Session layer: encrypted channel, challenge RNG, request signatures (a
copy of ``grapevine_tpu/session``; same wire bytes, same signatures).

Host-side re-design of the reference's attestation/session stack
(``mc-attest-ake`` / ``mc-crypto-noise`` / ``mc-crypto-keys``; reference
grapevine.proto:17-36 and README.md:177-199, SURVEY.md §2b):

- :mod:`chacha`     — ChaCha20 keystream; the per-request challenge RNG
  that client and server advance in lockstep (README.md:195-196).
- :mod:`ristretto`  — ristretto255 group (pure Python) and plain Schnorr
  signatures with the ``b"grapevine-challenge"`` signing context
  (reference types/src/lib.rs:13).
- :mod:`merlin`     — merlin transcripts (STROBE-128 / Keccak-f[1600]),
  vector-pinned; the transcript layer under sr25519.
- :mod:`schnorrkel` — sr25519 signatures byte-compatible with the
  reference's ``sign_schnorrkel`` clients (README.md:193-199).
- :mod:`channel`    — X25519 + ChaCha20-Poly1305 encrypted channel with a
  pluggable attestation-evidence interface. The card has no enclave; the
  evidence hook keeps SGX/TDX/none swappable (SURVEY.md §1 layer 2).

Nothing in this package imports ``torch`` or touches the device: channel crypto terminates on
the host, exactly as the reference's session layer terminates at the
enclave boundary.
"""

from .chacha import ChaCha20, ChallengeRng  # noqa: F401
from .ristretto import (  # noqa: F401
    RistrettoPoint,
    keygen,
    public_key,
    sign,
    verify,
)

# The channel layer runs on either crypto backend: the `cryptography`
# wheel when present (OpenSSL, constant-time), else the stdlib + numpy
# fallback (session/stdcrypto.py) — bit-compatible wire format either
# way, so this import never needs the historical wheel gate.
from .channel import (  # noqa: F401
    CRYPTO_BACKEND,
    NullAttestation,
    SecureChannel,
    client_handshake,
    server_handshake,
)

# which implementation carries the group arithmetic, the batch MSM and the
# merlin transcripts: "native" (native/r255.c, built at first import) or
# "python" (the pure-Python fallback, far slower: a batch verify of a full
# round's signatures would set the round's pace)
from ..native import BACKEND as R255_BACKEND  # noqa: F401,E402


def get_signature_scheme(name: str):
    """Module with sign/verify/batch_verify/keygen for a scheme name."""
    if name == "schnorrkel":
        from . import schnorrkel

        return schnorrkel
    if name == "rfc9496":
        from . import ristretto

        return ristretto
    raise ValueError(f"unknown signature scheme {name!r}")
