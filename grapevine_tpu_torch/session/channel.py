"""Encrypted session channel: X25519 IX handshake + ChaCha20-Poly1305.

The analog of the reference's attested noise channel (``mc-attest-ake``'s
Noise **IX** handshake + ``mc-crypto-noise`` cipher states; reference
grapevine.proto:10-15, README.md:177-183). Like IX, both sides' static
keys are authenticated *inside* the handshake:

- message 1 (client → server): ``e_c ‖ s_c`` — client ephemeral plus
  client static (all-zero s_c = anonymous client; per-request identity
  still comes from the sr25519 challenge signatures either way);
- message 2 (server → client): ``e_r ‖ AEAD(k_h, s_r ‖ evidence)`` —
  server ephemeral, then the server *static* and attestation evidence
  encrypted under a key derived from the ephemeral-ephemeral secret and
  bound to the transcript hash as AAD;
- channel keys = HKDF(ee ‖ es ‖ se, salt = transcript hash): the
  server can only derive them by owning ``s_r`` (es), and a client that
  sent a static can only derive them by owning ``s_c`` (se) — the IX
  mutual-authentication property. An active MITM that substitutes
  either static changes the transcript and the DH mix; the first frame
  on the channel fails AEAD (tests/test_ix_handshake.py MITM tests).

Server identity policy is the caller's: clients pin the expected server
static (``expected_server_static=``) and/or verify attestation evidence
bound to (static, transcript). With ``NullAttestation`` and no pinning,
``insecure-grapevine://`` sessions are confidential against passive
observers only — stated in SECURITY.md.

Attestation is a pluggable evidence interface: the card offers no SGX-style
remote attestation, so :class:`NullAttestation` ships empty evidence and
accepts peers — the interface point is kept so SGX/TDX/vTPM evidence can
slot in without touching the protocol (SURVEY.md §1 layer-2 mapping).
Evidence is *transcript-bound*: ``verify(evidence, binding=...)``
receives the hash covering both handshake messages and the server
static, so real evidence can sign it and preclude evidence replay.

Auth RPC wire shape (mirrors AuthMessageWithChallengeSeed,
grapevine.proto:26-36): the server's handshake reply carries its
handshake message + evidence, and the 32-byte challenge seed travels
only as ciphertext under the freshly established channel.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import struct

try:
    from cryptography.hazmat.primitives.asymmetric.x25519 import (
        X25519PrivateKey,
        X25519PublicKey,
    )
    from cryptography.hazmat.primitives.ciphers.aead import ChaCha20Poly1305
    from cryptography.hazmat.primitives.kdf.hkdf import HKDF
    from cryptography.hazmat.primitives import hashes

    CRYPTO_BACKEND = "cryptography"

    def _hkdf(ikm: bytes, salt: bytes, info: bytes, length: int) -> bytes:
        return HKDF(
            algorithm=hashes.SHA256(), length=length, salt=salt, info=info
        ).derive(ikm)

except ModuleNotFoundError:
    # Wheel-less container: the stdlib + numpy backend (stdcrypto.py) is
    # bit-compatible by RFC construction, so channels interoperate across
    # backends — a stdlib client speaks to a wheel-backed server and
    # vice versa (pinned in tests/test_stdcrypto.py when both exist).
    from .stdcrypto import (
        ChaCha20Poly1305,
        X25519PrivateKey,
        X25519PublicKey,
        hkdf_sha256 as _hkdf,
    )

    CRYPTO_BACKEND = "stdlib"

_HKDF_INFO = b"grapevine-tpu-channel-ix-v1"
_HS_INFO = b"grapevine-tpu-ix-handshake"
_PROTO_TAG = b"grapevine-tpu-ix-v1"
_ZERO32 = b"\x00" * 32


class NullAttestation:
    """No-enclave evidence provider: empty evidence, accepts all peers."""

    def evidence(self, binding: bytes = b"") -> bytes:
        return b""

    def verify(self, evidence: bytes, binding: bytes = b"") -> bool:
        return True


class SecureChannel:
    """Directional AEAD cipher states with 96-bit counter nonces."""

    def __init__(self, send_key: bytes, recv_key: bytes):
        self._send = ChaCha20Poly1305(send_key)
        self._recv = ChaCha20Poly1305(recv_key)
        self._send_keyb = send_key
        self._recv_keyb = recv_key
        self._send_n = 0
        self._recv_n = 0

    def export_keys(self) -> tuple[bytes, bytes, int, int]:
        """(send_key, recv_key, send_n, recv_n) — the hostpipe session
        hand-off (server/hostpipe.py): the sticky worker rebuilds both
        directional cipher states, counters included, in its own
        process; this side must stop using the channel afterwards or
        the nonce counters fork."""
        return self._send_keyb, self._recv_keyb, self._send_n, self._recv_n

    @staticmethod
    def _nonce(counter: int) -> bytes:
        return struct.pack("<Q", counter) + b"\x00" * 4

    def encrypt(self, plaintext: bytes, aad: bytes = b"") -> bytes:
        ct = self._send.encrypt(self._nonce(self._send_n), plaintext, aad)
        self._send_n += 1
        return ct

    def decrypt(self, ciphertext: bytes, aad: bytes = b"") -> bytes:
        pt = self._recv.decrypt(self._nonce(self._recv_n), ciphertext, aad)
        self._recv_n += 1
        return pt


def _derive_channel(
    ee: bytes, es: bytes, se: bytes, transcript: bytes
) -> tuple[bytes, bytes]:
    """(k_c2s, k_s2c) from the concatenated DH outputs + transcript."""
    okm = _hkdf(ee + es + se, transcript, _HKDF_INFO, 64)
    return okm[:32], okm[32:]


def _hs_key(ee: bytes, transcript: bytes) -> bytes:
    """Handshake-message key: encrypts the server static + evidence."""
    return _hkdf(ee, transcript, _HS_INFO, 32)


class ServerIdentity:
    """The server's static X25519 keypair (the IX responder static)."""

    def __init__(self, priv: X25519PrivateKey):
        self._priv = priv
        self.public = priv.public_key().public_bytes_raw()

    @classmethod
    def generate(cls) -> "ServerIdentity":
        return cls(X25519PrivateKey.generate())

    @classmethod
    def from_seed(cls, seed: bytes) -> "ServerIdentity":
        if len(seed) != 32:
            raise ValueError("identity seed must be 32 bytes")
        # domain-separate so a leaked channel seed never doubles as a key
        key = hashlib.sha256(b"grapevine-tpu-server-static" + seed).digest()
        return cls(X25519PrivateKey.from_private_bytes(key))


@dataclasses.dataclass
class ClientHandshake:
    """Client-side handshake state between message 1 and message 2."""

    eph_priv: X25519PrivateKey
    static_priv: X25519PrivateKey | None
    msg1: bytes


def client_handshake(client_static: X25519PrivateKey | None = None):
    """Start an IX handshake: returns (state, first_message_bytes).

    ``client_static`` authenticates the client inside the handshake
    (the IX ``s``/``se`` tokens); None sends the all-zero placeholder —
    an anonymous client, still request-authenticated via sr25519.
    """
    eph = X25519PrivateKey.generate()
    s_pub = (
        client_static.public_key().public_bytes_raw()
        if client_static is not None
        else _ZERO32
    )
    msg1 = eph.public_key().public_bytes_raw() + s_pub
    return ClientHandshake(eph, client_static, msg1), msg1


def client_finish(
    state: ClientHandshake,
    server_msg: bytes,
    attestation=None,
    expected_server_static: bytes | None = None,
):
    """Complete the handshake from the server's reply.

    ``server_msg`` = ``e_r (32) ‖ AEAD(k_h, s_r ‖ evidence)``. Verifies
    the transcript-bound AEAD, optionally pins the server static, and
    hands the evidence (with its transcript binding) to ``attestation``.
    Returns a :class:`SecureChannel`; the authenticated server static is
    exposed as ``channel.peer_static``.
    """
    attestation = attestation or NullAttestation()
    if len(server_msg) < 32 + 32 + 16:  # e_r + AEAD(s_r) at minimum
        raise ValueError("short handshake reply")
    e_r, ct = server_msg[:32], server_msg[32:]
    transcript1 = hashlib.sha256(_PROTO_TAG + state.msg1 + e_r).digest()
    ee = state.eph_priv.exchange(X25519PublicKey.from_public_bytes(e_r))
    try:
        inner = ChaCha20Poly1305(_hs_key(ee, transcript1)).decrypt(
            b"\x00" * 12, ct, transcript1
        )
    except Exception:
        raise ValueError("handshake reply failed authentication") from None
    s_r, evidence = inner[:32], inner[32:]
    if expected_server_static is not None and s_r != expected_server_static:
        raise ValueError("server static key does not match the pinned key")
    # the evidence binding covers both handshake messages AND the server
    # static, and is the SAME value the server signed over — a real
    # provider signs binding, the verifier checks that signature against
    # an identical binding (evidence itself excluded: the signer cannot
    # sign a hash of its own signature)
    binding = hashlib.sha256(transcript1 + s_r).digest()
    if not attestation.verify(evidence, binding=binding):
        raise ValueError("attestation evidence rejected")
    transcript2 = hashlib.sha256(transcript1 + s_r + evidence).digest()
    es = state.eph_priv.exchange(X25519PublicKey.from_public_bytes(s_r))
    se = (
        state.static_priv.exchange(X25519PublicKey.from_public_bytes(e_r))
        if state.static_priv is not None
        else b""
    )
    k_c2s, k_s2c = _derive_channel(ee, es, se, transcript2)
    channel = SecureChannel(send_key=k_c2s, recv_key=k_s2c)
    channel.peer_static = s_r
    return channel


def server_handshake(client_msg: bytes, attestation=None, identity=None):
    """Server side: returns (reply_bytes, channel).

    ``client_msg`` = ``e_c (32) ‖ s_c (32)`` (s_c all-zero = anonymous).
    ``identity`` is the server's :class:`ServerIdentity`; generated
    fresh when omitted (callers wanting a stable, pinnable identity
    pass one — GrapevineServer does). The claimed client static is
    exposed as ``channel.peer_static`` (None when anonymous); its
    ownership is proven by the ``se`` mix — a liar cannot decrypt
    anything on the resulting channel.
    """
    attestation = attestation or NullAttestation()
    identity = identity or ServerIdentity.generate()
    if len(client_msg) != 64:
        raise ValueError("handshake message must be e_c(32) ‖ s_c(32)")
    e_c, s_c = client_msg[:32], client_msg[32:]
    eph = X25519PrivateKey.generate()
    e_r = eph.public_key().public_bytes_raw()
    transcript1 = hashlib.sha256(_PROTO_TAG + client_msg + e_r).digest()
    ee = eph.exchange(X25519PublicKey.from_public_bytes(e_c))
    # same binding the client verifies against: msg1 ‖ e_r ‖ s_r
    evidence = attestation.evidence(
        binding=hashlib.sha256(transcript1 + identity.public).digest()
    )
    inner = identity.public + evidence
    ct = ChaCha20Poly1305(_hs_key(ee, transcript1)).encrypt(
        b"\x00" * 12, inner, transcript1
    )
    transcript2 = hashlib.sha256(transcript1 + identity.public + evidence).digest()
    es = identity._priv.exchange(X25519PublicKey.from_public_bytes(e_c))
    se = (
        eph.exchange(X25519PublicKey.from_public_bytes(s_c))
        if s_c != _ZERO32
        else b""
    )
    k_c2s, k_s2c = _derive_channel(ee, es, se, transcript2)
    channel = SecureChannel(send_key=k_s2c, recv_key=k_c2s)
    channel.peer_static = None if s_c == _ZERO32 else s_c
    return e_r + ct, channel


def new_challenge_seed() -> bytes:
    return os.urandom(32)
