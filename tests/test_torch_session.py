"""The port's session layer (``grapevine_tpu_torch/session``,
``grapevine_tpu_torch/native``) against the reference's
(``grapevine_tpu/session``, ``grapevine_tpu/native``), byte for byte
(tolerance 0): merlin transcripts, ristretto255 encodings, challenge
streams, the stdlib ChaCha20 / Poly1305 / HKDF-HMAC / X25519 backend, and
sr25519 and RFC 9496 signatures (deterministic; batch verification under a
fixed ``rng``). Each package verifies the other's signatures and both
reject the same corrupted ones; the port's native build agrees with its
pure-Python path; IX handshakes interoperate in both directions under
every pair of channel backends. Modelled on the reference's
``test_session.py``, ``test_schnorrkel.py``, ``test_merlin.py``,
``test_native_r255.py``, ``test_ix_handshake.py`` and
``test_stdcrypto.py``."""

import os
import random

import pytest

from grapevine_tpu import native as ref_native
from grapevine_tpu.session import chacha as ref_chacha
from grapevine_tpu.session import channel as ref_channel
from grapevine_tpu.session import merlin as ref_merlin
from grapevine_tpu.session import ristretto as ref_r
from grapevine_tpu.session import schnorrkel as ref_sk
from grapevine_tpu.session import stdcrypto as ref_std
from grapevine_tpu_torch import native
from grapevine_tpu_torch import session
from grapevine_tpu_torch.session import chacha, channel, merlin, ristretto, schnorrkel, stdcrypto
from grapevine_tpu_torch.wire import constants as C

CTX = C.GRAPEVINE_CHALLENGE_SIGNING_CONTEXT
SCHEMES = {"schnorrkel": (schnorrkel, ref_sk), "rfc9496": (ristretto, ref_r)}

try:
    import cryptography  # noqa: F401

    HAVE_WHEEL = True
except ModuleNotFoundError:
    HAVE_WHEEL = False


def _items(scheme, rng: random.Random, n: int):
    """n (pub, context, message, signature) items signed by ``scheme``."""
    out = []
    for _ in range(n):
        sk, pub = scheme.keygen(rng.randbytes(32))
        msg = rng.randbytes(32)
        out.append((pub, CTX, msg, scheme.sign(sk, CTX, msg)))
    return out


def _corrupt(items, rng: random.Random):
    """Copies of ``items`` with one corrupted field each: message, context,
    signature bit, R point, public key, signature length."""
    bad = []
    for k, (pub, ctx, msg, sig) in enumerate(items):
        kind = k % 6
        if kind == 0:
            bad.append((pub, ctx, rng.randbytes(32), sig))
        elif kind == 1:
            bad.append((pub, b"other-context", msg, sig))
        elif kind == 2:
            i = rng.randrange(64)
            bad.append((pub, ctx, msg, sig[:i] + bytes([sig[i] ^ 1]) + sig[i + 1:]))
        elif kind == 3:
            bad.append((pub, ctx, msg, rng.randbytes(32) + sig[32:]))
        elif kind == 4:
            bad.append((rng.randbytes(32), ctx, msg, sig))
        else:
            bad.append((pub, ctx, msg, sig[:-1]))
    return bad


# -- merlin, ristretto, challenge streams ---------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merlin_transcripts_equal_reference(seed):
    rng = random.Random(seed)
    ops = [(rng.randrange(3), rng.randbytes(rng.randrange(1, 12)),
            rng.randbytes(rng.randrange(0, 400)), rng.randrange(1, 200))
           for _ in range(40)]
    t, u = merlin.Transcript(b"equiv"), ref_merlin.Transcript(b"equiv")
    for kind, label, msg, n in ops:
        if kind == 0:
            t.append_message(label, msg)
            u.append_message(label, msg)
        elif kind == 1:
            v = rng.getrandbits(64)
            t.append_u64(label, v)
            u.append_u64(label, v)
        else:
            assert t.challenge_bytes(label, n) == u.challenge_bytes(label, n)
        assert bytes(t.strobe.blob) == bytes(u.strobe.blob)
    # the port's pure-Python framing gives the same bytes as its native ops
    if native.lib is not None:
        lib, native.lib = native.lib, None
        try:
            p = merlin.Transcript(b"equiv")
            for kind, label, msg, n in ops[:10]:
                if kind == 0:
                    p.append_message(label, msg)
        finally:
            native.lib = lib
        q = merlin.Transcript(b"equiv")
        for kind, label, msg, n in ops[:10]:
            if kind == 0:
                q.append_message(label, msg)
        assert bytes(p.strobe.blob) == bytes(q.strobe.blob)


def test_keccak_equals_reference():
    rng = random.Random(5)
    for _ in range(8):
        a = bytearray(rng.randbytes(200))
        b = bytearray(a)
        merlin.keccak_f1600(a)
        ref_merlin.keccak_f1600(b)
        assert a == b
        c = bytearray(b)
        merlin._keccak_f1600_py(c)
        ref_merlin._keccak_f1600_py(b)
        assert b == c


@pytest.mark.parametrize("seed", [0, 1])
def test_ristretto_encode_decode_equal_reference(seed):
    rng = random.Random(seed)
    for _ in range(24):
        k = rng.randrange(1, ristretto.L)
        enc = (k * ristretto.BASEPOINT).encode()
        assert enc == (k * ref_r.BASEPOINT).encode()
        assert ristretto.RistrettoPoint.decode(enc).encode() == enc
    # random 32-byte strings: the same accept/reject and the same point
    accepted = 0
    for _ in range(200):
        raw = rng.randbytes(32)
        try:
            want = ref_r.RistrettoPoint.decode(raw).encode()
        except ValueError:
            with pytest.raises(ValueError):
                ristretto.RistrettoPoint.decode(raw)
            continue
        assert ristretto.RistrettoPoint.decode(raw).encode() == want
        accepted += 1
    assert 0 < accepted < 200


@pytest.mark.parametrize("wheel", [True, False])
def test_challenge_rng_streams_equal_reference(wheel, monkeypatch):
    """The lockstep challenge stream, through the OpenSSL keystream and
    through the numpy fallback (``_Cipher`` unset), equals the
    reference's and the RFC block function."""
    if wheel and not HAVE_WHEEL:
        pytest.skip("the cryptography wheel is not installed")
    if not wheel:
        monkeypatch.setattr(chacha, "_Cipher", None)
    rng = random.Random(3)
    for _ in range(4):
        seed = rng.randbytes(32)
        a, b = chacha.ChallengeRng(seed), ref_chacha.ChallengeRng(seed)
        draws = [a.next_challenge() for _ in range(9)]
        assert draws == [b.next_challenge() for _ in range(9)]
        oracle = chacha.ChaCha20(seed)
        want = b"".join(ref_chacha.ChaCha20(seed)._block(i) for i in range(5))
        assert b"".join(draws) == want[:9 * 32]
        assert oracle._block(3) == ref_chacha.ChaCha20(seed)._block(3)


# -- the stdlib crypto backend ----------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_stdcrypto_equals_reference(seed):
    rng = random.Random(seed)
    key, nonce = rng.randbytes(32), rng.randbytes(12)
    for n in (0, 1, 63, 64, 65, 1300):
        data = rng.randbytes(n)
        ctr = rng.randrange(0, 1 << 20)
        assert stdcrypto.chacha20_keystream(key, nonce, n, ctr) == \
            ref_std.chacha20_keystream(key, nonce, n, ctr)
        assert stdcrypto.chacha20_xor(key, nonce, data, ctr) == \
            ref_std.chacha20_xor(key, nonce, data, ctr)
        assert stdcrypto.poly1305(key, data) == ref_std.poly1305(key, data)
        aad = rng.randbytes(rng.randrange(0, 40))
        ct = stdcrypto.ChaCha20Poly1305(key).encrypt(nonce, data, aad)
        assert ct == ref_std.ChaCha20Poly1305(key).encrypt(nonce, data, aad)
        assert stdcrypto.ChaCha20Poly1305(key).decrypt(nonce, ct, aad) == data
        ikm, salt, info = rng.randbytes(40), rng.randbytes(16), rng.randbytes(10)
        assert stdcrypto.hkdf_sha256(ikm, salt, info, 64) == \
            ref_std.hkdf_sha256(ikm, salt, info, 64)
    for _ in range(4):
        s, u = rng.randbytes(32), rng.randbytes(32)
        assert stdcrypto.x25519(s, u) == ref_std.x25519(s, u)
        priv = stdcrypto.X25519PrivateKey.from_private_bytes(s)
        assert priv.public_key().public_bytes_raw() == \
            ref_std.X25519PrivateKey.from_private_bytes(s).public_key().public_bytes_raw()
    bad = bytearray(ct)
    bad[0] ^= 1
    with pytest.raises(Exception):
        stdcrypto.ChaCha20Poly1305(key).decrypt(nonce, bytes(bad), aad)


# -- signatures -------------------------------------------------------------


@pytest.mark.parametrize("name", list(SCHEMES))
def test_signatures_equal_reference_and_cross_verify(name):
    port, ref = SCHEMES[name]
    rng = random.Random(11)
    for _ in range(6):
        seed, msg = rng.randbytes(32), rng.randbytes(32)
        sk, pub = port.keygen(seed)
        assert (sk, pub) == ref.keygen(seed)
        sig = port.sign(sk, CTX, msg)
        assert sig == ref.sign(sk, CTX, msg)
        assert port.verify(pub, CTX, msg, sig) and ref.verify(pub, CTX, msg, sig)
    items = _items(ref, rng, 12)
    assert all(port.verify(*it) for it in items)
    mine = _items(port, rng, 12)
    assert all(ref.verify(*it) for it in mine)
    for it in _corrupt(items + mine, rng):
        assert port.verify(*it) is False
        assert ref.verify(*it) is False


@pytest.mark.parametrize("name", list(SCHEMES))
def test_batch_verify_equals_reference_under_fixed_rng(name):
    port, ref = SCHEMES[name]
    rng = random.Random(17)
    items = _items(ref, rng, 16) + _items(port, rng, 16)
    assert port.batch_verify(items, rng=random.Random(1))
    assert ref.batch_verify(items, rng=random.Random(1))
    assert port.batch_verify([], rng=random.Random(1))
    for k, bad in enumerate(_corrupt(items[:12], rng)):
        batch = items[:k] + [bad] + items[k + 1:]
        assert port.batch_verify(batch, rng=random.Random(k)) is False
        assert ref.batch_verify(batch, rng=random.Random(k)) is False


def test_expand_mini_secret_equals_reference():
    rng = random.Random(2)
    for _ in range(4):
        seed = rng.randbytes(32)
        sk, nonce = schnorrkel.expand_mini_secret(seed)
        assert (sk, nonce) == ref_sk.expand_mini_secret(seed)
        assert schnorrkel.public_key(sk) == ref_sk.public_key(sk)
    assert schnorrkel._challenge_scalar(CTX, b"\x01" * 32, b"\x02" * 32, b"\x03" * 32) == \
        ref_sk._challenge_scalar(CTX, b"\x01" * 32, b"\x02" * 32, b"\x03" * 32)
    assert session.get_signature_scheme("schnorrkel") is schnorrkel
    assert session.get_signature_scheme("rfc9496") is ristretto
    with pytest.raises(ValueError):
        session.get_signature_scheme("ed25519")


# -- the native library -----------------------------------------------------


def test_native_library_is_the_ports_own_build():
    """The port builds its own r255.c into build/ under a hashed name; it
    never loads the reference's shared object."""
    assert native.BACKEND == session.R255_BACKEND
    if native.lib is None:
        pytest.skip("no C compiler: the pure-Python fallback is live")
    assert native.BACKEND == "native"
    so = native.library_path()
    assert so.exists() and so.parent == native.BUILD_DIR
    assert so.name.startswith("libgv_r255-") and so.name.endswith(".so")
    assert native.lib._name == str(so)
    assert ref_native.lib is None or ref_native.lib._name != native.lib._name


def test_native_agrees_with_pure_python():
    if native.lib is None:
        pytest.skip("no C compiler: the pure-Python fallback is live")
    rng = random.Random(23)
    items = _items(schnorrkel, rng, 10)
    bad = _corrupt(items, rng)
    encs = [(rng.randrange(1, ristretto.L) * ristretto.BASEPOINT).encode() for _ in range(8)]
    sk, _ = schnorrkel.keygen(rng.randbytes(32))

    def run():
        ristretto.public_key.cache_clear()
        ristretto._decode_pub_cached.cache_clear()
        return ([schnorrkel.verify(*it) for it in items + bad],
                [schnorrkel.batch_verify(items[:k] + [bad[k]], rng=random.Random(k))
                 for k in range(len(bad))],
                schnorrkel.batch_verify(items, rng=random.Random(0)),
                [ristretto.RistrettoPoint.decode(e).encode() for e in encs],
                schnorrkel.public_key(sk), schnorrkel.sign(sk, CTX, b"\x05" * 32),
                merlin.Transcript(b"x").challenge_bytes(b"c", 64))

    got_native = run()
    lib, native.lib = native.lib, None
    try:
        got_pure = run()
    finally:
        native.lib = lib
        ristretto.public_key.cache_clear()
        ristretto._decode_pub_cached.cache_clear()
    assert got_native == got_pure
    assert got_native[0] == [True] * len(items) + [False] * len(bad)


# -- IX handshakes across packages and backends -----------------------------


def _use_stdlib(mp, chan_mod, chacha_mod, std_mod):
    mp.setattr(chan_mod, "ChaCha20Poly1305", std_mod.ChaCha20Poly1305)
    mp.setattr(chan_mod, "X25519PrivateKey", std_mod.X25519PrivateKey)
    mp.setattr(chan_mod, "X25519PublicKey", std_mod.X25519PublicKey)
    mp.setattr(chan_mod, "_hkdf", std_mod.hkdf_sha256)
    mp.setattr(chan_mod, "CRYPTO_BACKEND", "stdlib")
    mp.setattr(chacha_mod, "_Cipher", None)


@pytest.fixture(params=[("cryptography", "cryptography"), ("cryptography", "stdlib"),
                        ("stdlib", "cryptography"), ("stdlib", "stdlib")],
                ids=lambda p: f"port-{p[0]}-ref-{p[1]}")
def backends(request, monkeypatch):
    port_b, ref_b = request.param
    if "cryptography" in request.param and not HAVE_WHEEL:
        pytest.skip("the cryptography wheel is not installed")
    if port_b == "stdlib":
        _use_stdlib(monkeypatch, channel, chacha, stdcrypto)
    if ref_b == "stdlib":
        _use_stdlib(monkeypatch, ref_channel, ref_chacha, ref_std)
    return request.param


def _talk(client_chan, server_chan, rng):
    for i in range(4):
        req = rng.randbytes(C.QUERY_REQUEST_WIRE_SIZE)
        aad = rng.randbytes(i * 5)
        assert server_chan.decrypt(client_chan.encrypt(req, aad), aad) == req
        resp = rng.randbytes(C.QUERY_RESPONSE_WIRE_SIZE)
        assert client_chan.decrypt(server_chan.encrypt(resp)) == resp


@pytest.mark.parametrize("direction", ["port-client", "ref-client"])
def test_handshake_interoperates(backends, direction):
    """A client of one package completes the IX handshake with a server of
    the other, pins its static, and exchanges frames both ways; a tampered
    frame fails on the other side. The challenge seed ciphertext opens."""
    assert channel.CRYPTO_BACKEND == backends[0]
    cl, sv = (channel, ref_channel) if direction == "port-client" else (ref_channel, channel)
    rng = random.Random(hash(backends) & 0xFFFF)
    ident = sv.ServerIdentity.from_seed(rng.randbytes(32))
    static = cl.X25519PrivateKey.from_private_bytes(rng.randbytes(32))
    state, msg1 = cl.client_handshake(static)
    reply, server_chan = sv.server_handshake(msg1, identity=ident)
    client_chan = cl.client_finish(state, reply, expected_server_static=ident.public)
    assert client_chan.peer_static == ident.public
    assert server_chan.peer_static == static.public_key().public_bytes_raw()
    seed = sv.new_challenge_seed()
    assert client_chan.decrypt(server_chan.encrypt(seed + b"t" * 16)) == seed + b"t" * 16
    _talk(client_chan, server_chan, rng)
    bad = bytearray(client_chan.encrypt(b"x" * 40))
    bad[3] ^= 1
    with pytest.raises(Exception):
        server_chan.decrypt(bytes(bad))
    # a pinned impostor static is refused before any frame flows
    state, msg1 = cl.client_handshake()
    reply, _ = sv.server_handshake(msg1, identity=sv.ServerIdentity.from_seed(b"\x01" * 32))
    with pytest.raises(ValueError):
        cl.client_finish(state, reply, expected_server_static=ident.public)


def test_handshake_bytes_equal_reference_under_fixed_randomness(monkeypatch):
    """With the stdlib backend on both sides and the same os.urandom, the
    port's handshake messages, channel frames and challenge seed are the
    reference's bytes."""
    _use_stdlib(monkeypatch, channel, chacha, stdcrypto)
    _use_stdlib(monkeypatch, ref_channel, ref_chacha, ref_std)

    def run(chan_mod, std_mod):
        ctr = [0]

        def urandom(n):
            ctr[0] += 1
            return random.Random(ctr[0]).randbytes(n)

        monkeypatch.setattr(os, "urandom", urandom)
        try:
            ident = chan_mod.ServerIdentity.from_seed(b"\x09" * 32)
            state, msg1 = chan_mod.client_handshake(std_mod.X25519PrivateKey.generate())
            reply, server_chan = chan_mod.server_handshake(msg1, identity=ident)
            client_chan = chan_mod.client_finish(state, reply)
            seed = chan_mod.new_challenge_seed()
            frames = [client_chan.encrypt(b"q" * 64), server_chan.encrypt(seed)]
        finally:
            monkeypatch.undo()
            _use_stdlib(monkeypatch, channel, chacha, stdcrypto)
            _use_stdlib(monkeypatch, ref_channel, ref_chacha, ref_std)
        return msg1, reply, seed, frames

    assert run(channel, stdcrypto) == run(ref_channel, ref_std)
