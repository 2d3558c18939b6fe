"""The port's protobuf wire codec (``grapevine_tpu_torch/wire/protowire.py``)
against the reference's (``grapevine_tpu/wire/protowire.py``): byte-equal
encodings of random and edge messages, equal decodings, and the same
``ValueError`` on malformed bytes (tolerance 0 throughout). Modelled on
``tests/test_wire.py``."""

import random

import pytest

from grapevine_tpu.wire import protowire as ref_pw
from grapevine_tpu.wire import records as ref_rec
from grapevine_tpu_torch.wire import constants as C
from grapevine_tpu_torch.wire import protowire as pw
from grapevine_tpu_torch.wire import records as rec

SEEDS = range(6)


def _pair(rng: random.Random, kind: str):
    """One random message of ``kind`` as (port object, reference object)."""
    if kind == "request":
        f = dict(request_type=rng.randrange(1, 5), auth_identity=rng.randbytes(C.PUBKEY_SIZE),
                 auth_signature=rng.randbytes(C.SIGNATURE_SIZE))
        r = dict(msg_id=rng.randbytes(C.MSG_ID_SIZE), recipient=rng.randbytes(C.PUBKEY_SIZE),
                 payload=rng.randbytes(C.PAYLOAD_SIZE))
        return (rec.QueryRequest(record=rec.RequestRecord(**r), **f),
                ref_rec.QueryRequest(record=ref_rec.RequestRecord(**r), **f))
    r = dict(msg_id=rng.randbytes(C.MSG_ID_SIZE), sender=rng.randbytes(C.PUBKEY_SIZE),
             recipient=rng.randbytes(C.PUBKEY_SIZE), timestamp=rng.getrandbits(64),
             payload=rng.randbytes(C.PAYLOAD_SIZE))
    code = rng.randrange(1, 10)
    return (rec.QueryResponse(record=rec.Record(**r), status_code=code),
            ref_rec.QueryResponse(record=ref_rec.Record(**r), status_code=code))


def _edge_pairs(kind: str):
    """All-zero bytes fields with the smallest and largest scalars (the
    prost emission rule omits zero scalars, so the codec refuses them to
    keep every message one size)."""
    if kind == "request":
        return [(rec.QueryRequest(request_type=t), ref_rec.QueryRequest(request_type=t))
                for t in (1, 4)]
    return [(rec.QueryResponse(status_code=c, record=rec.Record(timestamp=ts)),
             ref_rec.QueryResponse(status_code=c, record=ref_rec.Record(timestamp=ts)))
            for c, ts in ((1, 1), (9, (1 << 64) - 1))]


@pytest.mark.parametrize("kind", ["request", "response"])
@pytest.mark.parametrize("seed", SEEDS)
def test_query_codec_equals_reference(kind, seed):
    enc, dec = ((pw.encode_query_request, pw.decode_query_request) if kind == "request"
                else (pw.encode_query_response, pw.decode_query_response))
    ref_enc, ref_dec = ((ref_pw.encode_query_request, ref_pw.decode_query_request)
                        if kind == "request" else
                        (ref_pw.encode_query_response, ref_pw.decode_query_response))
    rng = random.Random(seed)
    for port_obj, ref_obj in [_pair(rng, kind) for _ in range(8)] + _edge_pairs(kind):
        data = enc(port_obj)
        assert data == ref_enc(ref_obj)
        assert dec(data).pack() == ref_dec(data).pack() == port_obj.pack()
        # the fixed-layout stack agrees with the protobuf stack
        assert port_obj.pack() == ref_obj.pack()
    # a zero scalar would shorten the message: both encoders refuse it
    zero = (rec.QueryRequest(), ref_rec.QueryRequest()) if kind == "request" else \
        (rec.QueryResponse(record=rec.Record(timestamp=1)),
         ref_rec.QueryResponse(record=ref_rec.Record(timestamp=1)))
    with pytest.raises(ValueError):
        ref_enc(zero[1])
    with pytest.raises(ValueError):
        enc(zero[0])


@pytest.mark.parametrize("seed", SEEDS)
def test_outer_messages_equal_reference(seed):
    rng = random.Random(seed)
    for n in (0, 1, 32, 48, 200, rng.randrange(1, 4096)):
        blob = rng.randbytes(n)
        other = rng.randbytes(rng.randrange(0, 64))
        assert pw.encode_auth_message(pw.AuthMessage(data=blob)) == \
            ref_pw.encode_auth_message(ref_pw.AuthMessage(data=blob))
        env = pw.encode_envelope(pw.EnvelopeMessage(aad=other, channel_id=blob[:16],
                                                    data=blob))
        assert env == ref_pw.encode_envelope(
            ref_pw.EnvelopeMessage(aad=other, channel_id=blob[:16], data=blob))
        got, want = pw.decode_envelope(env), ref_pw.decode_envelope(env)
        assert (got.aad, got.channel_id, got.data) == (want.aad, want.channel_id, want.data)
        seed_msg = pw.encode_auth_with_seed(pw.AuthMessageWithChallengeSeed(
            auth_message=pw.AuthMessage(data=blob), encrypted_challenge_seed=other))
        assert seed_msg == ref_pw.encode_auth_with_seed(ref_pw.AuthMessageWithChallengeSeed(
            auth_message=ref_pw.AuthMessage(data=blob), encrypted_challenge_seed=other))
        got = pw.decode_auth_with_seed(seed_msg)
        assert (got.auth_message.data, got.encrypted_challenge_seed) == (blob, other)
        assert pw.decode_auth_message(pw.encode_auth_message(pw.AuthMessage(data=blob))).data \
            == blob


def _malformed(rng: random.Random) -> list[bytes]:
    good = pw.encode_query_request(_pair(rng, "request")[0])
    return [
        b"\x0a",                        # a length-delimited tag with no length
        b"\x0a\x05ab",                  # length past the end
        b"\x08" + b"\xff" * 11,         # varint longer than 10 bytes
        b"\x0d\x01\x02",                # fixed32 cut short
        b"\x09\x01",                    # fixed64 cut short
        b"\x0b",                        # wire type 3 (group start)
        good[:-1],                      # a valid message cut by one byte
        good[:len(good) // 2],
        bytes([rng.randrange(256) for _ in range(rng.randrange(1, 40))]),
    ]


@pytest.mark.parametrize("seed", SEEDS)
def test_malformed_bytes_raise_value_error_in_both(seed):
    """Whatever the reference rejects with ValueError the port rejects with
    ValueError, and whatever the reference accepts the port decodes to
    the same message."""
    decoders = [(pw.decode_query_request, ref_pw.decode_query_request),
                (pw.decode_query_response, ref_pw.decode_query_response),
                (pw.decode_envelope, ref_pw.decode_envelope),
                (pw.decode_auth_with_seed, ref_pw.decode_auth_with_seed),
                (pw.decode_auth_message, ref_pw.decode_auth_message)]
    rng = random.Random(seed)
    rejected = 0
    for data in _malformed(rng):
        for dec, ref_dec in decoders:
            try:
                want = ref_dec(data)
            except ValueError:
                with pytest.raises(ValueError):
                    dec(data)
                rejected += 1
                continue
            got = dec(data)
            assert repr(got) == repr(want)
    assert rejected >= 30
