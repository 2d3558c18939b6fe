"""Client library: attested-style connection + signed CRUD helpers (a copy
of ``grapevine_tpu/server/client.py``; either package's client talks to
either package's server).

The "example client" role from the reference (README.md:128,179-199):
handshake via Auth, then per-request challenge-sign-encrypt over Query.
The client holds one ristretto identity key; every request draws the next
32-byte challenge from the session RNG (staying in lockstep with the
server), signs it under ``b"grapevine-challenge"``, and ships the
constant-size encrypted QueryRequest.
"""

from __future__ import annotations

import threading

import grpc

from ..session import channel as chan
from ..session.chacha import ChallengeRng
from ..wire import constants as C
from ..wire import protowire as pw
from ..wire.records import QueryRequest, QueryResponse, RequestRecord
from .uri import SERVICE_NAME
from .uri import GrapevineUri


class GrapevineClient:
    def __init__(
        self,
        uri: str | GrapevineUri,
        identity_seed: bytes,
        root_certs: bytes | None = None,
        signature_scheme: str = "schnorrkel",
        server_static: bytes | None = None,
        client_static=None,
    ):
        self.uri = uri if isinstance(uri, GrapevineUri) else GrapevineUri.parse(uri)
        from ..session import get_signature_scheme

        self._scheme = get_signature_scheme(signature_scheme)
        self.sk, self.public_key = self._scheme.keygen(identity_seed)
        if self.uri.use_tls:
            creds = grpc.ssl_channel_credentials(root_certificates=root_certs)
            self._grpc = grpc.secure_channel(self.uri.address, creds)
        else:
            self._grpc = grpc.insecure_channel(self.uri.address)
        ident = lambda b: b  # noqa: E731
        self._auth_rpc = self._grpc.unary_unary(
            f"/{SERVICE_NAME}/Auth", request_serializer=ident, response_deserializer=ident
        )
        self._query_rpc = self._grpc.unary_unary(
            f"/{SERVICE_NAME}/Query", request_serializer=ident, response_deserializer=ident
        )
        self._channel: chan.SecureChannel | None = None
        self._challenge: ChallengeRng | None = None
        self._channel_id = b""
        #: pinned server static (IX): auth() rejects a server whose
        #: handshake-authenticated static differs (MITM detection)
        self._server_static = server_static
        #: optional client static X25519 private key (IX initiator s)
        self._client_static = client_static
        # challenge draw + AEAD counters + wire round-trip must stay
        # ordered: an overtaking request desyncs the server's lockstep
        # challenge RNG permanently (reference README.md:195-196)
        self._lock = threading.Lock()

    # -- connection -----------------------------------------------------

    def auth(self, attestation=None) -> None:
        """Run the key exchange and seed the challenge RNG.

        Holds the same lock as ``_query``: a re-auth racing an in-flight
        request would otherwise mix the old challenge RNG with the new
        channel and permanently desync the server's lockstep RNG.
        """
        state, msg1 = chan.client_handshake(self._client_static)
        with self._lock:
            reply = pw.decode_auth_with_seed(
                self._auth_rpc(pw.encode_auth_message(pw.AuthMessage(data=msg1)))
            )
            self._channel = chan.client_finish(
                state,
                reply.auth_message.data,
                attestation,
                expected_server_static=self._server_static,
            )
            payload = self._channel.decrypt(reply.encrypted_challenge_seed)
            # seed (32) ‖ server-assigned session token (the channel id)
            seed, token = payload[:32], payload[32:]
            self._challenge = ChallengeRng(seed)
            self._channel_id = token

    def _query(self, req: QueryRequest) -> QueryResponse:
        if self._channel is None or self._challenge is None:
            raise RuntimeError("call auth() first")
        with self._lock:
            challenge = self._challenge.next_challenge()
            req.auth_identity = self.public_key
            req.auth_signature = self._scheme.sign(
                self.sk, C.GRAPEVINE_CHALLENGE_SIGNING_CONTEXT, challenge
            )
            ciphertext = self._channel.encrypt(req.pack())
            reply = pw.decode_envelope(
                self._query_rpc(
                    pw.encode_envelope(
                        pw.EnvelopeMessage(channel_id=self._channel_id, data=ciphertext)
                    )
                )
            )
            return QueryResponse.unpack(self._channel.decrypt(reply.data))

    # -- CRUD helpers (reference README.md:162-175) ---------------------

    def create(self, recipient: bytes, payload: bytes) -> QueryResponse:
        return self._query(
            QueryRequest(
                request_type=C.REQUEST_TYPE_CREATE,
                record=RequestRecord(recipient=recipient, payload=payload),
            )
        )

    def read(self, msg_id: bytes = C.ZERO_MSG_ID) -> QueryResponse:
        """Read by id; the zero id means "my next message"."""
        return self._query(
            QueryRequest(
                request_type=C.REQUEST_TYPE_READ,
                record=RequestRecord(msg_id=msg_id),
            )
        )

    def update(self, msg_id: bytes, recipient: bytes, payload: bytes) -> QueryResponse:
        return self._query(
            QueryRequest(
                request_type=C.REQUEST_TYPE_UPDATE,
                record=RequestRecord(msg_id=msg_id, recipient=recipient, payload=payload),
            )
        )

    def delete(self, msg_id: bytes = C.ZERO_MSG_ID, recipient: bytes = C.ZERO_PUBKEY) -> QueryResponse:
        """Delete by id (recipient must match), or pop my next message."""
        return self._query(
            QueryRequest(
                request_type=C.REQUEST_TYPE_DELETE,
                record=RequestRecord(msg_id=msg_id, recipient=recipient),
            )
        )

    def close(self):
        self._grpc.close()
