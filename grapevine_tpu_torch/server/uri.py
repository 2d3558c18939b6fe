"""grapevine:// URI scheme (a copy of ``grapevine_tpu/server/uri.py``).

Mirrors the reference's typed URI crate: scheme ``grapevine`` (TLS,
default port 443) and ``insecure-grapevine`` (plaintext, default port
3229) (reference uri/src/lib.rs:11-26).
"""

from __future__ import annotations

import dataclasses
from urllib.parse import urlparse

#: gRPC service name (reference grapevine.proto:10); lives here so the
#: torch-free client library can import it without touching the engine
SERVICE_NAME = "grapevine.GrapevineAPI"

SCHEME_SECURE = "grapevine"
SCHEME_INSECURE = "insecure-grapevine"
DEFAULT_SECURE_PORT = 443
DEFAULT_INSECURE_PORT = 3229


@dataclasses.dataclass(frozen=True)
class GrapevineUri:
    host: str
    port: int
    use_tls: bool

    @classmethod
    def parse(cls, uri: str) -> "GrapevineUri":
        parsed = urlparse(uri)
        if parsed.scheme == SCHEME_SECURE:
            use_tls, default_port = True, DEFAULT_SECURE_PORT
        elif parsed.scheme == SCHEME_INSECURE:
            use_tls, default_port = False, DEFAULT_INSECURE_PORT
        else:
            raise ValueError(
                f"unknown scheme {parsed.scheme!r}: expected "
                f"{SCHEME_SECURE}:// or {SCHEME_INSECURE}://"
            )
        if not parsed.hostname:
            raise ValueError("missing host")
        return cls(
            host=parsed.hostname,
            port=parsed.port if parsed.port is not None else default_port,
            use_tls=use_tls,
        )

    @property
    def address(self) -> str:
        host = f"[{self.host}]" if ":" in self.host else self.host  # IPv6
        return f"{host}:{self.port}"

    def __str__(self) -> str:
        scheme = SCHEME_SECURE if self.use_tls else SCHEME_INSECURE
        return f"{scheme}://{self.host}:{self.port}"
