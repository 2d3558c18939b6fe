"""Host runtime of the PyTorch port: gRPC frontend, request scheduler,
client library, CLI (a copy of ``grapevine_tpu/server``).

The analog of the reference's ``grapevine-server`` binary + ``uri`` crate
(reference README.md:122-128, uri/src/lib.rs; SURVEY.md §1 layers 1,6,7).

``GrapevineServer`` is imported lazily: the client library and URI
parsing must stay importable without pulling in the engine (and with it
``torch`` and a device runtime) — a client process never needs a device,
and neither does a host-pipeline worker.
"""

from .uri import GrapevineUri, SERVICE_NAME  # noqa: F401

__all__ = ["GrapevineUri", "SERVICE_NAME", "GrapevineClient", "GrapevineServer"]


def __getattr__(name):
    # GrapevineServer stays lazy so client processes never pull in the
    # engine (torch + a device runtime); GrapevineClient stays lazy so the
    # scheduler/metrics path never pays the session/grpc import
    if name == "GrapevineServer":
        from .service import GrapevineServer

        return GrapevineServer
    if name == "GrapevineClient":
        from .client import GrapevineClient

        return GrapevineClient
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
