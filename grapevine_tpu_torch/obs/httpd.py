"""The /metrics + /healthz (+ /leakaudit, /flightrec, /trace,
/profile) endpoint: a stdlib http.server thread (a copy of
``grapevine_tpu/obs/httpd.py``).

The device-owning servers pass the round tracer's ``/trace``, and with
``leakmon=``/``profile_enable=`` the leak monitor's ``/leakaudit`` and
``/flightrec`` and the profiler gate's ``/profile``
(``server/service.py``, ``server/tier.py``); an endpoint without its
callable answers 404.

Deliberately not a gRPC method on the public service: scrapers and
load-balancer health checks speak plain HTTP, and the endpoint must stay
up (and truthful) when the engine wedges — so it runs on its own daemon
thread with no dependency on the gRPC executor or the collector loop.

Leak stance: the endpoint serves only the registry (already audited to
be batch-level) and a healthz verdict. It binds wherever the operator
points ``--metrics-port``; like the engine tier's Submit listener, keep
it on localhost or a private scrape network — batch-level metrics are
safe against the *clients*, but operational telemetry is still nobody
else's business.
"""

from __future__ import annotations

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .exporter import render_prometheus
from .registry import TelemetryRegistry

log = logging.getLogger("grapevine_tpu_torch.obs")


class MetricsServer:
    """Serve ``/metrics`` (Prometheus text) and ``/healthz`` (JSON).

    ``health`` is a zero-arg callable returning ``(healthy: bool,
    detail: dict)``; unhealthy renders HTTP 503 so any LB/probe flips
    without parsing the body. The callable runs on the scrape thread —
    it must not take engine locks that a wedged round could hold.

    ``leakaudit`` is a zero-arg callable returning the leak monitor's
    machine-readable verdict dict (obs/leakmon.py) — served on
    ``/leakaudit`` as JSON, HTTP 200 on PASS and 503 on SUSPECT so a
    probe can alert without parsing. ``flightrec`` is a zero-arg
    callable returning the flight recorder dump dict (obs/flightrec.py)
    — served on ``/flightrec``. Both 404 when not configured.

    ``trace`` is a zero-arg callable returning Chrome trace-event JSON
    as a dict (obs/tracer.py RoundTracer.chrome_trace) — served on
    ``/trace``, loadable directly in Perfetto. ``profile`` is a
    one-arg callable ``(ms) -> dict`` running a live profiler
    capture (obs/profiler.py ProfilerGate.capture) — served on
    ``/profile?ms=N``; a second concurrent request gets 409. Both 404
    when not configured (``profile`` exists only behind
    ``--profile-enable``).
    """

    def __init__(
        self,
        registry: TelemetryRegistry,
        health=None,
        refresh=None,
        host: str = "127.0.0.1",
        port: int = 9464,
        leakaudit=None,
        flightrec=None,
        trace=None,
        profile=None,
        render=None,
    ):
        self.registry = registry
        #: optional zero-arg callable returning the /metrics exposition
        #: text — the fleet aggregator (obs/fleet.py) substitutes its
        #: merged member view; default is this registry's own exposition
        self.render = render
        self.health = health or (lambda: (True, {}))
        self.leakaudit = leakaudit
        self.flightrec = flightrec
        self.trace = trace
        self.profile = profile
        #: optional zero-arg pre-scrape hook: sample pull-style gauges
        #: (stash occupancy needs a device sync, which must happen at
        #: scrape cadence, not round cadence). Runs only for /metrics —
        #: /healthz must stay lock-free and answer while a round wedges.
        self.refresh = refresh
        self._host = host
        self._port = port
        self._httpd: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None

    def start(self) -> int:
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # scrapes are not access-log news
                log.debug("metrics http: " + fmt, *args)

            def _reply(self, code: int, body: bytes, ctype: str):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.split("?")[0]
                if path == "/metrics":
                    if outer.refresh is not None:
                        try:
                            outer.refresh()
                        except Exception:
                            log.exception("metrics refresh hook failed")
                    if outer.render is not None:
                        body = outer.render().encode()
                    else:
                        body = render_prometheus(outer.registry).encode()
                    self._reply(
                        200, body, "text/plain; version=0.0.4; charset=utf-8"
                    )
                elif path == "/healthz":
                    try:
                        healthy, detail = outer.health()
                    except Exception as exc:  # a broken probe is unhealthy
                        healthy, detail = False, {"error": repr(exc)}
                    body = json.dumps(
                        {"healthy": bool(healthy), **detail}
                    ).encode()
                    self._reply(
                        200 if healthy else 503, body, "application/json"
                    )
                elif path == "/leakaudit" and outer.leakaudit is not None:
                    try:
                        verdict = outer.leakaudit()
                    except Exception as exc:  # a broken audit is suspect
                        verdict = {"verdict": "SUSPECT",
                                   "error": repr(exc)}
                    body = json.dumps(verdict).encode()
                    self._reply(
                        200 if verdict.get("verdict") == "PASS" else 503,
                        body, "application/json",
                    )
                elif path == "/flightrec" and outer.flightrec is not None:
                    try:
                        dump = outer.flightrec()
                    except Exception as exc:
                        self._reply(500, repr(exc).encode(), "text/plain")
                        return
                    self._reply(
                        200, json.dumps(dump).encode(), "application/json"
                    )
                elif path == "/trace" and outer.trace is not None:
                    try:
                        trace = outer.trace()
                    except Exception as exc:
                        self._reply(500, repr(exc).encode(), "text/plain")
                        return
                    self._reply(
                        200, json.dumps(trace).encode(), "application/json"
                    )
                elif path == "/profile" and outer.profile is not None:
                    from urllib.parse import parse_qs, urlparse

                    from .profiler import ProfilerBusy

                    qs = parse_qs(urlparse(self.path).query)
                    try:
                        ms = int(qs.get("ms", ["1000"])[0])
                    except ValueError:
                        self._reply(400, b"ms must be an integer\n",
                                    "text/plain")
                        return
                    try:
                        # blocks this handler thread for ~ms while the
                        # engine keeps serving (ThreadingHTTPServer:
                        # scrapes stay live on their own threads)
                        result = outer.profile(ms)
                    except ProfilerBusy as exc:
                        self._reply(409, str(exc).encode(), "text/plain")
                        return
                    except Exception as exc:
                        self._reply(500, repr(exc).encode(), "text/plain")
                        return
                    self._reply(
                        200, json.dumps(result).encode(), "application/json"
                    )
                else:
                    self._reply(404, b"not found\n", "text/plain")

        self._httpd = ThreadingHTTPServer((self._host, self._port), Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="grapevine-metrics",
        )
        self._thread.start()
        port = self._httpd.server_address[1]
        log.info("metrics endpoint on %s:%d (/metrics, /healthz%s%s%s)",
                 self._host, port,
                 ", /leakaudit, /flightrec" if self.leakaudit else "",
                 ", /trace" if self.trace else "",
                 ", /profile" if self.profile else "")
        return port

    @property
    def port(self) -> int | None:
        return self._httpd.server_address[1] if self._httpd else None

    def stop(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
