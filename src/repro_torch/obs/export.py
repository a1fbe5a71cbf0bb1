"""Stdlib-only exporters: a Prometheus/JSON HTTP endpoint for a live
registry.

Counterpart of ``repro/obs/export.py`` (a stdlib copy).
``python -m repro_torch.launch.serve_gp --fleet B --metrics-port 9100``
starts this next to the serving loop:

* ``GET /metrics``       → Prometheus text exposition (version 0.0.4)
* ``GET /metrics.json``  → :meth:`MetricsRegistry.snapshot` as JSON

The server runs on a daemon thread (it never outlives the process) and
reads the registry under its lock, so scrapes are consistent snapshots
even while the dispatcher thread is recording.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

__all__ = ["start_metrics_server", "MetricsServer"]


class MetricsServer:
    """Handle on a running exporter: ``.port`` (useful with port 0),
    ``.url``, ``.shutdown()``."""

    def __init__(self, httpd: ThreadingHTTPServer, thread: threading.Thread):
        self._httpd = httpd
        self._thread = thread
        self.port = httpd.server_address[1]
        self.url = f"http://{httpd.server_address[0]}:{self.port}/metrics"

    def shutdown(self) -> None:
        self._httpd.shutdown()
        self._thread.join(timeout=5.0)
        self._httpd.server_close()


def start_metrics_server(registry, port: int = 0,
                         host: str = "127.0.0.1") -> MetricsServer:
    """Expose ``registry`` over HTTP; ``port=0`` binds an ephemeral port
    (read it back from the returned handle — tests do)."""

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            if self.path in ("/", "/metrics"):
                body = registry.render_prometheus().encode()
                ctype = "text/plain; version=0.0.4; charset=utf-8"
            elif self.path == "/metrics.json":
                body = json.dumps(registry.snapshot(), indent=2).encode()
                ctype = "application/json"
            else:
                self.send_response(404)
                self.end_headers()
                return
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):   # keep scrapes out of stderr
            pass

    httpd = ThreadingHTTPServer((host, port), Handler)
    httpd.daemon_threads = True
    thread = threading.Thread(target=httpd.serve_forever,
                              name="repro-metrics", daemon=True)
    thread.start()
    return MetricsServer(httpd, thread)
