"""Embedded web GUI: a background HTTP server with the reference's API
surface and a minimal status page (`-gui`, `-gui-port`, `-host`).

Endpoint parity with the reference WebGuiServer
(reference: src/ui/WebGuiServer.cpp:355-398): GET /api/state,
/api/results, /api/load-settings, /api/load-worktodo;
POST /api/save-settings, /api/append-worktodo, /api/stop.

The JAX package's prmers_tpu/ui/webgui.py word for word below this
docstring (the standard library only); the port's app.py starts it and
feeds it the run's state as the JAX package's core/app.py does.
"""

from __future__ import annotations

import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

_PAGE = """<!doctype html>
<html><head><title>prmers_tpu</title><style>
body{font-family:monospace;background:#111;color:#ddd;margin:2em}
.card{background:#1c1c1c;padding:1em;margin:1em 0;border-radius:8px}
h1{color:#7fd} pre{white-space:pre-wrap}
</style></head><body>
<h1>prmers_tpu</h1>
<div class=card><h3>state</h3><pre id=state></pre></div>
<div class=card><h3>results</h3><pre id=results></pre></div>
<div class=card><h3>worktodo</h3><pre id=worktodo></pre>
<input id=entry size=60 placeholder="PRP=1,2,9941,-1">
<button onclick="append()">append</button></div>
<script>
async function tick(){
 for (const k of ['state','results']) {
  const r = await fetch('/api/'+k);
  document.getElementById(k).textContent = await r.text();
 }
 const w = await fetch('/api/load-worktodo');
 document.getElementById('worktodo').textContent = await w.text();
}
async function append(){
 await fetch('/api/append-worktodo', {method:'POST',
   body: document.getElementById('entry').value});
 tick();
}
tick(); setInterval(tick, 2000);
</script></body></html>"""


class WebGui:
    def __init__(self, opts):
        self.opts = opts
        self.state = {"status": "idle", "exponent": opts.exponent,
                      "mode": opts.mode, "progress": 0.0, "iters": 0,
                      "ips": 0.0, "res64": "", "backend": opts.backend,
                      "transform_size": 0}
        self._server = None
        self._thread = None
        self.stop_requested = False

    def set_state(self, **kw):
        self.state.update(kw)

    def set_backend_info(self, backend: str, transform_size: int,
                         reason: str = ""):
        """Backend-decision telemetry (reference setBackendInfo,
        src/core/App.cpp:900-920)."""
        self.state.update(backend=backend, transform_size=transform_size,
                          backend_reason=reason)

    def start(self):
        gui = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _send(self, body: str, ctype="application/json", code=200):
                data = body.encode()
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                if self.path == "/" or self.path.startswith("/index"):
                    self._send(_PAGE, "text/html")
                elif self.path == "/api/state":
                    self._send(json.dumps(gui.state, indent=1))
                elif self.path == "/api/results":
                    try:
                        with open(gui.opts.results_path) as f:
                            self._send(f.read(), "text/plain")
                    except OSError:
                        self._send("", "text/plain")
                elif self.path == "/api/load-worktodo":
                    try:
                        with open(gui.opts.worktodo_path) as f:
                            self._send(f.read(), "text/plain")
                    except OSError:
                        self._send("", "text/plain")
                elif self.path == "/api/load-settings":
                    try:
                        with open("settings.cfg") as f:
                            self._send(f.read(), "text/plain")
                    except OSError:
                        self._send("", "text/plain")
                else:
                    self._send("not found", "text/plain", 404)

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(n).decode() if n else ""
                if self.path == "/api/append-worktodo":
                    with open(gui.opts.worktodo_path, "a") as f:
                        f.write(body.strip() + "\n")
                    self._send('{"ok":true}')
                elif self.path == "/api/save-settings":
                    with open("settings.cfg", "w") as f:
                        f.write(body)
                    self._send('{"ok":true}')
                elif self.path == "/api/stop":
                    gui.stop_requested = True
                    self._send('{"ok":true}')
                else:
                    self._send("not found", "text/plain", 404)

        host = getattr(self.opts, "gui_host", "") or "127.0.0.1"
        self._server = ThreadingHTTPServer((host, self.opts.gui_port),
                                           Handler)
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self._thread.start()

    def stop(self):
        if self._server:
            self._server.shutdown()
            self._server = None
