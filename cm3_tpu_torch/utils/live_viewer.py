"""Live episode viewer: a dependency-free HTTP surface over the
animated-SVG render stream (``cm3_tpu.utils.live_viewer``).

The reference's viewer is a pyglet/OpenGL window redrawn every env step
(``env/multiagent-particle-envs/multiagent/rendering.py:1-345``, wired
through ``MultiAgentEnv.render``).  A headless GPU host has no display:
the port renders greedy episodes to animated SVG
(``cm3_tpu_torch/envs/render.py``, ``runner.py --render-episodes``) and
this module serves them LIVE: point it at a render root while training
(or a render run) writes SVGs into it, open the page in any browser,
and the newest episodes appear as they land, animations playing via
SMIL; no pyglet, no GL, stdlib ``http.server`` only.

    python -m cm3_tpu_torch.utils.live_viewer --root WORKDIR/render \
        [--port 8763] [--refresh 5] [--latest 8]

Endpoints:
  /        auto-refreshing page embedding the newest ``--latest`` SVGs
  /list    JSON [{"path", "mtime", "size"}, ...] newest-first (for
           polling UIs / tests)
  /<rel>   the SVG files themselves (path-checked to stay under root:
           the root and the requested file are both resolved with
           ``os.path.realpath``, so neither ``..`` nor a symlink leads
           out of it)
"""

from __future__ import annotations

import argparse
import html
import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

_STYLE = """
body { font-family: system-ui, sans-serif; margin: 1.5em; background: #111;
       color: #eee; }
h1 { font-size: 1.2em; } .meta { color: #999; font-size: .85em; }
.ep { display: inline-block; margin: .5em; vertical-align: top;
      background: #1c1c1c; border: 1px solid #333; border-radius: 6px;
      padding: .5em; }
.ep figcaption { font-size: .8em; color: #aaa; text-align: center;
                 margin-top: .3em; }
object { max-width: 440px; background: #fff; border-radius: 4px; }
"""


def _inside(root: str, path: str) -> bool:
    """Whether ``path`` resolves (symlinks followed) to a file under the
    resolved ``root``."""
    return os.path.realpath(path).startswith(
        os.path.realpath(root) + os.sep)


def _scan(root: str):
    """All SVGs under root, newest-first: [(relpath, mtime, size)]."""
    out = []
    for dirpath, _dirs, files in os.walk(root):
        for f in files:
            if not f.endswith(".svg"):
                continue
            p = os.path.join(dirpath, f)
            if not _inside(root, p):
                continue  # a symlink out of the root
            try:
                st = os.stat(p)
            except OSError:
                continue  # racing a writer
            out.append((os.path.relpath(p, root), st.st_mtime, st.st_size))
    out.sort(key=lambda t: t[1], reverse=True)
    return out


def _page(root: str, refresh: int, latest: int) -> str:
    svgs = _scan(root)[:latest]
    parts = [
        "<!doctype html><html><head><meta charset='utf-8'>",
        f"<meta http-equiv='refresh' content='{int(refresh)}'>",
        f"<title>live — {html.escape(os.path.basename(root) or root)}"
        "</title>",
        f"<style>{_STYLE}</style></head><body>",
        f"<h1>Live episode viewer — {html.escape(root)}</h1>",
        f"<p class='meta'>newest {len(svgs)} episode(s); page refreshes "
        f"every {int(refresh)}s; animations play via SMIL "
        "(cm3_tpu_torch/envs/render.py — the headless counterpart of the "
        "reference's multiagent/rendering.py window).</p>"]
    if not svgs:
        parts.append("<p class='meta'>no episodes rendered yet — waiting "
                     "for SVGs under this root.</p>")
    for rel, mtime, _size in svgs:
        parts.append(
            f"<figure class='ep'>"
            # mtime in the query busts browser caches when a writer
            # overwrites an episode file in place
            f"<object type='image/svg+xml' "
            f"data='{html.escape(rel)}?t={int(mtime)}'></object>"
            f"<figcaption>{html.escape(rel)}</figcaption></figure>")
    parts.append("</body></html>")
    return "\n".join(parts)


def make_server(root: str, port: int = 0, refresh: int = 5,
                latest: int = 8) -> ThreadingHTTPServer:
    """Bind (not yet serving) a viewer for ``root``.  port=0 picks an
    ephemeral port (``server.server_address[1]`` after return)."""
    root = os.path.realpath(root)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *_a):  # quiet; this is a dev surface
            pass

        def _send(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            path = self.path.split("?", 1)[0]
            if path in ("/", "/index.html"):
                self._send(200, _page(root, refresh, latest).encode(),
                           "text/html; charset=utf-8")
                return
            if path == "/list":
                body = json.dumps([
                    {"path": rel, "mtime": mtime, "size": size}
                    for rel, mtime, size in _scan(root)]).encode()
                self._send(200, body, "application/json")
                return
            # static SVG: resolve under root only (no traversal, and no
            # symlink out of it: realpath resolves links)
            rel = os.path.normpath(path.lstrip("/"))
            full = os.path.realpath(os.path.join(root, rel))
            if (not _inside(root, full)
                    or not full.endswith(".svg")
                    or not os.path.isfile(full)):
                self._send(404, b"not found", "text/plain")
                return
            with open(full, "rb") as f:
                self._send(200, f.read(), "image/svg+xml")

    return ThreadingHTTPServer(("127.0.0.1", port), Handler)


def serve_background(root: str, port: int = 0, refresh: int = 5,
                     latest: int = 8):
    """Start the viewer in a daemon thread -> (server, port)."""
    srv = make_server(root, port, refresh, latest)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    return srv, srv.server_address[1]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default="render")
    ap.add_argument("--port", type=int, default=8763)
    ap.add_argument("--refresh", type=int, default=5)
    ap.add_argument("--latest", type=int, default=8)
    args = ap.parse_args()
    srv = make_server(args.root, args.port, args.refresh, args.latest)
    print(f"live viewer: http://127.0.0.1:{srv.server_address[1]}/ "
          f"(root={args.root})", flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
