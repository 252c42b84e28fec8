"""Web interface for browsing the store (reference: jepsen.web, web.clj).

Routes (web.clj:328-334):
    /                       test table: name / time / validity, color-coded
                            (web.clj:122-134), newest first
    /files/<path>           directory browser + file view under the store
                            root, with path traversal confined to the
                            store (web.clj:279-326)
    /files/<run-dir>.zip    zip download of one run dir (web.clj:256-277)

Implementation is the standard library's threading HTTP server — no
framework dependency (the reference uses http-kit + ring + hiccup).

The port's copy of `jepsen_tpu/web.py`, on the port's `store.py`: over
one store its pages, files and zips have the JAX package's bytes.
`serve_until_signal` also keeps the verdict daemon (`serve --daemon`)
up until a signal.
"""

from __future__ import annotations

import html
import io
import json
import logging
import os
import threading
import zipfile
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import quote, unquote

from . import store

log = logging.getLogger("jepsen_tpu_torch.web")

_CSS = """
body { font-family: sans-serif; margin: 2em; }
table { border-collapse: collapse; }
td, th { padding: 0.3em 1em; border-bottom: 1px solid #ddd; text-align: left; }
.valid-true { background: #cfc; }
.valid-false { background: #fcc; }
.valid-unknown { background: #ffc; }
a { text-decoration: none; }
"""


def _run_validity(run_dir: str):
    """Peek at a run's results.json for its validity (web.clj:48-69 reads
    the stored test; we only need valid)."""
    p = os.path.join(run_dir, "results.json")
    try:
        with open(p) as f:
            return json.load(f).get("valid")
    except (OSError, ValueError):
        return None


def _test_rows(root: str) -> list[dict]:
    rows = []
    for name, runs in store.tests(store_dir=root).items():
        for t, d in runs.items():
            rows.append(
                {
                    "name": name,
                    "time": t,
                    "dir": d,
                    "valid": _run_validity(d),
                }
            )
    rows.sort(key=lambda r: r["time"], reverse=True)
    return rows


def _page(title: str, body: str) -> bytes:
    return (
        f"<!doctype html><html><head><title>{html.escape(title)}</title>"
        f"<style>{_CSS}</style></head><body>{body}</body></html>"
    ).encode()


def _home_html(root: str) -> bytes:
    rows = []
    for r in _test_rows(root):
        v = r["valid"]
        cls = {True: "valid-true", False: "valid-false"}.get(v, "valid-unknown")
        vtxt = {True: "valid", False: "invalid", None: "?"}.get(v, str(v))
        rel = f"{r['name']}/{r['time']}"
        rows.append(
            f'<tr class="{cls}">'
            f'<td><a href="/files/{quote(rel)}/">{html.escape(r["name"])}</a></td>'
            f'<td><a href="/files/{quote(rel)}/">{html.escape(r["time"])}</a></td>'
            f"<td>{html.escape(vtxt)}</td>"
            f'<td><a href="/files/{quote(rel)}.zip">zip</a></td></tr>'
        )
    body = (
        "<h1>Jepsen-TPU</h1><table><tr><th>Test</th><th>Time</th>"
        "<th>Valid?</th><th></th></tr>" + "".join(rows) + "</table>"
    )
    return _page("Jepsen-TPU", body)


def _dir_html(root: str, rel: str, full: str) -> bytes:
    entries = sorted(os.listdir(full))
    items = ['<li><a href="../">..</a></li>']
    for e in entries:
        suffix = "/" if os.path.isdir(os.path.join(full, e)) else ""
        items.append(
            f'<li><a href="{quote(e)}{suffix}">{html.escape(e)}{suffix}</a></li>'
        )
    body = f"<h1>/{html.escape(rel)}</h1><ul>{''.join(items)}</ul>"
    return _page(rel or "store", body)


def _zip_bytes(full: str) -> bytes:
    """Zip an entire run directory in memory (web.clj:256-277 streams;
    run dirs are small — text, json, plots)."""
    buf = io.BytesIO()
    base = os.path.basename(full.rstrip("/"))
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as z:
        for dirpath, _dirs, files in os.walk(full):
            for f in files:
                p = os.path.join(dirpath, f)
                z.write(p, os.path.join(base, os.path.relpath(p, full)))
    return buf.getvalue()


_CONTENT_TYPES = {
    ".txt": "text/plain; charset=utf-8",
    ".log": "text/plain; charset=utf-8",
    ".json": "application/json",
    ".jsonl": "text/plain; charset=utf-8",
    ".html": "text/html; charset=utf-8",
    ".svg": "image/svg+xml",
    ".png": "image/png",
    ".zip": "application/zip",
}


class _Handler(BaseHTTPRequestHandler):
    store_root = store.BASE_DIR

    def log_message(self, fmt, *args):  # route to logging, not stderr
        log.debug("%s %s", self.address_string(), fmt % args)

    def _send(self, code: int, body: bytes, ctype="text/html; charset=utf-8"):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802
        try:
            self._route()
        except BrokenPipeError:
            pass
        except Exception:  # noqa: BLE001
            log.exception("error serving %s", self.path)
            self._send(500, b"internal error", "text/plain")

    def _route(self):
        root = os.path.abspath(self.store_root)
        path = unquote(self.path.split("?", 1)[0])
        if path in ("", "/"):
            return self._send(200, _home_html(root))
        if not path.startswith("/files/"):
            return self._send(404, b"not found", "text/plain")
        rel = path[len("/files/"):]
        want_zip = rel.endswith(".zip")
        if want_zip:
            rel = rel[:-4]
        # Confine to the store root (web.clj:279-310's scope check).
        # realpath, not abspath: a symlink inside the store pointing out
        # of it must not escape. The store's own latest/current links
        # also resolve within the root, so they still browse fine.
        root = os.path.realpath(root)
        full = os.path.realpath(os.path.join(root, rel))
        if not (full == root or full.startswith(root + os.sep)):
            return self._send(403, b"forbidden", "text/plain")
        if not os.path.exists(full):
            return self._send(404, b"not found", "text/plain")
        if want_zip:
            # Only single run dirs zip (store/<name>/<time>); zipping the
            # whole store into memory is an easy OOM.
            depth = len(os.path.relpath(full, root).split(os.sep))
            if not os.path.isdir(full) or depth != 2:
                return self._send(404, b"only run directories zip", "text/plain")
            return self._send(200, _zip_bytes(full), "application/zip")
        if os.path.isdir(full):
            return self._send(200, _dir_html(root, rel.rstrip("/"), full))
        ext = os.path.splitext(full)[1].lower()
        ctype = _CONTENT_TYPES.get(ext, "application/octet-stream")
        with open(full, "rb") as f:
            return self._send(200, f.read(), ctype)


def serve(host="0.0.0.0", port=8080, store_dir=None) -> ThreadingHTTPServer:
    """Start the server in a daemon thread; returns the server (bound
    port at .server_port) — web.clj:336-341."""
    handler = type(
        "Handler",
        (_Handler,),
        {"store_root": store_dir or store.BASE_DIR},
    )
    server = ThreadingHTTPServer((host, port), handler)
    t = threading.Thread(target=server.serve_forever, daemon=True, name="web")
    t.start()
    return server


def serve_until_signal(server, on_drain=None, what="web UI",
                       poll_s: float = 1.0) -> int:
    """Block until ctrl-C or SIGTERM, then shut `server` down cleanly.

    Returns the exit status the CLI should use: 0 for a ctrl-C, 143
    (128+SIGTERM) for a terminate — the conventional status container
    runtimes and TPU preemption agents expect, matching core.run's
    drain discipline. The first SIGTERM runs `on_drain` (when given)
    and stops the serve loop; a second SIGTERM force-exits through
    DrainSignal's SystemExit(143) path. The CLI imports `core` before
    it binds the socket (the first import loads torch, and a SIGTERM in
    those seconds would meet the default disposition)."""
    from .core import DrainSignal

    stop = threading.Event()

    def drain() -> bool:
        if on_drain is not None:
            try:
                on_drain()
            except Exception:  # noqa: BLE001 — drain is best-effort
                log.warning("drain hook failed", exc_info=True)
        stop.set()
        return True

    sig = DrainSignal(drain, what=what).install()
    code = 0
    try:
        while not stop.is_set():
            stop.wait(poll_s)
    except KeyboardInterrupt:
        pass
    finally:
        sig.uninstall()
        server.shutdown()
    if sig.draining.is_set():
        code = 143
    return code
