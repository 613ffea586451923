"""Live browser viewer: an in-process HTTP server streaming the current
reconstruction to any browser on the network — the headless-friendly,
Open3D-free equivalent of the reference's live ``VisualizerWithKeyCallback``
window (/root/reference/CreateMesh.py:394-502, key loop :463-502).

Design (device-host-friendly: zero per-frame cost unless someone is watching):

- The reconstruction loop calls ``update_mesh``/``update_cloud`` exactly like
  it does on the Open3D bridge viewer; each update packs the geometry ONCE
  into an immutable binary snapshot under a lock (requests never touch live
  numpy buffers).
- Browsers poll ``/meta.json`` (~4 Hz); when an object's revision changes
  they fetch ``/geometry.bin?name=...`` and re-upload the GL buffers — the
  page is the shared renderer from viz/webgl_core.py.
- The reference's reconstruction KEY MAP works through the browser: the
  page forwards registered keys (S save, C reset, M mesh mode, =/-/[/]
  depth tuning...) to ``/key``; the host drains them on its own thread at
  ``tick()``, exactly like the Open3D key-callback dispatch
  (viz/o3d_bridge.LiveViewer.register_key).

Geometry wire format (/geometry.bin, all little-endian):
  u32 header[8]: magic 0x4B33444C ('K3DL'), version 1, rev, mode
                 (0 points, 1 indexed mesh, 2 triangle soup), n_vertices,
                 n_indices, flags (1 colors, 2 normals), reserved
  f32 center[3], f32 radius
  f32 pos[3*V]; u8 col[3*V] zero-padded to 4 bytes; f32 nrm[3*V] if flagged;
  u32 idx[n_indices] if mode 1
"""

from __future__ import annotations

import json
import queue
import struct
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional, Tuple, Union
from urllib.parse import parse_qs, urlparse

import numpy as np

from azurekinect3dreconstruction_tpu.core.types import (
    PointCloudHost,
    TriangleMeshHost,
)
from azurekinect3dreconstruction_tpu.utils.telemetry import log_info
from azurekinect3dreconstruction_tpu.viz.webgl_core import CORE_JS, PAGE_CSS

MAGIC = 0x4B33444C

_LIVE_PAGE = """<!DOCTYPE html>
<html>
<head>
<meta charset="utf-8">
<title>__TITLE__</title>
<style>__CSS__</style>
</head>
<body>
<canvas id="c"></canvas>
<div id="hud"></div>
<script>__CORE__</script>
<script>
"use strict";
const viewer = makeViewer(document.getElementById("c"),
                          document.getElementById("hud"), "__TITLE__");
const known = new Map();   // name -> rev already uploaded
// makeViewer returns null when WebGL is unavailable (html_export guards the
// same way); without the guard the TypeError below would kill the script
// before the poll loop / __polls liveness hook ever start
if (viewer) {
viewer.onHostKey = k => { fetch("/key?c=" + encodeURIComponent(k)); };
async function pull(name) {
  const r = await fetch("/geometry.bin?name=" + encodeURIComponent(name));
  const buf = await r.arrayBuffer();
  const h = new Uint32Array(buf, 0, 8);
  if (h[0] !== 0x4B33444C) return;
  const [,, rev, mode, nv, ni, flags] = h;
  const cr = new Float32Array(buf, 32, 4);
  let off = 48;
  const pos = new Float32Array(buf, off, 3 * nv); off += 12 * nv;
  let col = null, nrm = null, idx = null;
  if (flags & 1) { col = new Uint8Array(buf, off, 3 * nv);
                   off += (3 * nv + 3) & ~3; }
  if (flags & 2) { nrm = new Float32Array(buf, off, 3 * nv); off += 12 * nv; }
  if (mode === 1 && ni) idx = new Uint32Array(buf, off, ni);
  viewer.setGeometry(name, { mode: mode, n_vertices: nv, n_indices: ni,
                             center: [cr[0], cr[1], cr[2]], radius: cr[3] },
                     pos, col, nrm, idx);
  known.set(name, rev);
}
async function poll() {
  try {
    const meta = await (await fetch("/meta.json")).json();
    viewer.localKeys = new Set(Object.keys(meta.keys || {}));
    viewer.setStatus(meta.status || "");
    for (const [name, o] of Object.entries(meta.objects || {}))
      if (known.get(name) !== o.rev) await pull(name);
    for (const name of known.keys())
      if (!(name in (meta.objects || {}))) {
        viewer.removeGeometry(name); known.delete(name);
      }
    window.__polls = (window.__polls || 0) + 1;   // test hook
  } catch (e) { /* host restarting; keep polling */ }
  setTimeout(poll, 250);
}
poll();
}
</script>
</body>
</html>
"""


def pack_geometry(geometry: Union[TriangleMeshHost, PointCloudHost],
                  rev: int, max_vertices: int = 2_000_000) -> bytes:
    """Pack one geometry into the /geometry.bin wire format (docstring
    above). Triangle soups (meshes whose triangles are just
    arange(3V).reshape(-1, 3) — what the incremental extractor emits) are
    detected and sent WITHOUT the index buffer (mode 2): the indices carry
    no information and would add 12 bytes/triangle on the wire."""
    from azurekinect3dreconstruction_tpu.viz.html_export import (
        bounds_meta,
        colors_u8,
        geometry_arrays,
        soup_arrays,
    )

    # soup detection + whole-triangle striding shared with the .html
    # exporter (ONE definition — see html_export.soup_arrays)
    soup = soup_arrays(geometry, max_vertices)
    if soup is not None:
        verts, colors = soup
        tris, normals, mode = None, None, 2
    else:
        verts, tris, colors, normals = geometry_arrays(geometry, max_vertices)
        if tris is not None and tris.size:
            mode = 1
        else:
            mode, tris = 0, None
    col = colors_u8(colors)
    center, radius = bounds_meta(verts)

    nv = int(verts.shape[0])
    ni = int(tris.size) if tris is not None else 0
    flags = (1 if col is not None else 0) | (2 if normals is not None else 0)
    parts = [struct.pack("<8I", MAGIC, 1, rev, mode, nv, ni, flags, 0),
             struct.pack("<4f", *center, radius),
             np.ascontiguousarray(verts, np.float32).tobytes()]
    if col is not None:
        b = np.ascontiguousarray(col).tobytes()
        parts.append(b + b"\0" * (-len(b) % 4))
    if normals is not None:
        parts.append(np.ascontiguousarray(normals, np.float32).tobytes())
    if tris is not None:
        parts.append(np.ascontiguousarray(tris, np.uint32).tobytes())
    return b"".join(parts)


class LiveViewerServer:
    """HTTP server holding immutable geometry snapshots; thread-safe."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 title: str = "Live reconstruction",
                 max_vertices: int = 2_000_000):
        self.title = title
        self.max_vertices = max_vertices
        self._lock = threading.Lock()
        self._snaps: Dict[str, Tuple[int, bytes, int, int]] = {}
        self._geoms: Dict[str, Union[TriangleMeshHost, PointCloudHost]] = {}
        self._rev = 0
        self._status = ""
        self._keys: Dict[str, str] = {}  # key -> description (for the HUD)
        self.key_events: "queue.Queue[str]" = queue.Queue()
        page = (_LIVE_PAGE.replace("__CSS__", PAGE_CSS)
                .replace("__CORE__", CORE_JS)
                .replace("__TITLE__", title).encode())
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet: the live loop owns stdout
                pass

            def _send(self, code: int, ctype: str, body: bytes):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                u = urlparse(self.path)
                if u.path in ("/", "/index.html"):
                    return self._send(200, "text/html; charset=utf-8", page)
                if u.path == "/meta.json":
                    with server._lock:
                        objs = {n: {"rev": r, "n_vertices": nv,
                                    "n_indices": ni}
                                for n, (r, _, nv, ni) in server._snaps.items()}
                        body = json.dumps({
                            "title": server.title, "rev": server._rev,
                            "objects": objs, "status": server._status,
                            "keys": server._keys,
                        }).encode()
                    return self._send(200, "application/json", body)
                if u.path == "/geometry.bin":
                    name = parse_qs(u.query).get("name", [""])[0]
                    with server._lock:
                        snap = server._snaps.get(name)
                    if snap is None:
                        return self._send(404, "text/plain", b"no such object")
                    return self._send(200, "application/octet-stream", snap[1])
                if u.path == "/snapshot.ply":
                    # download the current geometry as a binary PLY — the
                    # reference repo carried an abandoned web-API intent
                    # (empty FastAPI/fastapi placeholder, flask/dash deps in
                    # its pyproject.toml:22-24); this realizes it
                    name = parse_qs(u.query).get("name", [""])[0]
                    with server._lock:
                        geom = server._geoms.get(name)
                    if geom is None:
                        return self._send(404, "text/plain", b"no such object")
                    import tempfile

                    from azurekinect3dreconstruction_tpu.viz.savers import (
                        write_ply_mesh,
                        write_ply_point_cloud,
                    )

                    with tempfile.TemporaryDirectory() as td:
                        p = td + "/snap.ply"
                        if isinstance(geom, TriangleMeshHost):
                            write_ply_mesh(p, geom)
                        else:
                            write_ply_point_cloud(p, geom)
                        with open(p, "rb") as f:
                            body = f.read()
                    return self._send(200, "application/octet-stream", body)
                if u.path == "/key":
                    c = parse_qs(u.query).get("c", [""])[0]
                    if c:
                        server.key_events.put(c)
                    return self._send(200, "text/plain", b"ok")
                return self._send(404, "text/plain", b"not found")

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.host, self.port = self._httpd.server_address[:2]
        self.url = f"http://{self.host}:{self.port}/"
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="live-viewer-http", daemon=True)
        self._thread.start()

    def update(self, name: str,
               geometry: Union[TriangleMeshHost, PointCloudHost]) -> None:
        with self._lock:
            self._rev += 1
            rev = self._rev
        blob = pack_geometry(geometry, rev, self.max_vertices)
        nv, ni = struct.unpack_from("<2I", blob, 16)
        with self._lock:
            self._snaps[name] = (rev, blob, nv, ni)
            self._geoms[name] = geometry  # /snapshot.ply source

    def remove(self, name: str) -> None:
        with self._lock:
            self._snaps.pop(name, None)
            self._geoms.pop(name, None)
            self._rev += 1

    def set_status(self, text: str) -> None:
        with self._lock:
            self._status = text

    def set_keys(self, keys: Dict[str, str]) -> None:
        with self._lock:
            self._keys = dict(keys)

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=2.0)


class BrowserLiveViewer:
    """Drop-in live viewer with the o3d_bridge.LiveViewer protocol, rendered
    in a browser instead of an Open3D window. ``register_key`` handlers run
    on the reconstruction thread when ``tick()`` drains keys the page
    forwarded — same dispatch model as the GLFW key callbacks."""

    headless = False  # live loops should feed it geometry

    def __init__(self, port: int = 0, host: str = "127.0.0.1",
                 window_name: str = "kinect-recon",
                 max_vertices: int = 2_000_000):
        self.server = LiveViewerServer(host=host, port=port,
                                       title=window_name,
                                       max_vertices=max_vertices)
        self._handlers: Dict[str, Callable[[], None]] = {}
        self._descs: Dict[str, str] = {}
        self._open = True
        log_info(f"live viewer serving at {self.server.url}")

    def register_key(self, char: str, fn: Callable[[], None],
                     desc: str = "") -> None:
        self._handlers[char.lower()] = fn
        self._descs[char.lower()] = desc
        self.server.set_keys(self._descs)

    def press(self, char: str) -> None:
        fn = self._handlers.get(char.lower())
        if fn:
            fn()

    def update_cloud(self, name: str, cloud: PointCloudHost) -> None:
        self.server.update(name, cloud)

    def update_mesh(self, name: str, mesh: TriangleMeshHost) -> None:
        self.server.update(name, mesh)

    def remove(self, name: str) -> None:
        self.server.remove(name)

    def set_status(self, text: str) -> None:
        self.server.set_status(text)

    def reset_view(self) -> None:
        pass  # view state lives in each browser

    def tick(self) -> bool:
        while True:
            try:
                c = self.server.key_events.get_nowait()
            except queue.Empty:
                break
            self.press(c)
        return self._open

    def close(self) -> None:
        if self._open:
            self._open = False
            self.server.close()
