"""Live progressive viewer over HTTP, with camera controls.

Port of `pathtracer_tpu/utils/viewer.py`. A threaded HTTP server: `/` is a
page that shows `/stream`, a multipart/x-mixed-replace PNG stream to which
every `LiveViewer.update(pixels)` pushes the accumulated buffer;
`/frame.png` is the latest frame. The page POSTs its drag, wheel and key
events to `/control` as JSON, and the render loop drains them once a frame
with `pop_controls()`, moves the camera and restarts the accumulation.

Unlike the reference, the endpoint checks what it takes before anything
reaches the render loop: a body over MAX_BODY bytes is answered 413 unread,
a missing or malformed Content-Length 400, and only these messages are
queued (anything else is 400): {"orbit": [dx, dy]} with two finite
numbers, {"zoom": f} with a finite f > 0, {"fov": d} with a finite d, and
{"reset": true}. The queue keeps the newest MAX_QUEUE messages.

PNGs are encoded by the native runtime (`utils/native`) where it loads,
by numpy otherwise.
"""

from __future__ import annotations

import collections
import json
import math
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .buffer import to_u8
from .image import as_float32, encode_png, native_runtime

MAX_BODY = 4096
MAX_QUEUE = 256

_PAGE = b"""<!doctype html>
<html><head><title>pathtracer_tpu_torch live render</title>
<style>body{background:#111;margin:0;display:grid;place-items:center;
height:100vh}img{image-rendering:pixelated;max-width:96vw;max-height:96vh;
cursor:grab;user-select:none}</style></head>
<body><img id="v" src="/stream" alt="progressive render" draggable="false">
<script>
const img = document.getElementById("v");
let drag = false, lx = 0, ly = 0;
const post = (msg) => fetch("/control", {
  method: "POST", body: JSON.stringify(msg)});
img.addEventListener("mousedown", (e) => {
  drag = true; lx = e.clientX; ly = e.clientY; e.preventDefault();});
window.addEventListener("mouseup", () => { drag = false; });
window.addEventListener("mousemove", (e) => {
  if (!drag) return;
  const dx = e.clientX - lx, dy = e.clientY - ly;
  lx = e.clientX; ly = e.clientY;
  if (dx || dy) post({orbit: [dx, dy]});});
img.addEventListener("wheel", (e) => {
  e.preventDefault(); post({zoom: Math.exp(e.deltaY * 0.001)});},
  {passive: false});
window.addEventListener("keydown", (e) => {
  if (e.key === "r") post({reset: true});
  if (e.key === "+" || e.key === "=") post({fov: -5});
  if (e.key === "-") post({fov: 5});});
</script></body></html>
"""


def _finite(x) -> bool:
    if isinstance(x, bool) or not isinstance(x, (int, float)):
        return False
    try:
        return math.isfinite(x)
    except OverflowError:  # an int past float's range
        return False


def valid_control(msg) -> bool:
    """Whether `msg` is one of the four control messages."""
    if not isinstance(msg, dict) or len(msg) != 1:
        return False
    ((name, val),) = msg.items()
    if name == "orbit":
        return isinstance(val, list) and len(val) == 2 and all(_finite(x) for x in val)
    if name == "zoom":
        return _finite(val) and val > 0
    if name == "fov":
        return _finite(val)
    return name == "reset" and val is True


def encode_frame(pixels) -> bytes:
    """PNG of a linear [H, W, 4] buffer (a tensor on any device, or an
    array), gamma-encoded."""
    arr = as_float32(pixels)
    native, _ = native_runtime()
    if native is not None:
        return native.tonemap_encode_png(arr, gamma=True)
    return encode_png(to_u8(arr))


class LiveViewer:
    """Threaded progressive-render viewer; call update() once per frame."""

    def __init__(self, port: int = 8000, host: str = "0.0.0.0"):
        self._lock = threading.Condition()
        self._png: bytes | None = None
        self._seq = 0
        self._closed = False
        self._controls: collections.deque = collections.deque(maxlen=MAX_QUEUE)
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            timeout = 30  # seconds a connection may stall (a body shorter than its length)

            def log_message(self, *a):  # no line on stderr per request
                pass

            def reply(self, code: int, body: bytes = b"", ctype: str | None = None):
                self.send_response(code)
                if ctype:
                    self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                if body:
                    self.wfile.write(body)

            def do_POST(self):
                if self.path != "/control":
                    return self.reply(404)
                length = self.headers.get("Content-Length", "")
                if not (length.isascii() and length.isdigit()):
                    self.close_connection = True
                    return self.reply(400)
                if int(length) > MAX_BODY:
                    self.close_connection = True  # the body stays unread
                    return self.reply(413)
                try:
                    msg = json.loads(self.rfile.read(int(length)))
                except (ValueError, RecursionError):
                    msg = None
                if not valid_control(msg):
                    return self.reply(400)
                with viewer._lock:
                    viewer._controls.append(msg)
                self.reply(204)

            def do_GET(self):
                if self.path == "/stream":
                    self.send_response(200)
                    self.send_header("Content-Type", "multipart/x-mixed-replace; boundary=frame")
                    self.end_headers()
                    seen = -1
                    try:
                        while not viewer._closed:
                            with viewer._lock:
                                viewer._lock.wait_for(lambda: viewer._closed or viewer._seq != seen, timeout=5.0)
                                png, seen = viewer._png, viewer._seq
                            if png is None:
                                continue
                            self.wfile.write(b"--frame\r\nContent-Type: image/png\r\n")
                            self.wfile.write(f"Content-Length: {len(png)}\r\n\r\n".encode())
                            self.wfile.write(png + b"\r\n")
                            self.wfile.flush()
                    except OSError:  # the viewer went away or stalled
                        pass
                elif self.path == "/frame.png":
                    with viewer._lock:
                        png = viewer._png
                    if png is None:
                        return self.reply(503)
                    self.reply(200, png, "image/png")
                else:
                    self.reply(200, _PAGE, "text/html")

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._server.daemon_threads = True
        self.port = self._server.server_address[1]
        # close() waits for the server's next poll
        self._thread = threading.Thread(target=self._server.serve_forever, kwargs=dict(poll_interval=0.05),
                                        daemon=True)
        self._thread.start()

    def update(self, pixels) -> None:
        """Publish the latest accumulated [H, W, 4] linear buffer."""
        png = encode_frame(pixels)
        with self._lock:
            self._png = png
            self._seq += 1
            self._lock.notify_all()

    def pop_controls(self) -> list:
        """The queued /control messages, oldest first, and empty the queue.
        Call once per frame from the render loop."""
        with self._lock:
            msgs = list(self._controls)
            self._controls.clear()
        return msgs

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._lock.notify_all()
        self._server.shutdown()
        self._server.server_close()


__all__ = ["LiveViewer", "valid_control", "MAX_BODY", "MAX_QUEUE"]
