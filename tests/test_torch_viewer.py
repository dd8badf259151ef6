"""The port's live viewer (utils/viewer.py) and the render CLI's --serve,
on the CPU: the page, the frame and the stream, the control messages and
their checks (what the reference's viewer queued unchecked never reaches
the render loop here), and a control posted during a run moving the
camera as `models/camera.orbit` does and restarting the accumulation."""

import http.client
import json
import math
import re

import numpy as np
import pytest
import torch

from pathtracer_tpu_torch.app import render as cli
from pathtracer_tpu_torch.integrator.tracer import accumulate
from pathtracer_tpu_torch.models import camera
from pathtracer_tpu_torch.models.families import make_family_scene
from pathtracer_tpu_torch.ops import rng
from pathtracer_tpu_torch.ops.megakernel import render_frame_megakernel
from pathtracer_tpu_torch.utils import buffer, image
from pathtracer_tpu_torch.utils.viewer import MAX_BODY, MAX_QUEUE, LiveViewer, valid_control
from test_torch_kernel_host import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

VALID = [{"orbit": [3, -2]}, {"orbit": [0.5, 1e3]}, {"zoom": 0.9}, {"zoom": 4}, {"fov": -5}, {"reset": True}]
# bodies the endpoint answers 400, and why
MALFORMED = {
    "zoom not a number": b'{"zoom": "x"}',
    "orbit of one number": b'{"orbit": [1]}',
    "orbit of three numbers": b'{"orbit": [1, 2, 3]}',
    "not a dict": b"[1, 2]",
    "NaN": b'{"fov": NaN}',
    "infinite": b'{"orbit": [Infinity, 0]}',
    "past float's range": b'{"zoom": 1' + b"0" * 400 + b"}",
    "zoom not positive": b'{"zoom": 0}',
    "a bool as a number": b'{"zoom": true}',
    "reset not true": b'{"reset": false}',
    "two messages in one": b'{"zoom": 2, "fov": 1}',
    "unknown": b'{"pan": [1, 2]}',
    "empty dict": b"{}",
    "not JSON": b"not json",
    "empty body": b"",
    "not UTF-8": b'{"zoom": "\xff"}',
}


@pytest.fixture
def viewer():
    v = LiveViewer(port=0, host="127.0.0.1")
    yield v
    v.close()


def request(v, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", v.port, timeout=10)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def post(v, body: bytes) -> int:
    return request(v, "POST", "/control", body)[0]


def decode_png(data: bytes, tmp_path) -> np.ndarray:
    (tmp_path / "f.png").write_bytes(data)
    return image.read_png(str(tmp_path / "f.png"))


def test_viewer_serves_the_page_and_the_frame(viewer, tmp_path):
    status, page = request(viewer, "GET", "/")
    assert status == 200 and b"/stream" in page and b"/control" in page
    assert request(viewer, "GET", "/frame.png")[0] == 503  # no frame yet
    px = torch.from_numpy(np.random.default_rng(3).uniform(-0.1, 1.4, (6, 10, 4)))  # float64, as an f64 render
    viewer.update(px)
    status, png = request(viewer, "GET", "/frame.png")
    assert status == 200
    np.testing.assert_array_equal(decode_png(png, tmp_path), buffer.to_u8(px.to(torch.float32)))


def test_viewer_streams_each_frame(viewer, tmp_path):
    px = np.zeros((4, 8, 4), np.float32)
    px[..., 1], px[..., 3] = 0.5, 1.0
    viewer.update(px)
    conn = http.client.HTTPConnection("127.0.0.1", viewer.port, timeout=10)
    try:
        conn.request("GET", "/stream")
        resp = conn.getresponse()
        assert resp.status == 200 and resp.getheader("Content-Type").startswith("multipart/x-mixed-replace")
        assert resp.readline() == b"--frame\r\n" and resp.readline() == b"Content-Type: image/png\r\n"
        n = int(re.match(rb"Content-Length: (\d+)", resp.readline()).group(1))
        assert resp.readline() == b"\r\n"
        np.testing.assert_array_equal(decode_png(resp.read(n), tmp_path), buffer.to_u8(px))
    finally:
        conn.close()


def test_valid_controls_round_trip(viewer):
    for msg in VALID:
        assert post(viewer, json.dumps(msg).encode()) == 204
    assert viewer.pop_controls() == VALID
    assert viewer.pop_controls() == []


@pytest.mark.parametrize("why", sorted(MALFORMED))
def test_malformed_controls_are_refused(viewer, why):
    assert post(viewer, MALFORMED[why]) == 400
    assert viewer.pop_controls() == []


def test_oversized_and_unsized_bodies_are_refused(viewer):
    body = json.dumps({"orbit": [1, 2], "pad": "x" * 5200}).encode()
    assert len(body) > 5 * 1024 > MAX_BODY
    assert post(viewer, body) == 413
    for length in ("abc", "-1", "+5", "5x", "0x10"):
        assert request(viewer, "POST", "/control", b"", {"Content-Length": length})[0] == 400
    conn = http.client.HTTPConnection("127.0.0.1", viewer.port, timeout=10)
    try:  # no Content-Length at all
        conn.putrequest("POST", "/control")
        conn.endheaders()
        assert conn.getresponse().status == 400
    finally:
        conn.close()
    assert request(viewer, "POST", "/elsewhere", b"{}")[0] == 404
    assert viewer.pop_controls() == []


def test_control_queue_keeps_the_newest(viewer):
    for i in range(MAX_QUEUE + 44):
        assert post(viewer, json.dumps({"fov": i}).encode()) == 204
    assert viewer.pop_controls() == [{"fov": i} for i in range(44, MAX_QUEUE + 44)]


def test_valid_control_edges():
    assert valid_control({"orbit": [-1e300, 2.5]}) and valid_control({"zoom": 1e-300})
    assert not valid_control({"orbit": (1, 2)}) and not valid_control({"zoom": -1.0})
    assert not valid_control({"fov": math.inf}) and not valid_control({"orbit": [1, None]})
    assert not valid_control({"reset": 1}) and not valid_control(None)
    for why in ("zoom not a number", "orbit of one number", "not a dict", "NaN", "past float's range"):
        assert not valid_control(json.loads(MALFORMED[why])), why


def test_cli_serve_moves_the_camera_and_restarts(tmp_path):
    """A drag posted after frame 1 is drained after frame 2: the camera
    orbits as camera.orbit does, the accumulation starts again, and frame 3
    is rendered from the new view; a malformed control changes nothing."""
    port, replies = [], []

    def log(line):
        if line.startswith("live view: "):
            port.append(int(re.search(r":(\d+)/$", line).group(1)))
        if line.startswith("frame 1/"):
            for body in (b'{"orbit": [40, -25]}', b'{"zoom": "x"}', b"x" * 5000):
                conn = http.client.HTTPConnection("127.0.0.1", port[0], timeout=10)
                conn.request("POST", "/control", body=body)
                replies.append(conn.getresponse().status)
                conn.close()

    cfg, _ = cli.parse_args(["--device", "cpu", "--width", "12", "--height", "8", "--depth", "2", "--frames", "3",
                             "--serve", "0"])
    got = cli.render(cfg, str(tmp_path / "a.png"), log=log)
    assert replies == [204, 400, 413]
    scene = make_family_scene("analytical", recursion_depth=2)
    cam = camera.orbit(scene.camera.unpack(), -0.005 * 40, 0.005 * -25)
    key = rng.prng_key(0)
    for _ in range(3):
        key, sub = rng.split(key)
    frame = render_frame_megakernel(scene.replace(camera=cam), sub, 12, 8)
    want = accumulate(torch.zeros_like(frame), frame, torch.zeros(()))
    assert float(got.frames) == 1.0 and torch.equal(got.pixels, want[0])
    unmoved = render_frame_megakernel(scene, sub, 12, 8)
    assert not torch.equal(got.pixels, unmoved)


def test_apply_controls_resets_to_home():
    home = camera.default_pinhole()
    cam = cli.apply_controls(home, [{"orbit": [10, 5]}, {"zoom": 2.0}, {"fov": 5}], home)
    assert float(cam.fov) == 85.0 and not torch.equal(cam.origin.x, home.origin.x)
    assert cli.apply_controls(cam, [{"reset": True}], home) is home
